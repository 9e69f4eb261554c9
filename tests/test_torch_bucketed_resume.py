"""Bucketed prefill's stream identities in the port, at fp32 on the CPU
(the ``micro`` preset, the JAX package's ``TINY`` of
``tests/test_serving_production.py``):

- greedy streams through bucketed prefill equal chunked prefill's at chunk
  4 and at a ragged 7, and ``generate``'s: the JAX package's
  chunked-vs-bucketed identity held inside the port;
- drain and resume on bucketed engines: a context that has outgrown every
  bucket is recomputed from its prompt alone, one that still fits is
  ingested in one padded program, and ``export_inflight`` records cross
  the packages both ways with the uninterrupted stream either way;
- with an ``obs`` handle, a bucketed engine records JAX's phase spans
  (queue, prefill, decode) with their attributes, and JAX's engine
  counters."""

import jax
import numpy as np
import pytest
import torch

from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task.obs import Obs as JaxObs
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.models.decoding import generate
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.obs import Obs
from torch_port_util import CPU, jax_model, port_model, share_jax_programs


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, port cfg, port params) of ``micro``."""
    jcfg, jparams = jax_model("micro")
    return (jcfg, jparams, *port_model(jcfg, jparams))


def test_chunked_prefill_matches_bucketed_greedy(model):
    _, _, cfg, params = model
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, 64, size=plen), new)
            for plen, new in [(5, 6), (13, 4), (16, 8), (3, 5)]]

    def run(**kw):
        scfg = ServingConfig(slots=3, block_size=4, n_blocks=64, max_len=32,
                             prefill_buckets=(8, 16), prefix_cache=False,
                             **kw)
        engine = ServingEngine(params, cfg, scfg, device=CPU)
        rids = [engine.submit(p, n) for p, n in reqs]
        out = engine.drain()
        return [list(out[r]) for r in rids], engine.stats()

    bucketed, stats = run(prefill="bucketed")
    assert (stats["prefills"], stats["chunk_steps"]) == (4, 0)
    assert bucketed == run(prefill="chunked", chunk_tokens=4)[0]
    assert bucketed == run(prefill="chunked", chunk_tokens=7)[0]   # ragged
    assert bucketed == [
        generate(params, cfg, torch.as_tensor(p)[None], n,
                 device=CPU)[0].tolist() for p, n in reqs]


#: The JAX test's bucketed engine: a 14-token prompt, buckets 8 and 16.
KNOBS = dict(slots=2, block_size=4, n_blocks=64, max_len=32,
             prefill="bucketed", prefill_buckets=(8, 16), prefix_cache=False)


def make(model, package, **over):
    jcfg, jparams, cfg, params = model
    knobs = {**KNOBS, **over}
    if package == "jax":
        return share_jax_programs(JaxServingEngine(
            jparams, jcfg, JaxServingConfig(**knobs, decode_impl="xla"),
            rng=jax.random.PRNGKey(9)))
    return ServingEngine(params, cfg, ServingConfig(**knobs),
                         rng=R.PRNGKey(9), device=CPU)


PROMPT = np.random.default_rng(31).integers(0, 64, size=14)
SAMPLED = dict(temperature=0.7, top_p=0.9)


@pytest.fixture(scope="module")
def reference(model):
    """The uninterrupted sampled stream, from both packages."""
    out = []
    for package in ("jax", "port"):
        engine = make(model, package)
        rid = engine.submit(PROMPT, 10, **SAMPLED)
        out.append(list(engine.drain()[rid]))
    assert out[0] == out[1]
    return out[0]


@pytest.mark.parametrize("steps,outgrown", [(5, True), (1, False)],
                         ids=["outgrown", "fits"])
@pytest.mark.parametrize("exporter,importer", [
    ("port", "port"), ("port", "jax"), ("jax", "port"), ("jax", "jax")])
def test_bucketed_resume(model, reference, exporter, importer, steps,
                         outgrown):
    """After 5 steps the context (14 + 3 or more tokens) has outgrown the
    16-token bucket and the importer recomputes from the prompt; after 1
    step it (14 + 2) still fits and the importer ingests it in one
    program. Either way the resumed stream is the uninterrupted one."""
    first = make(model, exporter)
    rid = first.submit(PROMPT, 10, **SAMPLED)
    for _ in range(steps):
        first.step()
    records = first.export_inflight()
    assert len(records) == 1
    exported = len(records[0]["tokens"])
    assert (len(PROMPT) + exported > 16) == outgrown and exported >= 2
    second = make(model, importer)
    mapping = second.resume_inflight(records)
    resumed = second.request(mapping[rid])
    assert len(resumed.tokens) == (0 if outgrown else exported)
    assert resumed.resume_from == len(resumed.tokens)
    assert list(second.drain()[mapping[rid]]) == reference
    if importer == "port":
        reingested = second.stats()["goodput"]["tokens"]["reingested"]
        assert reingested == (0 if outgrown else exported)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_resume_of_a_chunked_export_into_a_bucketed_engine(model, reference,
                                                           package):
    """A record from a chunked engine of either package whose context has
    outgrown the bucketed importer's buckets: recomputed from its prompt,
    and the stream is the uninterrupted one (keyed sampling)."""
    first = make(model, package, prefill="chunked")
    rid = first.submit(PROMPT, 10, **SAMPLED)
    while len(first.request(rid).tokens) < 4:
        first.step()
    second = make(model, "port")
    mapping = second.resume_inflight(first.export_inflight())
    assert second.request(mapping[rid]).tokens == []
    assert list(second.drain()[mapping[rid]]) == reference


def test_bucketed_obs_spans_equal_jax(model):
    jcfg, jparams, cfg, params = model
    engines = (JaxServingEngine(jparams, jcfg, JaxServingConfig(
                   **KNOBS, decode_impl="xla"), rng=jax.random.PRNGKey(0),
                   obs=JaxObs.create("jax-bucketed")),
               ServingEngine(params, cfg, ServingConfig(**KNOBS),
                             rng=R.PRNGKey(0), device=CPU,
                             obs=Obs.create("port-bucketed")))
    spans, counters = [], []
    for engine in engines:
        rng = np.random.default_rng(0)
        for i in range(5):
            engine.submit(rng.integers(0, 64, size=2 + 3 * i), 5,
                          **({"temperature": 0.8} if i % 2 else {}))
        engine.drain()
        tracer = (engine._obs if engine is engines[0] else engine.obs).tracer
        spans.append(sorted((span.name, sorted(span.attrs.items()))
                            for span in tracer.finished()))
        counters.append({k: v.get("value") for k, v in
                         engine.stats()["obs"].items()
                         if k.startswith("engine.") and "value" in v})
    assert spans[1] == spans[0]
    assert {name for name, _ in spans[1]} == {"engine.queue",
                                              "engine.prefill",
                                              "engine.decode"}
    assert counters[1] == counters[0]
