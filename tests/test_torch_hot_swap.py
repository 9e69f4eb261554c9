"""Weight hot-swap in the port's serving engine (``adopt_params``, ROADMAP
A8) against the JAX package's engine, at fp32 on the CPU, on the ``tiny``
preset with the JAX weights (``params_from_jax``) and the same base key.

Streams started before ``adopt_params`` finish under the weights they
started with, new admissions take the new ones, and while the slots hold
both generations each step runs its programs once per generation: the
port's streams equal the JAX engine's token for token (greedy and keyed
sampled, fp32 and int8 pools, ``micro_k`` 4, ``spec_k`` 2), and so do
``generation``, ``stats()["adapters"]`` and the roll's registry names.
An old generation is freed when its last stream retires. A mid-roll
export resumes across the packages in both directions, each engine
restoring the generation it does not hold through ``param_loader``.

One difference from the JAX engine: when the slots hold only old streams
while new ones wait in the queue, the JAX engine runs the old streams
under the new weights (its dispatch generation counts queued streams);
the port keeps them on their own, which the single-generation engines
below confirm."""

import jax
import numpy as np
import pytest

from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task.obs import Obs as JaxObs
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.obs import Obs
from torch_port_util import CPU, jax_model, port_model, serving_knobs, \
    share_jax_programs

PRESET = "tiny"
NEW_GENERATION = 7
ROLL_KEYS = ("engine.param_generation", "engine.param_swaps",
             "engine.stale_generation_streams")


@pytest.fixture(scope="module")
def weights():
    """(JAX cfg, JAX old and new params, port cfg, port old and new
    params): the new generation draws from another key."""
    jcfg, jold = jax_model(PRESET)
    jnew = jtf.init(jax.random.PRNGKey(9), jcfg)
    cfg, old = port_model(jcfg, jold)
    _, new = port_model(jcfg, jnew)
    return jcfg, jold, jnew, cfg, old, new


def _jax_engine(weights, params=None, obs=None, param_loader=None, **over):
    jcfg, jold = weights[0], weights[1]
    knobs = serving_knobs(PRESET, **over)
    spec = knobs.get("spec_k", 0) > 0
    return share_jax_programs(JaxServingEngine(
        jold if params is None else params, jcfg,
        JaxServingConfig(**{**knobs, "decode_impl": "xla"}),
        rng=jax.random.PRNGKey(6), obs=obs, param_loader=param_loader,
        draft_params=jold if spec else None, draft_cfg=jcfg if spec else None))


def _port_engine(weights, params=None, obs=None, param_loader=None, **over):
    cfg, old = weights[3], weights[4]
    knobs = serving_knobs(PRESET, **over)
    spec = knobs.get("spec_k", 0) > 0
    return ServingEngine(
        old if params is None else params, cfg,
        ServingConfig(**{**knobs, "decode_impl": "reference"}),
        rng=R.PRNGKey(6), device=CPU, obs=obs, param_loader=param_loader,
        draft_params=old if spec else None, draft_cfg=cfg if spec else None)


def _prompts():
    rng = np.random.default_rng(0)
    old = rng.integers(0, 256, size=6)
    new = rng.integers(0, 256, size=7)
    return old, new


def _roll(engine, new_params):
    """Two old streams (greedy, sampled) until each holds 3 tokens, the
    roll to generation 7, two new streams, then drained. Returns the four
    streams and the number of steps that ran two generations."""
    old, new = _prompts()
    rids = [engine.submit(old, 12),
            engine.submit(old[:4], 10, temperature=0.9, key=[5, 6])]
    while min(len(engine.request(r).tokens) for r in rids) < 3:
        engine.step()
    assert engine.adopt_params(new_params,
                               generation=NEW_GENERATION) == NEW_GENERATION
    assert engine.generation == NEW_GENERATION
    rids += [engine.submit(new, 8),
             engine.submit(new[:5], 9, temperature=0.7, key=[7, 8])]
    assert engine.stats()["adapters"]["stale_generation_streams"] == 2
    mixed = 0
    while engine.has_work:
        mixed += len({r.generation for r in engine._slots if r}) > 1
        engine.step()
    return [engine.request(r).tokens for r in rids], mixed


@pytest.mark.parametrize("kv_dtype,micro_k,spec_k", [
    (None, 1, 0), ("int8", 1, 0), (None, 4, 0), (None, 1, 2)])
def test_roll_matches_jax(weights, kv_dtype, micro_k, spec_k):
    over = dict(kv_dtype=kv_dtype, micro_k=micro_k, spec_k=spec_k)
    jax_engine = _jax_engine(weights, obs=JaxObs.create("jax-roll"), **over)
    port = _port_engine(weights, obs=Obs.create("port-roll"), **over)
    want, jax_mixed = _roll(jax_engine, weights[2])
    got, mixed = _roll(port, weights[5])
    assert got == want
    assert mixed == jax_mixed > 0
    assert [len(s) for s in got] == [12, 10, 8, 9]
    assert port.generation == jax_engine.generation == NEW_GENERATION
    js, ps = jax_engine.stats(), port.stats()
    assert ps["adapters"] == js["adapters"]
    assert ps["adapters"]["param_swaps"] == 1
    assert ps["adapters"]["stale_generation_streams"] == 0
    for key in ("steps", "decode_steps", "chunk_steps", "prefills"):
        assert ps[key] == js[key], key
    assert ps["spec"] == js["spec"]
    assert {k: ps["obs"][k]["value"] for k in ROLL_KEYS} == \
        {k: js["obs"][k]["value"] for k in ROLL_KEYS}
    # The old weights left with their last stream.
    assert set(port._gen_params) == set(jax_engine._gen_params) == \
        {NEW_GENERATION}
    if micro_k > 1:
        assert set(port._micro_graphs) == {NEW_GENERATION}
        assert ps["step_graph"]["captures"] == 0      # the CPU runs eagerly
        assert port.micro_steps > 0
    for engine in (port, jax_engine):
        with pytest.raises(ValueError, match="monotonically"):
            engine.adopt_params(weights[4] if engine is port else weights[1],
                                generation=NEW_GENERATION)


def test_roll_keeps_old_streams_on_their_weights_while_new_ones_wait(
        weights):
    """One slot: the new stream waits in the queue until the old one
    retires. The old stream is the single-generation engine's under the
    old weights, the new one's under the new weights, in both packages'
    single-generation engines; the swap changed the new stream; and
    ``adopt_params`` with no stream of the old generation left frees it
    at once."""
    old, new = _prompts()
    port = _port_engine(weights, slots=1)
    a = port.submit(old, 12)
    while len(port.request(a).tokens) < 3:
        port.step()
    port.adopt_params(weights[5], generation=NEW_GENERATION)
    b = port.submit(new, 8)
    out = port.drain()

    def alone(make, params, prompt, n):
        engine = make(weights, params, slots=1)
        rid = engine.submit(prompt, n)
        return engine.drain()[rid]

    for make, old_params, new_params in (
            (_port_engine, weights[4], weights[5]),
            (_jax_engine, weights[1], weights[2])):
        assert out[a] == alone(make, old_params, old, 12)
        assert out[b] == alone(make, new_params, new, 8)
    assert out[b] != alone(_port_engine, weights[4], new, 8)
    assert set(port._gen_params) == {NEW_GENERATION}
    assert port.adopt_params(weights[4]) == NEW_GENERATION + 1
    assert set(port._gen_params) == {NEW_GENERATION + 1}
    assert port.stats()["adapters"]["param_swaps"] == 2


def _mid_roll_export(engine, new_params):
    """Streams pinned to generations 0 and 7, each holding tokens, then
    the export; the engine itself drains on to the uninterrupted
    streams."""
    old, new = _prompts()
    rids = [engine.submit(old, 12),
            engine.submit(old[:4], 10, temperature=0.9, key=[5, 6])]
    while min(len(engine.request(r).tokens) for r in rids) < 3:
        engine.step()
    engine.adopt_params(new_params, generation=NEW_GENERATION)
    rids += [engine.submit(new, 8),
             engine.submit(new[:5], 9, temperature=0.7, key=[7, 8])]
    while min(len(engine.request(r).tokens) for r in rids[2:]) < 2:
        engine.step()
    records = engine.export_inflight()
    out = engine.drain()
    return records, {r: out[r] for r in rids}


def test_resume_across_a_roll_crosses_the_packages(weights):
    """A mid-roll export from either package resumes in a fresh engine of
    the other that holds the old weights as its generation 0 and restores
    generation 7 through ``param_loader``: the streams equal the
    exporting engine's uninterrupted ones. Without a loader, both
    packages refuse the generation-7 records."""
    jax_records, jax_streams = _mid_roll_export(_jax_engine(weights),
                                                weights[2])
    port_records, port_streams = _mid_roll_export(_port_engine(weights),
                                                  weights[5])
    assert port_streams == jax_streams
    assert {r["generation"] for r in jax_records} == \
        {r["generation"] for r in port_records} == {0, NEW_GENERATION}
    loads = []

    def loader(new):
        def load(generation):
            loads.append(generation)
            return new if generation == NEW_GENERATION else None
        return load

    for records, importer in (
            (jax_records, _port_engine(weights,
                                       param_loader=loader(weights[5]))),
            (port_records, _jax_engine(weights,
                                       param_loader=loader(weights[2])))):
        mapping = importer.resume_inflight(records)
        out = importer.drain()
        assert {rid: out[mapping[rid]] for rid in mapping} == \
            {r["rid"]: jax_streams[r["rid"]] for r in records}
        assert set(importer._gen_params) == {0}
    assert loads == [NEW_GENERATION, NEW_GENERATION]

    pinned = [r for r in jax_records if r["generation"] == NEW_GENERATION]
    for engine in (_port_engine(weights), _jax_engine(weights),
                   _port_engine(weights, param_loader=lambda gen: None)):
        with pytest.raises(ValueError, match="different weights"):
            engine.resume_inflight(pinned)
