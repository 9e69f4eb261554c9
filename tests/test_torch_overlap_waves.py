"""The port's overlapped engine loop under arrivals interleaved with steps
and under paged LoRA adapters, against the JAX package's, at fp32 on the
CPU.

Arrivals: ``tests/test_serving_async.py``'s seeded soak (admissions land
mid-flight, retire under the pipeline, pools tight enough to preempt,
``micro_k`` and ``prefill_slots`` drawn per run) on the ``tiny`` preset,
three seeds. The port's overlapped engine returns the JAX overlapped
engine's ``step()`` dict (admitted, finished, active, queued) at every
step, and its streams equal both packages' synchronous loops'.

LoRA: ``tests/test_torch_lora_engine.py``'s 8-adapter mixed wave at K 1
and 4, greedy and sampled: decode rows run their slot's adapter rows,
chunk rows their owning slot's."""

import jax
import numpy as np
import pytest

from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from test_torch_lora_engine import TINY as LORA_TINY
from test_torch_lora_engine import jax_engine as lora_jax_engine
from test_torch_lora_engine import mixed_wave, run_wave
from test_torch_lora_engine import port_engine as lora_port_engine
from test_torch_overlap_engine import BASE, COUNTERS
from torch_port_util import CPU, jax_model, port_model, share_jax_programs


@pytest.fixture(scope="module")
def tiny():
    jcfg, jparams = jax_model("tiny")
    cfg, params = port_model(jcfg, jparams)
    return jcfg, jparams, cfg, params


def _soak(seed, vocab):
    """``test_overlap_randomized_schedule_soak``'s draw for ``seed``."""
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(8, 14))
    specs = []
    for _ in range(n):
        prompt = rng.integers(0, vocab, size=int(rng.integers(2, 14)))
        t = float(rng.choice([0.0, 0.7, 1.1]))
        specs.append(dict(prompt=prompt, max_new=int(rng.integers(2, 16)),
                          temperature=t, top_p=0.9 if t else None,
                          eos_token=int(rng.integers(0, 16))))
    gaps = [int(rng.integers(0, 4)) for _ in specs]
    knobs = dict(BASE, slots=int(rng.integers(2, 5)),
                 n_blocks=int(rng.integers(12, 40)), max_len=32,
                 micro_k=int(rng.choice([1, 2, 8])),
                 chunk_tokens=int(rng.choice([4, 16])))
    knobs["prefill_slots"] = int(rng.integers(1, knobs["slots"] + 1))
    return specs, gaps, knobs


def _run(engine, specs, gaps):
    """Submit each request, then step ``gap`` times; then drain. Returns
    the streams and every step's dict."""
    steps = []
    for spec, gap in zip(specs, gaps):
        engine.submit(spec["prompt"], spec["max_new"],
                      temperature=spec["temperature"], top_p=spec["top_p"],
                      eos_token=spec["eos_token"])
        for _ in range(gap):
            steps.append(engine.step())
    while engine.has_work:
        steps.append(engine.step())
    return {rid: list(r.tokens) for rid, r in engine._requests.items()}, \
        steps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arrivals_between_steps_match_jax(tiny, seed):
    jcfg, jparams, cfg, params = tiny
    specs, gaps, knobs = _soak(seed, jcfg.vocab_size)
    runs = {}
    for port in (False, True):
        for overlap in (False, True):
            k = dict(knobs, overlap=overlap)
            engine = (ServingEngine(
                params, cfg, ServingConfig(**k, decode_impl="reference"),
                rng=R.PRNGKey(42), device=CPU) if port else
                share_jax_programs(JaxServingEngine(
                    jparams, jcfg, JaxServingConfig(**k, decode_impl="xla"),
                    rng=jax.random.PRNGKey(42))))
            runs[port, overlap] = (*_run(engine, specs, gaps), engine)
    got, steps, port = runs[True, True]
    want, jax_steps, jax_overlap = runs[False, True]
    assert got == want == runs[False, False][0] == runs[True, False][0]
    assert steps == jax_steps
    for name in COUNTERS:
        assert getattr(port, name) == getattr(jax_overlap, name), name
    assert port.preemption_count == runs[True, False][2].preemption_count


@pytest.fixture(scope="module")
def lora_weights():
    jparams = jtf.init(jax.random.PRNGKey(0), LORA_TINY)
    cfg, params = port_model(LORA_TINY, jparams)
    return dict(jax=jparams, cfg=cfg, port=params)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("micro_k", [1, 4])
def test_lora_mixed_wave_overlapped_matches_jax(lora_weights, micro_k,
                                                sampled):
    """The base stream and eight tenants through the overlapped loops of
    both packages equal both synchronous loops' streams, with JAX's
    overlapped schedule and adapter loads."""
    runs = {}
    for make, name in ((lora_jax_engine, "jax"), (lora_port_engine, "port")):
        for overlap in (False, True):
            engine = make(lora_weights, micro_k=micro_k, overlap=overlap)
            runs[name, overlap] = (run_wave(engine, mixed_wave(sampled)),
                                   engine)
    streams = {key: run[0] for key, run in runs.items()}
    assert streams["port", True] == streams["jax", True] \
        == streams["jax", False] == streams["port", False]
    port, jax_overlap = runs["port", True][1], runs["jax", True][1]
    for name in COUNTERS + ("adapter_loads",):
        assert getattr(port, name) == getattr(jax_overlap, name), name
    assert port.stats()["adapters"] == jax_overlap.stats()["adapters"]
