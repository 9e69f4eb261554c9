"""Bucketed prefill in the port's serving engine under paged LoRA adapters
and a weight roll, against the JAX package's bucketed engine, at fp32 on
the CPU, from the same weights and base key.

An 8-adapter wave on the ``micro`` preset (a base stream and one request a
tenant, greedy and keyed-sampled, at K 1 and 4): each bucketed admission
runs its adapter's branch in the prefill program and the decode steps
after it. A weight roll (``adopt_params``) with two streams of each
generation in the slots: each admission prefills under its own
generation's weights. Streams are equal token for token, and so are the
schedule counters and ``stats()["adapters"]``."""

import jax
import numpy as np
import pytest

from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from torch_port_util import (CPU, jax_model, port_model, serving_knobs,
                             share_jax_programs)

PRESET = "micro"
BUCKETED = dict(prefill="bucketed", prefix_cache=False,
                prefill_buckets=(8, 16, 32, 48))
RANK = 4
N_ADAPTERS = 8
NEW_GENERATION = 7
SCHEDULE_KEYS = ("steps", "decode_steps", "micro_steps", "chunk_steps",
                 "prefills", "prefill_chunks", "recompute_preemptions")


@pytest.fixture(scope="module")
def weights():
    """(JAX cfg, JAX old and new params, port cfg, port old and new
    params): the new generation draws from another key."""
    jcfg, jold = jax_model(PRESET)
    jnew = jtf.init(jax.random.PRNGKey(9), jcfg)
    cfg, old = port_model(jcfg, jold)
    _, new = port_model(jcfg, jnew)
    return jcfg, jold, jnew, cfg, old, new


def engines(weights, **over):
    jcfg, jold, _, cfg, old, _ = weights
    knobs = serving_knobs(PRESET, **BUCKETED, **over)
    return (share_jax_programs(JaxServingEngine(
                jold, jcfg, JaxServingConfig(**knobs, decode_impl="xla"),
                rng=jax.random.PRNGKey(2))),
            ServingEngine(old, cfg, ServingConfig(**knobs),
                          rng=R.PRNGKey(2), device=CPU))


def adapter(seed):
    rng = np.random.default_rng(seed)
    return [{"a": rng.normal(size=(32, RANK)), "b": rng.normal(size=(RANK, 32))}
            for _ in range(2)]


ADAPTERS = {f"tenant-{i}": adapter(200 + i) for i in range(N_ADAPTERS)}


def lora_wave(engine, sampled: bool):
    """Register every tenant, then a base request and one request a
    tenant; returns the streams in submission order."""
    for aid, layers in ADAPTERS.items():
        engine.register_adapter(aid, layers, scale=1.5)
    rng = np.random.default_rng(17)
    rids = []
    for i, aid in enumerate([None] + list(ADAPTERS)):
        kw = ({"temperature": 0.8, "top_p": 0.9, "key": [300 + i, 5]}
              if sampled else {})
        rids.append(engine.submit(rng.integers(0, 64, size=5 + 3 * (i % 4)),
                                  10, adapter_id=aid, **kw))
    out = engine.drain()
    return [list(out[r]) for r in rids]


@pytest.mark.parametrize("micro_k", [1, 4])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_lora_wave_matches_jax(weights, sampled, micro_k):
    jax_engine, port = engines(
        weights, lora_rank=RANK, n_adapter_blocks=1 + 2 * N_ADAPTERS,
        micro_k=micro_k)
    want = lora_wave(jax_engine, sampled)
    got = lora_wave(port, sampled)
    assert got == want
    js, ps = jax_engine.stats(), port.stats()
    assert ps["adapters"] == js["adapters"]
    assert ps["adapters"]["loads"] == N_ADAPTERS
    for key in SCHEDULE_KEYS:
        assert ps[key] == js[key], key
    assert ps["prefills"] == N_ADAPTERS + 1 and ps["chunk_steps"] == 0
    # The adapters are strong enough to move the streams off the base's.
    base = ServingEngine(weights[4], weights[3], ServingConfig(
        **serving_knobs(PRESET, **BUCKETED, micro_k=micro_k)),
        rng=R.PRNGKey(2), device=CPU)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 64, size=5 + 3 * (i % 4))
               for i in range(N_ADAPTERS + 1)]
    kws = [({"temperature": 0.8, "top_p": 0.9, "key": [300 + i, 5]}
            if sampled else {}) for i in range(N_ADAPTERS + 1)]
    rids = [base.submit(p, 10, **kw) for p, kw in zip(prompts, kws)]
    plain = base.drain()
    assert got[0] == plain[rids[0]]
    assert sum(got[i] != plain[rids[i]] for i in range(1, 9)) >= 6


def roll(engine, new_params):
    """Two old streams (greedy, sampled) until each holds 3 tokens, the
    roll to generation 7, two new streams admitted while the old ones run,
    then drained. Returns the four streams and the steps that ran two
    generations."""
    rng = np.random.default_rng(0)
    old, new = rng.integers(0, 64, size=6), rng.integers(0, 64, size=11)
    rids = [engine.submit(old, 12),
            engine.submit(old[:4], 10, temperature=0.9, key=[5, 6])]
    while min(len(engine.request(r).tokens) for r in rids) < 3:
        engine.step()
    assert engine.adopt_params(new_params,
                               generation=NEW_GENERATION) == NEW_GENERATION
    rids += [engine.submit(new, 8),
             engine.submit(new[:5], 9, temperature=0.7, key=[7, 8])]
    mixed = 0
    while engine.has_work:
        mixed += len({r.generation for r in engine._slots if r}) > 1
        engine.step()
    return [engine.request(r).tokens for r in rids], mixed


@pytest.mark.parametrize("micro_k", [1, 4])
def test_roll_matches_jax(weights, micro_k):
    jax_engine, port = engines(weights, micro_k=micro_k)
    want, jax_mixed = roll(jax_engine, weights[2])
    got, mixed = roll(port, weights[5])
    assert got == want
    assert mixed == jax_mixed > 0
    assert [len(s) for s in got] == [12, 10, 8, 9]
    js, ps = jax_engine.stats(), port.stats()
    assert ps["adapters"] == js["adapters"]
    assert ps["adapters"]["param_swaps"] == 1
    for key in SCHEDULE_KEYS:
        assert ps[key] == js[key], key
    assert set(port._gen_params) == {NEW_GENERATION}
    # Each new stream is that of an engine holding the new weights alone.
    alone = ServingEngine(weights[5], weights[3], ServingConfig(
        **serving_knobs(PRESET, **BUCKETED, micro_k=micro_k)),
        rng=R.PRNGKey(2), device=CPU)
    rng = np.random.default_rng(0)
    rng.integers(0, 64, size=6)
    new = rng.integers(0, 64, size=11)
    rids = [alone.submit(new, 8), alone.submit(new[:5], 9, temperature=0.7,
                                               key=[7, 8])]
    out = alone.drain()
    assert got[2:] == [out[r] for r in rids]
