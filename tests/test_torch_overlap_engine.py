"""The port's overlapped engine loop (``ServingConfig(overlap=True)``,
ROADMAP A5) against the JAX package's, at fp32 on the CPU, from the same
weights.

The workload is ``tests/test_serving_async.py``'s (``_workload``: eight
requests of 3-11 prompt tokens, 3-13 new tokens, eos 7) on the ``tiny``
preset, and, for the pool-pressure case, on ``micro``, whose weights are
that test's ``TINY`` model's. Each case runs four engines: the JAX
package's synchronous and overlapped loops and the port's two. The port's
overlapped streams must equal all three token for token, and its
``preemption_count``, ``overlap_flushes``, ``chunk_steps``,
``decode_steps`` and ``micro_steps`` must equal the JAX overlapped
engine's."""

import jax
import numpy as np
import pytest

from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.serve.replica import build_engine
from torch_port_util import CPU, jax_model, port_model, share_jax_programs

#: ``tests/test_serving_async.py``'s BASE serving knobs.
BASE = dict(slots=4, block_size=4, n_blocks=64, max_len=48, chunk_tokens=4,
            prefix_cache=False)
COUNTERS = ("preemption_count", "overlap_flushes", "chunk_steps",
            "decode_steps", "micro_steps")


@pytest.fixture(scope="module")
def models():
    out = {}
    for preset in ("tiny", "micro"):
        jcfg, jparams = jax_model(preset)
        cfg, params = port_model(jcfg, jparams)
        out[preset] = (jcfg, jparams, cfg, params)
    return out


def workload(vocab, seed=0, n=8, temps=False):
    """``tests/test_serving_async.py``'s ``_workload`` over ``vocab``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        prompt = rng.integers(0, vocab, size=int(rng.integers(3, 12)))
        t = float(rng.choice([0.0, 0.8])) if temps else 0.0
        out.append(dict(prompt=prompt, max_new=int(rng.integers(3, 14)),
                        temperature=t, top_p=0.9 if t else None,
                        eos_token=7))
    return out


def engines(model, knobs):
    """The four engines of a case: JAX sync, JAX overlap, port overlap,
    port sync."""
    jcfg, jparams, cfg, params = model
    out = []
    for port, overlap in ((False, False), (False, True), (True, True),
                          (True, False)):
        k = dict(knobs, overlap=overlap)
        if port:
            out.append(ServingEngine(
                params, cfg, ServingConfig(**k, decode_impl="reference"),
                rng=R.PRNGKey(99), device=CPU))
        else:
            out.append(share_jax_programs(JaxServingEngine(
                jparams, jcfg, JaxServingConfig(**k, decode_impl="xla"),
                rng=jax.random.PRNGKey(99))))
    return out


def drain(engine, specs):
    for spec in specs:
        engine.submit(spec["prompt"], spec["max_new"],
                      temperature=spec["temperature"], top_p=spec["top_p"],
                      eos_token=spec["eos_token"])
    return engine.drain()


def assert_parity(four, outs):
    """Every stream equal across the four engines; the port's overlapped
    schedule counters equal JAX's overlapped engine's."""
    jax_sync, jax_overlap, port_overlap, port_sync = four
    assert outs[2] == outs[1], "port overlap != JAX overlap"
    assert outs[2] == outs[0], "port overlap != JAX sync"
    assert outs[3] == outs[2], "port sync != port overlap"
    for name in COUNTERS:
        assert getattr(port_overlap, name) == getattr(jax_overlap, name), \
            name
    stats = port_overlap.stats()
    assert stats["overlap"] is True
    assert stats["overlap_flushes"] == jax_overlap.overlap_flushes
    assert port_overlap.allocator.referenced == 0
    assert port_overlap._inflight is None


CASES = {
    "greedy-k1": dict(),
    "greedy-k4": dict(micro_k=4),
    "sampled-k1": dict(temps=True),
    "sampled-k4": dict(temps=True, micro_k=4, seed=2),
    "int8-k1": dict(kv_dtype="int8"),
    "int4-k4-sampled": dict(kv_dtype="int4", micro_k=4, temps=True),
    "burst-prefill_slots3": dict(chunk_tokens=16, prefill_slots=3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_overlap_streams_and_schedule_match_jax(models, case):
    over = dict(CASES[case])
    seed, temps = over.pop("seed", 0), over.pop("temps", False)
    model = models["tiny"]
    four = engines(model, dict(BASE, **over))
    specs = workload(model[0].vocab_size, seed, temps=temps)
    outs = [drain(e, specs) for e in four]
    assert_parity(four, outs)
    if over.get("micro_k", 1) > 1:
        assert four[2].micro_steps > 0
    if over.get("prefill_slots", 1) > 1:
        # The burst packs several admissions into one chunk program.
        assert four[2].chunk_steps < len(specs)


def test_pool_pressure_flushes_and_preempts_as_jax(models):
    """``tests/test_serving_async.py``'s pool-pressure case at the pool
    where its synchronous loop preempts (8 blocks; at 10 neither JAX loop
    preempts): the overlapped loop flushes to the synchronous edge and
    preempts exactly where the synchronous loops do."""
    four = engines(models["micro"],
                   dict(BASE, slots=3, n_blocks=8, max_len=32))
    specs = workload(models["micro"][0].vocab_size, seed=3, n=6)
    outs = [drain(e, specs) for e in four]
    assert_parity(four, outs)
    jax_sync, jax_overlap, port_overlap, port_sync = four
    assert port_overlap.preemption_count == jax_sync.preemption_count \
        == port_sync.preemption_count > 0
    assert port_overlap.overlap_flushes > 0


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_micro_steps_reach_max_len(kv_dtype):
    """A quantized micro-step whose span ends inside K at ``max_len``: its
    write layout looks up only the valid iterations (the rest sit past the
    slot's table; the JAX package's layout, which indexes them too,
    raises IndexError here). Both loops at K 8 give K 1's streams."""
    prompt = np.random.default_rng(0).integers(0, 256, size=29)
    outs = []
    for micro_k, overlap in ((1, False), (8, False), (8, True)):
        engine = build_engine("tiny", device="cpu", serving=dict(
            kv_dtype=kv_dtype, micro_k=micro_k, overlap=overlap,
            max_len=40))
        rids = [engine.submit(prompt, 11), engine.submit(prompt[:7], 33)]
        out = engine.drain()
        outs.append([out[r] for r in rids])
        assert [len(s) for s in outs[-1]] == [11, 33]
        assert micro_k == 1 or engine.micro_steps > 0
    assert outs[0] == outs[1] == outs[2]
