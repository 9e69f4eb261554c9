"""The port's quantized-KV serving engine against the JAX package's, at
fp32 on the CPU, from the same weights.

Both engines take the same submissions with the same ``kv_dtype``; the JAX
one runs its XLA gather path (``decode_impl="xla"``), the port its plain
paged attention over the same codes (which ``test_torch_kv_quant`` holds
bit-identical to JAX's). Greedy streams must be token-identical and
sampled streams key-identical, with the same scheduler decisions, on the
``INT8_PIN`` geometry of ``tests/test_paged_attention.py`` and on the
``micro`` preset, with the prefix cache on and off and under forced
preemption; ``stats()["kv_quant"]`` and ``kv_bytes_per_token`` must equal
JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.models import transformer as ttf
from tpu_task_torch.ml.ops import paged_attention as tpa
from tpu_task_torch.ml.serving import cache as tc
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.ml.serving.model import paged_decode_step
from tpu_task_torch.serve.replica import build_engine
from torch_port_util import CPU, jax_model, port_config, serving_knobs, \
    share_jax_programs

SCHEDULE_KEYS = ("steps", "decode_steps", "chunk_steps", "prefills",
                 "prefill_chunks", "recompute_preemptions")
PREFIX_KEYS = ("miss_blocks", "hit_requests", "tokens_saved", "blocks_saved",
               "cow_copies", "cached_blocks", "evictions")

#: ``tests/test_paged_attention.py``'s INT8_PIN model and engine geometry.
INT8_PIN = dict(vocab_size=128, d_model=128, n_layers=2, n_heads=4,
                d_head=16, d_ff=256, n_kv_heads=2)
PIN_SERVING = dict(slots=3, block_size=4, n_blocks=32, max_len=48,
                   chunk_tokens=6)


def _models(geometry):
    if geometry == "micro":
        return jax_model("micro")
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **INT8_PIN)
    return jcfg, jtf.init(jax.random.PRNGKey(0), jcfg)


def _engines(geometry, kv_dtype, **over):
    knobs = (serving_knobs("micro") if geometry == "micro"
             else dict(PIN_SERVING))
    knobs.update(kv_dtype=kv_dtype, **over)
    jcfg, jparams = _models(geometry)
    jax_engine = share_jax_programs(JaxServingEngine(
        jparams, jcfg, JaxServingConfig(**knobs, decode_impl="xla"),
        rng=jax.random.PRNGKey(0)))
    cfg = port_config(jcfg)
    params = ttf.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    port_engine = ServingEngine(params, cfg, ServingConfig(**knobs),
                                rng=R.PRNGKey(0), device=CPU)
    return jax_engine, port_engine


def _waves(vocab, bs, seed):
    """Mixed lengths (some longer than a chunk), greedy and sampled with
    raw and engine-derived keys, then a second wave that shares a
    multi-block prefix with the first and hits its whole prompt (COW)."""
    rng = np.random.default_rng(seed)
    ps = [rng.integers(0, vocab, size=n).astype(np.int32)
          for n in (3 * bs + 2, 9, 1, 2 * bs + 1, 5)]
    first = [(ps[0], 7, {}), (ps[1], 6, {"temperature": 0.9, "top_p": 0.9,
                                         "key": [3, 2**32 - 5]}),
             (ps[2], 8, {}), (ps[3], 6, {"temperature": 1.1}),
             (ps[4], 9, {})]
    second = [(np.concatenate([ps[0][:2 * bs], ps[4]]), 5, {}),
              (ps[0][:3 * bs], 4, {"temperature": 0.7, "key": [9, 9]})]
    return [first, second]


def _drain_both(engines, waves):
    outs = []
    for engine in engines:
        for wave in waves:
            for prompt, max_new, kw in wave:
                engine.submit(prompt, max_new, **kw)
            result = engine.drain(max_steps=3000)
        outs.append(result)
    return outs


def _assert_same(jax_engine, port_engine):
    js, ps = jax_engine.stats(), port_engine.stats()
    assert {k: js[k] for k in SCHEDULE_KEYS} == \
        {k: ps[k] for k in SCHEDULE_KEYS}
    assert {k: js["prefix_cache"][k] for k in PREFIX_KEYS} == \
        {k: ps["prefix_cache"][k] for k in PREFIX_KEYS}
    assert ps["kv_quant"] == js["kv_quant"]
    assert ps["kv_bytes_per_token"] == js["kv_bytes_per_token"]
    assert ps["kv_pool_bytes"] == js["kv_pool_bytes"]
    return ps


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("geometry,prefix_cache", [
    ("int8_pin", True), ("int8_pin", False), ("micro", True)])
def test_streams_match_jax(geometry, prefix_cache, kv_dtype):
    if kv_dtype == "fp8" and not tc.fp8_supported():
        pytest.skip("float8_e4m3fn is not supported here")
    jax_engine, port_engine = _engines(geometry, kv_dtype,
                                       prefix_cache=prefix_cache)
    waves = _waves(port_engine.cfg.vocab_size, port_engine.scfg.block_size,
                   seed=len(kv_dtype) + prefix_cache)
    want, got = _drain_both([jax_engine, port_engine], waves)
    assert got == want
    stats = _assert_same(jax_engine, port_engine)
    assert stats["kv_quant"]["kv_dtype"] == kv_dtype
    assert stats["kv_quant"]["quantized_block_writes"] > 0
    assert stats["kv_quant"]["max_quant_error_observed"] is None
    assert stats["decode_impl"] == "reference"
    if prefix_cache:
        assert stats["prefix_cache"]["cow_copies"] > 0


@pytest.mark.parametrize("kv_dtype,geometry,n_blocks", [
    ("int8", "micro", 14), ("int4", "int8_pin", 12), ("fp8", "micro", 12)])
def test_small_pool_preempts_identically(kv_dtype, geometry, n_blocks):
    if kv_dtype == "fp8" and not tc.fp8_supported():
        pytest.skip("float8_e4m3fn is not supported here")
    jax_engine, port_engine = _engines(geometry, kv_dtype, n_blocks=n_blocks)
    bs = port_engine.scfg.block_size
    rng = np.random.default_rng(8)
    ps = [rng.integers(0, port_engine.cfg.vocab_size, size=n)
          for n in (2 * bs + 1, bs, 3, bs + 3)]
    max_new = min(5 * bs, port_engine.scfg.max_len - 2 * bs - 1)
    wave = [(ps[0], max_new, {}), (ps[1], max_new, {}),
            (ps[2], max_new, {"temperature": 0.7, "key": [1, 2]}),
            (ps[3], max_new, {})]
    want, got = _drain_both([jax_engine, port_engine], [wave])
    assert got == want
    assert _assert_same(jax_engine, port_engine)["recompute_preemptions"] > 0


def test_build_engine_int4_drains_and_counts():
    """``build_engine``'s serving dict reaches the quantized engine: int4
    pools of d/2 packed bytes, a quarter of the fp32 engine's pool bytes
    plus scales, every fused step through the plain version on the CPU."""
    engine = build_engine("micro", serving={"kv_dtype": "int4"},
                          device="cpu")
    plain = build_engine("micro", device="cpu")
    assert engine.pools[0]["k"].dtype == torch.uint8
    assert engine.pools[0]["k"].shape[-1] == engine.cfg.d_head // 2
    tpa.reset_launch_counts()
    rng = np.random.default_rng(2)
    rids = [engine.submit(rng.integers(0, 64, size=n), 6) for n in (4, 9, 2)]
    out = engine.drain()
    assert all(len(out[rid]) == 6 for rid in rids)
    st = engine.stats()
    assert st["attention_launches"] == {
        "cuda": 0, "pipelined": 0,
        "reference": engine.cfg.n_layers * (engine.chunk_steps
                                            + engine.decode_steps)}
    assert st["kv_pool_bytes"] < plain.stats()["kv_pool_bytes"] / 4
    assert engine.allocator.referenced == 0


def test_debug_mode_tracks_the_write_error(monkeypatch):
    """``TPU_TASK_CHECKIFY=1`` reads back each step's largest write
    error: positive, and within int8's half step of the largest scale."""
    monkeypatch.setenv("TPU_TASK_CHECKIFY", "1")
    engine = build_engine("micro", serving={"kv_dtype": "int8"},
                          device="cpu")
    engine.submit(np.arange(1, 12), 5)
    engine.drain()
    err = engine.stats()["kv_quant"]["max_quant_error_observed"]
    worst_scale = max(float(pool[name].max()) for pool in engine.pools
                      for name in ("k_scale", "v_scale"))
    assert 0 < err <= worst_scale / 2 * (1 + 1e-6)


def test_refusals():
    """The pipelined kernel needs the card like the tile kernel does; a
    quantized pool's host tier validates as JAX's; a step on quantized
    pools without its write layout raises."""
    engine = build_engine("micro", serving={"kv_dtype": "int8"},
                          device="cpu")
    for impl in ("cuda", "pipelined"):
        with pytest.raises(ValueError, match="CUDA device"):
            ServingEngine(engine.params, engine.cfg,
                          ServingConfig(decode_impl=impl, kv_dtype="int8"),
                          device="cpu")
    # The host tier is ported: over a quantized pool its knob validates as
    # the JAX config's does.
    assert ServingConfig(kv_dtype="int4",
                         host_offload_blocks=4).host_offload_blocks == 4
    messages = []
    for config in (ServingConfig, JaxServingConfig):
        with pytest.raises(ValueError, match="needs prefix_cache") as info:
            config(kv_dtype="int4", host_offload_blocks=4,
                   prefix_cache=False)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    # The overlapped loop is ported: over quantized pools it refuses what
    # the JAX config refuses, and nothing else.
    with pytest.raises(ValueError, match="overlap=True needs"):
        ServingConfig(kv_dtype="int4", overlap=True, prefill="bucketed",
                      prefix_cache=False)
    assert ServingConfig(kv_dtype="int4", overlap=True).overlap
    one = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="write layout"):
        paged_decode_step(engine.params, engine.cfg, one,
                          one.to(torch.int32),
                          torch.zeros((1, 4), dtype=torch.int32),
                          torch.ones(1, dtype=torch.bool), engine.pools)
