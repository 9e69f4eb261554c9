"""The port's K-token micro-steps (``ServingConfig.micro_k``) against the
JAX package's, at fp32 on the CPU, from the same weights.

``micro_decode_greedy``/``micro_decode_sample`` take the same numpy inputs
as JAX's (a slot that retires on its eos mid-span, one whose length limit
is shorter than K, an inactive one) and must give the same tokens, with
the pools afterwards within 1e-5. The port's micro engine must give the
JAX micro engine's streams (greedy bit-identical, sampled key-identical)
and the port's own K = 1 streams, through chunked prefill, the prefix
cache and copy-on-write, and a pool small enough to preempt; over
quantized pools its codes must equal JAX's after the drain, and its
scales within the fp32 rounding of the k/v values they scale. The CUDA
graph of the K-step loop is held on the card by
``tests/test_torch_cuda_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task.ml.serving import model as jmodel
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.ops import paged_attention as tpa
from tpu_task_torch.ml.serving import cache as tc
from tpu_task_torch.ml.serving import model as tmodel
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.serve.replica import build_engine
from torch_port_util import CPU, jax_model, port_model, serving_knobs, \
    share_jax_programs

SCHEDULE_KEYS = ("steps", "decode_steps", "micro_k", "micro_steps",
                 "chunk_steps", "prefills", "prefill_chunks",
                 "recompute_preemptions")
PREFIX_KEYS = ("miss_blocks", "hit_requests", "tokens_saved", "blocks_saved",
               "cow_copies", "cached_blocks", "evictions")
POOL_ATOL = 1e-5
SCALE_RTOL = 1e-6


def _micro_inputs(jcfg, preset, micro_k, seed):
    """Random fp32 pools, fragmented tables and ragged positions for the
    preset's slots; slot 3 inactive."""
    knobs = serving_knobs(preset)
    slots, bs = knobs["slots"], knobs["block_size"]
    n_blocks, m = knobs["n_blocks"], -(-knobs["max_len"] // bs)
    rng = np.random.default_rng(seed)
    pools = [{name: rng.standard_normal(
                  (n_blocks, bs, jcfg.n_kv_heads, jcfg.d_head)
              ).astype(np.float32) for name in ("k", "v")}
             for _ in range(jcfg.n_layers)]
    positions = np.array([5, 2 * bs + 1, bs - 1, 0][:slots], np.int32)
    blocks = rng.permutation(np.arange(1, n_blocks)).astype(np.int32)
    tables = np.zeros((slots, m), np.int32)
    used = 0
    for i in range(slots - 1):
        need = (positions[i] + micro_k) // bs + 1
        tables[i, :need] = blocks[used:used + need]
        used += need
    active = np.array([True] * (slots - 1) + [False])
    tokens = rng.integers(0, jcfg.vocab_size, size=slots).astype(np.int32)
    return dict(tokens=tokens, positions=positions, tables=tables,
                active=active, pools=pools,
                temps=np.array([0.0, 0.8, 1.1, 0.0][:slots], np.float32),
                tops=np.array([1.0, 0.9, 1.0, 1.0][:slots], np.float32),
                keys=rng.integers(0, 2**32, size=(slots, 2),
                                  dtype=np.uint64).astype(np.uint32),
                ngen=np.array([0, 3, 7, 0][:slots], np.int32))


def _jax_micro(jcfg, jparams, x, limits, eos, micro_k, sampled):
    jpools = jax.tree.map(jnp.asarray, x["pools"])
    head = (jparams, jcfg, jnp.asarray(x["tokens"]),
            jnp.asarray(x["positions"]), jnp.asarray(x["tables"]),
            jnp.asarray(x["active"]), jnp.asarray(limits), jnp.asarray(eos))
    if sampled:
        toks, pools = jmodel.micro_decode_sample(
            *head, jnp.asarray(x["temps"]), jnp.asarray(x["tops"]),
            jnp.asarray(x["keys"]), jnp.asarray(x["ngen"]), jpools,
            micro_k=micro_k, attn_impl="xla")
    else:
        toks, pools = jmodel.micro_decode_greedy(
            *head, jpools, micro_k=micro_k, attn_impl="xla")
    return np.asarray(toks), jax.tree.map(np.asarray, pools)


def _port_micro(cfg, params, x, limits, eos, micro_k, sampled):
    pools = [{k: torch.from_numpy(v.copy()) for k, v in layer.items()}
             for layer in x["pools"]]
    head = (params, cfg, torch.from_numpy(x["tokens"]).long(),
            torch.from_numpy(x["positions"]), torch.from_numpy(x["tables"]),
            torch.from_numpy(x["active"]), torch.from_numpy(limits),
            torch.from_numpy(eos).long())
    with torch.no_grad():
        if sampled:
            toks = tmodel.micro_decode_sample(
                *head, torch.from_numpy(x["temps"]),
                torch.from_numpy(x["tops"]), R.as_key(x["keys"]),
                torch.from_numpy(x["ngen"]).long(), pools, micro_k=micro_k)
        else:
            toks = tmodel.micro_decode_greedy(*head, pools, micro_k=micro_k)
    return toks.numpy(), [{k: v.numpy() for k, v in layer.items()}
                          for layer in pools]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("micro_k", [2, 4])
@pytest.mark.parametrize("preset", ["micro", "tiny"])
def test_micro_decode_matches_jax(preset, micro_k, sampled):
    """Slot 0 retires on its eos at iteration 1 (or 0, if that token comes
    first), slot 1's limit is one token, slot 2 runs the whole span, slot
    3 is inactive: the same tokens as JAX's, and the pools within 1e-5."""
    jcfg, jparams = jax_model(preset)
    cfg, params = port_model(jcfg, jparams)
    x = _micro_inputs(jcfg, preset, micro_k, seed=micro_k + 2 * sampled)
    slots = len(x["tokens"])
    limits = np.full(slots, micro_k, np.int32)
    eos = np.full(slots, -1, np.int32)
    free_run, _ = _jax_micro(jcfg, jparams, x, limits, eos, micro_k, sampled)
    eos[0] = free_run[1, 0]
    limits[1] = 1
    want, want_pools = _jax_micro(jcfg, jparams, x, limits, eos, micro_k,
                                  sampled)
    got, got_pools = _port_micro(cfg, params, x, limits, eos, micro_k,
                                 sampled)
    assert got.shape == (micro_k, slots)
    alive = x["active"]
    np.testing.assert_array_equal(got[:, alive], want[:, alive])
    # What each live slot emitted before it retired is its free run.
    stop = int(np.argmax(free_run[:, 0] == eos[0]))
    np.testing.assert_array_equal(got[:stop + 1, 0], free_run[:stop + 1, 0])
    assert got[0, 1] == free_run[0, 1]
    np.testing.assert_array_equal(got[:, 2], free_run[:, 2])
    for g, w in zip(got_pools, want_pools):
        for name in ("k", "v"):
            # Block 0 is the scratch block: masked rows of both write it,
            # in an order neither defines.
            np.testing.assert_allclose(g[name][1:], w[name][1:], rtol=0,
                                       atol=POOL_ATOL)


def test_micro_decode_quantized_needs_its_layouts():
    engine = build_engine("micro", serving={"kv_dtype": "int8"},
                          device="cpu")
    one = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="stacked"):
        tmodel.micro_decode_greedy(
            engine.params, engine.cfg, one, one.to(torch.int32),
            torch.zeros((1, 4), dtype=torch.int32),
            torch.ones(1, dtype=torch.bool), one.to(torch.int32), one - 1,
            engine.pools, micro_k=2)


def _engines(preset, micro_k, kv_dtype, n_blocks):
    knobs = serving_knobs(preset, kv_dtype=kv_dtype)
    if n_blocks:
        knobs["n_blocks"] = n_blocks
    jcfg, jparams = jax_model(preset)
    cfg, params = port_model(jcfg, jparams)
    jax_engine = share_jax_programs(JaxServingEngine(
        jparams, jcfg, JaxServingConfig(**knobs, micro_k=micro_k,
                                        decode_impl="xla"),
        rng=jax.random.PRNGKey(0)))
    ports = [ServingEngine(params, cfg, ServingConfig(**knobs, micro_k=k),
                           rng=R.PRNGKey(0), device=CPU)
             for k in (micro_k, 1)]
    return jax_engine, *ports


def _waves(vocab, bs, small_pool):
    """Greedy and sampled requests with eos and mixed lengths (limits
    shorter and longer than K, prompts longer than a chunk); with the full
    pool, a second wave that shares a multi-block prefix with the first
    and hits one whole prompt (copy-on-write)."""
    rng = np.random.default_rng(11)
    ps = [rng.integers(0, vocab, size=n).astype(np.int32)
          for n in (3 * bs + 2, 9, 2, 2 * bs + 1, 5, bs)]
    if small_pool:
        max_new = 5 * bs
        return [[(ps[0], max_new, {"eos_token": 7}), (ps[1], max_new, {}),
                 (ps[2], max_new, {"temperature": 0.7, "key": [1, 2]}),
                 (ps[3], max_new, {"eos_token": 3})]]
    first = [(ps[0], 7, {"eos_token": 7}),
             (ps[1], 6, {"temperature": 0.9, "top_p": 0.9,
                         "key": [3, 2**32 - 5]}),
             (ps[2], 1, {}), (ps[3], 9, {"temperature": 1.1}),
             (ps[4], 11, {"eos_token": 5}), (ps[5], 3, {})]
    second = [(np.concatenate([ps[0][:2 * bs], ps[4]]), 5, {}),
              (ps[0][:3 * bs], 4, {"temperature": 0.7, "key": [9, 9]})]
    return [first, second]


def _drain(engine, waves):
    for wave in waves:
        for prompt, max_new, kw in wave:
            engine.submit(prompt, max_new, **kw)
        out = engine.drain(max_steps=3000)
    return out


def _pool_bytes(arr) -> np.ndarray:
    """A pool leaf's raw bytes (fp8 codes compared bit for bit)."""
    if isinstance(arr, torch.Tensor):
        arr = (arr.view(torch.uint8) if arr.element_size() == 1
               else arr).numpy()
    arr = np.asarray(arr)
    return arr.view(np.uint8) if arr.dtype.itemsize == 1 else arr


@pytest.mark.parametrize("micro_k,kv_dtype,n_blocks", [
    (2, None, None), (4, None, None), (2, None, 14), (4, None, 14),
    (4, "int8", None), (2, "int8", 14), (2, "fp8", None), (4, "fp8", 14),
    (4, "int4", None), (2, "int4", 14)])
def test_micro_engine_matches_jax_and_k1(micro_k, kv_dtype, n_blocks):
    if kv_dtype == "fp8" and not tc.fp8_supported():
        pytest.skip("float8_e4m3fn is not supported here")
    jax_engine, port, port_k1 = _engines("micro", micro_k, kv_dtype,
                                         n_blocks)
    waves = _waves(port.cfg.vocab_size, port.scfg.block_size,
                   small_pool=bool(n_blocks))
    want = _drain(jax_engine, waves)
    got = _drain(port, waves)
    assert got == want
    assert _drain(port_k1, waves) == got
    js, ps = jax_engine.stats(), port.stats()
    assert {k: js[k] for k in SCHEDULE_KEYS} == \
        {k: ps[k] for k in SCHEDULE_KEYS}
    assert {k: js["prefix_cache"][k] for k in PREFIX_KEYS} == \
        {k: ps["prefix_cache"][k] for k in PREFIX_KEYS}
    assert ps["micro_k"] == micro_k and ps["micro_steps"] > 0
    assert ps["step_graph"]["captures"] == 0        # eager on the CPU
    if n_blocks:
        assert ps["recompute_preemptions"] > 0
    else:
        assert ps["prefix_cache"]["cow_copies"] > 0
    if kv_dtype:
        assert ps["kv_quant"] == js["kv_quant"]
        for jl, pl in zip(jax_engine.pools, port.pools):
            for name in ("k", "v"):
                np.testing.assert_array_equal(_pool_bytes(pl[name]),
                                              _pool_bytes(jl[name]))
            # A scale is a block's amax over its k/v values, which the two
            # frameworks' fp32 projections round apart by an ulp or two.
            for name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(pl[name].numpy(),
                                           np.asarray(jl[name]),
                                           rtol=SCALE_RTOL, atol=0)
    else:
        for jl, pl in zip(jax_engine.pools, port.pools):
            for name in ("k", "v"):
                np.testing.assert_allclose(pl[name].numpy()[1:],
                                           np.asarray(jl[name])[1:], rtol=0,
                                           atol=POOL_ATOL)
    assert port.allocator.referenced == 0


@pytest.mark.parametrize("micro_k", [2, 4])
def test_micro_steps_amortize(micro_k):
    """As the JAX package's ``test_serving_micro.py``: greedy streams with
    eos and mixed lengths equal K = 1's, micro-steps ran, and far fewer of
    them than tokens decoded."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, size=int(rng.integers(3, 12)))
               for _ in range(8)]
    max_new = [int(rng.integers(3, 14)) for _ in range(8)]

    def drain(k):
        engine = build_engine("micro", serving={"micro_k": k}, device="cpu")
        for prompt, n in zip(prompts, max_new):
            engine.submit(prompt, n, eos_token=7)
        return engine.drain(), engine

    ref, _ = drain(1)
    got, engine = drain(micro_k)
    assert got == ref
    decoded = sum(len(t) for t in got.values())
    assert 0 < engine.micro_steps < decoded / 2
    assert engine.stats()["micro_k"] == micro_k
    tpa.reset_launch_counts()


def test_micro_k_validation():
    with pytest.raises(ValueError, match="micro_k"):
        ServingConfig(micro_k=0)
    with pytest.raises(ValueError, match="micro_k"):
        ServingConfig(micro_k=512, max_len=256)
    assert ServingConfig(micro_k=256, max_len=256).micro_k == 256
