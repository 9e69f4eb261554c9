"""The port's quantized KV cache (``tpu_task_torch.ml.serving.cache``)
against the JAX package's, on the CPU.

Codes and scales must be BIT-identical, not close: the port's quantized
engine is held to the JAX engine's streams token for token, and one code a
rounding step apart would change a stream. Inputs are seeded numpy arrays
handed to both packages: blocks at many scales, all-zero blocks (the
epsilon scale), amax ties of both signs, and — for fp8 — blocks whose
``x / scale`` lands just above 448, where torch saturates and JAX would
give NaN past the rounding edge. ``quantized_append`` is compared on random
write layouts with several tokens per block, pad entries and invalid
tokens; the byte accounting on every KV dtype.

JAX's side is compiled, as its serving engine runs it: XLA folds the
scale's ``amax / 127.0`` into a product with the float32 reciprocal, whose
result differs from an eager call's division by an ulp for about half the
blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.serving import cache as jc
from tpu_task_torch.ml.models.transformer import TransformerConfig
from tpu_task_torch.ml.serving import cache as tc
from torch_port_util import port_config

#: JAX's quantizer and quantized write as the engine's programs run them.
_jax_quantize = jax.jit(jc.quantize_blocks, static_argnums=1)
_jax_append = jax.jit(jc.quantized_append, static_argnames="measure_error")

#: (kv_dtype, JAX code dtype, port code dtype)
CODES = [("int8", jnp.int8, torch.int8),
         ("fp8", jnp.float8_e4m3fn, torch.float8_e4m3fn),
         ("int4", jnp.uint8, torch.uint8)]


def _bytes(codes) -> np.ndarray:
    """A code array's raw bytes, from either package."""
    if isinstance(codes, torch.Tensor):
        return codes.view(torch.uint8).numpy()
    return np.asarray(codes).view(np.uint8)


def _skip_without_fp8(kv_dtype):
    if kv_dtype == "fp8" and not (jc.fp8_supported() and tc.fp8_supported()):
        pytest.skip("float8_e4m3fn is not supported by both packages here")


def _blocks(rng, n=48, bs=8, kv=2, d=16):
    """Blocks at scales from 1e-3 to 1e3, two all-zero blocks, and amax
    ties: block 2 holds +m and -m, block 3 the same value twice."""
    x = rng.normal(size=(n, bs, kv, d)) * rng.lognormal(0, 3, (n, 1, kv, 1))
    x = x.astype(np.float32)
    x[0] = 0.0
    x[1, :, 0] = 0.0
    x[2, 0, 0, 0], x[2, 5, 0, 3] = 7.5, -7.5
    x[3, 1, 1, 2] = x[3, 6, 1, 9] = np.abs(x[3, :, 1]).max() * 1.5
    return x


def _above_448(rng, count=6, bs=8, kv=2, d=16):
    """fp8 blocks whose amax element divided by its scale rounds ABOVE
    448 in fp32 (amax / (amax / 448) > 448)."""
    found = []
    while len(found) < count:
        a = np.float32(rng.uniform(0.1, 100.0))
        if a / (a / np.float32(448.0)) > np.float32(448.0):
            found.append(a)
    x = rng.uniform(-1, 1, size=(count, bs, kv, d)).astype(np.float32)
    for i, a in enumerate(found):
        x[i] *= a * 0.99
        x[i, i % bs, i % kv, i % d] = a
    return x


@pytest.mark.parametrize("kv_dtype,jdt,tdt", CODES)
def test_quantize_and_dequantize_are_bit_identical(kv_dtype, jdt, tdt):
    _skip_without_fp8(kv_dtype)
    rng = np.random.default_rng(1)
    x = _blocks(rng)
    if kv_dtype == "fp8":
        x = np.concatenate([x, _above_448(rng)])
    jcodes, jscale = _jax_quantize(jnp.asarray(x), jdt)
    tcodes, tscale = tc.quantize_blocks(torch.tensor(x), tdt)
    assert tcodes.dtype == tdt and tuple(tcodes.shape) == jcodes.shape
    np.testing.assert_array_equal(_bytes(tcodes), _bytes(jcodes))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    assert (tscale[0] == tc.INT8_SCALE_EPS).all()
    np.testing.assert_array_equal(
        tc.dequantize_blocks(tcodes, tscale).numpy(),
        np.asarray(jc.dequantize_blocks(jcodes, jscale)))
    assert (tc.dequantize_blocks(tcodes, tscale)[0] == 0).all()
    if kv_dtype == "fp8":       # the saturating blocks stayed finite, at 448
        top = tcodes[-6:].to(torch.float32).abs().amax()
        assert top == tc.FP8_MAX


@pytest.mark.parametrize("kv_dtype,jdt,tdt", CODES)
def test_scales_follow_the_compiled_division(kv_dtype, jdt, tdt):
    """The scale is ``amax`` times the constant's float32 reciprocal, as
    XLA compiles JAX's ``amax / 127.0``: over 2000 blocks the port's
    scales and codes equal the compiled quantizer's, while an eager call
    (a true division) puts some scales an ulp away, the cause of a code
    one step apart at an fp8 or int4 rounding edge."""
    _skip_without_fp8(kv_dtype)
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2000, 4, 2, 8))
         * rng.lognormal(0, 3, (2000, 1, 2, 1))).astype(np.float32)
    jcodes, jscale = _jax_quantize(jnp.asarray(x), jdt)
    tcodes, tscale = tc.quantize_blocks(torch.tensor(x), tdt)
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(_bytes(tcodes), _bytes(jcodes))
    _, eager = jc.quantize_blocks(jnp.asarray(x), jdt)
    assert (np.asarray(eager) != np.asarray(jscale)).any()
    amax = np.abs(x).max(axis=(1, 3))
    limit = {"int8": 127.0, "fp8": tc.FP8_MAX, "int4": tc.INT4_MAX}[kv_dtype]
    np.testing.assert_array_equal(
        np.asarray(jscale), np.maximum(amax * np.float32(1.0 / limit),
                                       np.float32(tc.INT8_SCALE_EPS)))


def test_int4_pack_unpack_bit_identical():
    rng = np.random.default_rng(2)
    codes = rng.integers(-7, 8, size=(5, 3, 2, 16)).astype(np.int8)
    packed = tc.pack_int4(torch.tensor(codes))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jc.pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(tc.unpack_int4(packed).numpy(), codes)
    raw = rng.integers(0, 256, size=(4, 7, 8)).astype(np.uint8)
    np.testing.assert_array_equal(
        tc.unpack_int4(torch.tensor(raw)).numpy(),
        np.asarray(jc.unpack_int4(jnp.asarray(raw))))
    # -7 wraps to 249 and keeps nibble 9; a zero byte is two zero codes.
    assert tc.pack_int4(torch.tensor([[-7, 0]], dtype=torch.int8)).item() \
        == 9
    assert tc.unpack_int4(torch.zeros(1, dtype=torch.uint8)).tolist() == [0,
                                                                          0]


def _layout(rng, n_blocks, bs, n_tokens):
    """A random quantized write layout: distinct blocks, several tokens in
    most of them at distinct offsets, invalid tokens at the pad entry, and
    pad entries holding the scratch block 0 with filled 0."""
    n_touched = n_tokens + 1
    n_real = int(rng.integers(1, max(2, n_tokens // 2)))
    blocks = rng.choice(np.arange(1, n_blocks), size=n_real, replace=False)
    touched = np.zeros(n_touched, np.int64)
    touched[:n_real] = blocks
    filled = np.zeros(n_touched, np.int64)
    wt = np.full(n_tokens, n_touched - 1, np.int64)
    wo = np.zeros(n_tokens, np.int64)
    used = {i: rng.permutation(bs) for i in range(n_real)}
    for tok in range(n_tokens):
        if rng.random() < 0.2:
            continue                                   # an invalid token
        i = int(rng.integers(0, n_real))
        if not len(used[i]):
            continue
        off, used[i] = int(used[i][0]), used[i][1:]
        wt[tok], wo[tok] = i, off
        filled[i] = max(filled[i], off + 1)
    for i in range(n_real):              # some rows past the last write live
        filled[i] = max(filled[i], int(rng.integers(0, bs + 1)))
    return touched, filled, wt, wo


def _stored_error(before, after, new_k, new_v, layout) -> float:
    """What ``measure_error`` reports, from JAX's pools before and after
    the write: the largest |staged - dequantized| over the live rows. The
    compiled write's own figure is off by an ulp or two at fp8 (its fusion
    rounds the fp8 round trip apart from the codes it stores); the codes
    and scales it stores are the ones held above."""
    touched, filled, wt, wo = layout
    err = 0.0
    for name, new in (("k", new_k), ("v", new_v)):
        staged = np.array(jc.dequantize_blocks(
            before[name][touched], before[name + "_scale"][touched]))
        bs = staged.shape[1]
        flat = staged.reshape(-1, *staged.shape[2:])
        flat[wt * bs + wo] = new
        live = (np.arange(bs)[None, :] < filled[:, None])[..., None, None]
        staged = np.where(live, flat.reshape(staged.shape), 0.0)
        got = np.asarray(jc.dequantize_blocks(after[name][touched],
                                              after[name + "_scale"][touched]))
        err = max(err, float(np.where(live, np.abs(staged - got), 0.0).max()))
    return err


@pytest.mark.parametrize("kv_dtype,jdt,tdt", CODES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantized_append_bit_identical(kv_dtype, jdt, tdt, seed):
    _skip_without_fp8(kv_dtype)
    rng = np.random.default_rng(10 + seed)
    n_blocks, bs, kv, d, n_tok = 12, 4, 2, 8, 9
    values = {name: rng.normal(size=(n_blocks, bs, kv, d)).astype(np.float32)
              for name in ("k", "v")}
    jpool, tpool = {}, {}
    for name, x in values.items():
        codes, scale = _jax_quantize(jnp.asarray(x), jdt)
        jpool[name], jpool[name + "_scale"] = codes, scale
        tcodes, tscale = tc.quantize_blocks(torch.tensor(x), tdt)
        tpool[name], tpool[name + "_scale"] = tcodes, tscale
    new_k = rng.normal(size=(n_tok, kv, d)).astype(np.float32) * 3
    new_v = rng.normal(size=(n_tok, kv, d)).astype(np.float32)
    layout = _layout(rng, n_blocks, bs, n_tok)
    untouched = [b for b in range(n_blocks) if b not in set(layout[0])]
    before = {k: v.clone() for k, v in tpool.items()}
    jout, jerr = _jax_append(
        jpool, jnp.asarray(new_k), jnp.asarray(new_v),
        *[jnp.asarray(a.astype(np.int32)) for a in layout],
        measure_error=True)
    terr = tc.quantized_append(tpool, torch.tensor(new_k),
                               torch.tensor(new_v),
                               *[torch.tensor(a) for a in layout],
                               measure_error=True)
    for name in ("k", "v"):
        np.testing.assert_array_equal(_bytes(tpool[name]),
                                      _bytes(jout[name]))
        np.testing.assert_array_equal(tpool[name + "_scale"].numpy(),
                                      np.asarray(jout[name + "_scale"]))
        # Blocks the step does not touch keep their bytes.
        assert torch.equal(tpool[name][untouched].view(torch.uint8),
                           before[name][untouched].view(torch.uint8))
    assert terr.item() == _stored_error(jpool, jout, new_k, new_v, layout) > 0
    quiet = tc.quantized_append(tpool, torch.tensor(new_k),
                                torch.tensor(new_v),
                                *[torch.tensor(a) for a in layout])
    assert quiet.item() == 0.0


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8", "int4"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_byte_accounting_matches_jax(kv_dtype, dtype):
    jcfg = jtf.TransformerConfig(vocab_size=64, d_model=64, n_layers=3,
                                 n_heads=4, d_head=16, d_ff=128,
                                 n_kv_heads=2, dtype=dtype)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    cfg = port_config(jcfg, tdtype)
    knobs = dict(block_size=8, n_blocks=40, kv_dtype=kv_dtype)
    js = jc.ServingConfig(**knobs)
    ts = tc.ServingConfig(**knobs)
    assert tc.kv_token_bytes(cfg) == jc.kv_token_bytes(jcfg)
    assert tc.kv_token_bytes(cfg, ts) == jc.kv_token_bytes(jcfg, js)
    assert tc.kv_block_bytes(cfg, ts) == jc.kv_block_bytes(jcfg, js)
    assert tc.paged_cache_bytes(cfg, ts, 17) == \
        jc.paged_cache_bytes(jcfg, js, 17)
    for budget in (0, 10_000, 1 << 24):
        assert tc.blocks_in_budget(cfg, ts, budget) == \
            jc.blocks_in_budget(jcfg, js, budget)
    pools = tc.init_pools(cfg, ts, "cpu")
    jpools = jc.init_pools(jcfg, js)
    assert sum(t.numel() * t.element_size() for pool in pools
               for t in pool.values()) == tc.paged_cache_bytes(cfg, ts, 40)
    for pool, jpool in zip(pools, jpools):
        assert sorted(pool) == sorted(jpool)
        for name, t in pool.items():
            assert tuple(t.shape) == jpool[name].shape
            np.testing.assert_array_equal(_bytes(t), _bytes(jpool[name]))


def test_pools_configs_and_block_copy():
    """int4 needs an even head dim; a fresh quantized pool reads as zeros;
    a COW block copy carries the scales with the codes; a bad kv_dtype
    raises as JAX's does."""
    cfg = TransformerConfig(vocab_size=64, d_model=30, n_layers=1,
                               n_heads=2, d_head=15, d_ff=32)
    with pytest.raises(ValueError, match="even d_head"):
        tc.init_pools(cfg, tc.ServingConfig(kv_dtype="int4"), "cpu")
    with pytest.raises(ValueError, match="kv_dtype must be"):
        tc.ServingConfig(kv_dtype="int2")
    with pytest.raises(ValueError, match="kv_dtype must be"):
        jc.ServingConfig(kv_dtype="int2")
    assert tc.kv_code_dtype("int4") == torch.uint8
    with pytest.raises(ValueError, match="not a quantized"):
        tc.kv_code_dtype("bf16")
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                               n_heads=4, d_head=8, d_ff=32, n_kv_heads=2)
    for kv_dtype in tc.QUANT_DTYPES:
        if kv_dtype == "fp8" and not tc.fp8_supported():
            continue
        pools = tc.init_pools(cfg, tc.ServingConfig(kv_dtype=kv_dtype,
                                                    n_blocks=6,
                                                    block_size=4), "cpu")
        layer = pools[1]
        assert (tc.dequantize_blocks(layer["k"], layer["k_scale"]) == 0).all()
        vals = torch.randn(1, 4, 2, 8)
        codes, scale = tc.quantize_blocks(vals, layer["k"].dtype)
        layer["k"][3], layer["k_scale"][3] = codes[0], scale[0]
        tc.copy_block(pools, 3, 5)
        assert torch.equal(layer["k"][5].view(torch.uint8),
                           layer["k"][3].view(torch.uint8))
        assert torch.equal(layer["k_scale"][5], scale[0])
        assert torch.equal(layer["v_scale"][5], layer["v_scale"][3])
