"""The port's paged attention over quantized pools against the JAX
package's, at fp32 on the CPU.

The port's plain version, given the same int8, fp8 or int4 codes and
scales, is held to JAX's XLA reference (``paged_reference_attention`` with
scales) and to JAX's Pallas kernel in interpret mode
(``paged_decode_attention``, which dequantizes in register as the CUDA
kernels do) within ATOL, the accumulation-order pin of
``tests/test_paged_attention.py``: the same values summed in another order.
On CPU tensors both kernel wrappers take the plain version; the kernels'
argument checks, which run before any launch, are exercised here on CPU
tensors. The kernels themselves run only on the card
(``test_torch_cuda_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.ops import paged_attention as jpa
from tpu_task.ml.serving import cache as jc
from tpu_task_torch.ml.ops import paged_attention as tpa
from tpu_task_torch.ml.serving import cache as tc

ATOL = 2e-5

#: (kv_dtype, JAX code dtype, port code dtype)
CODES = [("int8", jnp.int8, torch.int8),
         ("fp8", jnp.float8_e4m3fn, torch.float8_e4m3fn),
         ("int4", jnp.uint8, torch.uint8)]


def _case(rng, slots=4, w=1, h=4, kv=2, d=16, n_blocks=32, bs=8,
          max_blocks=5):
    """Fragmented tables, two slots sharing their first block, scratch
    tails, per-row depths that stop mid-block, a fresh slot at 0; pool
    values at a different scale per block."""
    q = rng.normal(size=(slots, w, h, d)).astype(np.float32)
    spread = rng.lognormal(0, 1, (n_blocks, 1, kv, 1))
    kp = (rng.normal(size=(n_blocks, bs, kv, d)) * spread).astype(np.float32)
    vp = (rng.normal(size=(n_blocks, bs, kv, d)) * spread).astype(np.float32)
    tables = np.zeros((slots, max_blocks), np.int32)
    perm = rng.permutation(np.arange(1, n_blocks))
    pos = np.zeros((slots, w), np.int32)
    used = 0
    for s in range(slots):
        depth = int(rng.integers(1, max_blocks * bs - w))
        n_full = (depth + w - 1) // bs + 1
        tables[s, :n_full] = perm[used:used + n_full]
        used += n_full
        pos[s] = depth + np.arange(w)
    tables[1, 0] = tables[0, 0]
    pos[-1, :] = np.arange(w)
    return q, kp, vp, tables, pos


def _quantized(kp, vp, jdt, tdt):
    """The same codes and scales for both packages (the port's codes are
    JAX's bytes, which ``test_torch_kv_quant`` holds bit-identical)."""
    jk, jks = jc.quantize_blocks(jnp.asarray(kp), jdt)
    jv, jvs = jc.quantize_blocks(jnp.asarray(vp), jdt)

    def port(codes):
        raw = torch.tensor(np.asarray(codes).view(np.uint8))
        return raw.view(tdt)

    return ((jk, jv, jks, jvs),
            (port(jk), port(jv), torch.tensor(np.asarray(jks)),
             torch.tensor(np.asarray(jvs))))


@pytest.mark.parametrize("kv_dtype,jdt,tdt", CODES)
@pytest.mark.parametrize("w", [1, 3])
def test_plain_matches_jax_on_quantized_pools(kv_dtype, jdt, tdt, w):
    if kv_dtype == "fp8" and not (jc.fp8_supported() and tc.fp8_supported()):
        pytest.skip("float8_e4m3fn is not supported by both packages here")
    rng = np.random.default_rng(3 + w)
    q, kp, vp, tables, pos = _case(rng, w=w)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _quantized(kp, vp, jdt, tdt)
    jq, jt, jp = jnp.asarray(q), jnp.asarray(tables), jnp.asarray(pos)
    got = tpa.paged_reference_attention(
        torch.tensor(q), tk, tv, torch.tensor(tables), torch.tensor(pos),
        tks, tvs).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jpa.paged_reference_attention(jq, jk, jv, jt, jp,
                                                      jks, jvs)),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jpa.paged_decode_attention(jq, jk, jv, jt, jp, jks,
                                                   jvs, interpret=True)),
        atol=ATOL, rtol=0)
    # The dequantized view itself is JAX's, bit for bit.
    view = tpa.dequantize_view(
        tc.gather_kv(tc.flat_pool(tk.view(torch.uint8)),
                     torch.tensor(tables), 8).view(tdt),
        tks, torch.tensor(tables), 8, torch.float32)
    jview = jpa.dequantize_view(jc.gather_kv(jc.flat_pool(jk), jt, 8), jks,
                                jt, 8, jnp.float32)
    np.testing.assert_array_equal(view.numpy(), np.asarray(jview))


@pytest.mark.parametrize("impl", ["pipelined", "cuda", "reference"])
@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_dispatch_on_cpu_runs_the_plain_version(impl, kv_dtype):
    """On CPU tensors every impl computes the plain version and counts it
    there; neither kernel's counter moves off the card."""
    rng = np.random.default_rng(5)
    q, kp, vp, tables, pos = _case(rng, w=1)
    args = [torch.tensor(q), torch.tensor(kp), torch.tensor(vp)]
    scales = ()
    if kv_dtype:
        code = tc.kv_code_dtype(kv_dtype)
        (args[1], ks), (args[2], vs) = (tc.quantize_blocks(a, code)
                                        for a in args[1:])
        scales = (ks, vs)
    tpa.reset_launch_counts()
    got = tpa.paged_attention(*args, torch.tensor(tables),
                              torch.tensor(pos[:, 0]), *scales, impl=impl)
    assert tpa.paged_decode_attention.launches == 0
    assert tpa.paged_decode_pipelined_attention.launches == 0
    assert tpa.paged_reference_attention.launches == 1
    want = tpa.paged_reference_attention(*args, torch.tensor(tables),
                                         torch.tensor(pos), *scales)
    assert torch.equal(got, want)


def test_kernel_argument_checks():
    """What the kernels do not take raises before any launch: mixed q and
    pool types, one scale without the other, scales with a model-dtype
    pool or of the wrong shape or type, an odd head dim for int4, and (for
    the pipelined kernel) pool rows that are not whole 4-byte words."""
    rng = np.random.default_rng(6)
    q, kp, vp, tables, pos = (torch.tensor(a) for a in _case(rng, w=1))
    codes = [tc.quantize_blocks(a, torch.int8) for a in (kp, vp)]
    (k8, ks), (v8, vs) = codes
    check = tpa._check_kernel_args

    def raises(match, *args, pipelined=False):
        with pytest.raises(ValueError, match=match):
            check(*args, pipelined=pipelined)

    check(q, kp, vp, tables, pos, None, None, pipelined=True)
    check(q, k8, v8, tables, pos, ks, vs, pipelined=True)
    check(q.bfloat16(), k8, v8, tables, pos, ks, vs, pipelined=False)
    raises("q's one type", q, kp.bfloat16(), vp.bfloat16(), tables, pos,
           None, None)
    raises("share one storage type", q, k8, vp, tables, pos, ks, vs)
    raises("fp32 or bf16", q.half(), k8, v8, tables, pos, ks, vs)
    raises("both k_scale and v_scale", q, k8, v8, tables, pos, ks, None)
    raises("needs k_scale", q, k8, v8, tables, pos, None, None)
    raises("takes none", q, kp, vp, tables, pos, ks, vs)
    raises("float32 of shape", q, k8, v8, tables, pos, ks.double(), vs)
    raises("float32 of shape", q, k8, v8, tables, pos, ks[:-1], vs[:-1])
    raises("int32", q, k8, v8, tables.long(), pos, ks, vs)
    raises("contiguous", q, k8, v8, tables.t().contiguous().t(), pos, ks, vs)
    # int4: d/2 bytes per row, d even.
    k4 = torch.zeros((32, 8, 2, 7), dtype=torch.uint8)
    q7 = torch.zeros((4, 1, 4, 7))
    raises("even head dim", q7, k4, k4, tables, pos, ks, vs)
    # A 2-byte int4 row (d 4) is too small for the pipelined kernel's
    # 4-byte copies; the tile kernel reads it byte by byte.
    k4 = torch.zeros((32, 8, 2, 2), dtype=torch.uint8)
    q4 = torch.zeros((4, 1, 4, 4))
    check(q4, k4, k4, tables, pos, ks, vs, pipelined=False)
    raises("4-byte units", q4, k4, k4, tables, pos, ks, vs, pipelined=True)
