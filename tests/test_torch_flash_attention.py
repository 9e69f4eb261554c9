"""The port's flash-attention path (``tpu_task_torch.ml.ops.attention``)
against the JAX package's, at fp32 on the CPU, from the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do; the port's wrappers take their plain versions on a CPU tensor. Forward
o and lse are held to 2e-5 and the backward's dq, dk, dv to 5e-5: JAX's
own pins for these kernels (``tests/test_ops_attention.py``), fp32 sums in
another order. Rows that see no key must be exactly 0 with lse -1e30, in
both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.ops import attention as ja
from tpu_task_torch.ml.ops import attention as ta

FWD_ATOL = 2e-5
BWD_ATOL = 5e-5

#: (causal, sq, sk, q_offset): self-attention, sq < sk with the default
#: offset, q_offset 0 with sq != sk (ring attention's off-diagonal block),
#: a negative offset that leaves the first 32 rows with no visible key, and
#: a non-causal cross-length pair.
CASES = [(True, 128, 128, None), (True, 64, 128, None), (True, 64, 128, 0),
         (True, 128, 64, -32), (False, 64, 128, None), (False, 128, 128, 5)]


def _arrays(seed, b=2, sq=128, sk=128, h=2, d=32):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(b, sq, h, d), f(b, sk, h, d), f(b, sk, h, d), f(b, sq, h, d)


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _close(port, ref, atol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=atol)


def _jax_fwd(q, k, v, causal, q_offset):
    return ja.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
        q_offset=q_offset, block_q=32, block_k=32, interpret=True,
        return_lse=True)


@pytest.mark.parametrize("causal,sq,sk,q_offset", CASES)
def test_forward_matches_jax_kernel(causal, sq, sk, q_offset):
    q, k, v, _ = _arrays(1, sq=sq, sk=sk)
    ref_o, ref_lse = _jax_fwd(q, k, v, causal, q_offset)
    o, lse = ta.flash_attention(*_t(q, k, v), causal, q_offset=q_offset,
                                return_lse=True)
    assert o.dtype == torch.float32 and lse.shape == (2, 2, sq)
    _close(o, ref_o, FWD_ATOL)
    _close(lse, ref_lse, FWD_ATOL)
    if q_offset is not None and q_offset < 0:
        hidden = -q_offset                     # rows that see no key
        assert torch.equal(o[:, :hidden], torch.zeros_like(o[:, :hidden]))
        assert (lse[:, :, :hidden] == ta.NEG_INF).all()
        assert (np.asarray(ref_lse)[:, :, :hidden] == ja.NEG_INF).all()


@pytest.mark.parametrize("causal,sq,sk,q_offset", CASES)
def test_backward_matches_jax_kernels(causal, sq, sk, q_offset):
    q, k, v, do = _arrays(2, sq=sq, sk=sk)
    ref_o, ref_lse = _jax_fwd(q, k, v, causal, q_offset)
    ref = ja.flash_attention_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ref_o, ref_lse,
        jnp.asarray(do), causal, q_offset=q_offset, block_q=32, block_k=32,
        interpret=True)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = ta.flash_attention(tq, tk, tv, causal, q_offset=q_offset,
                                return_lse=True)
    got = ta.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal,
                                 q_offset=q_offset)
    for g, r in zip(got, ref):
        _close(g, r, BWD_ATOL)
    # The split wrappers give the same as the combined call.
    delta = (tdo * o).sum(-1).transpose(1, 2).contiguous()
    dq = ta.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, causal,
                         q_offset=q_offset)
    dk, dv = ta.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, causal,
                              q_offset=q_offset)
    for a, b in zip((dq, dk, dv), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
def test_block_primitives_match_jax(causal):
    q, k, v, do = _arrays(3, sq=64, sk=128)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    ref_o, ref_lse = ja.block_attention_fwd(jq, jk, jv, causal, q_offset=0)
    delta = np.random.default_rng(4).normal(size=(2, 2, 64)).astype(
        np.float32)
    ref_g = ja.block_attention_bwd(jq, jk, jv, jdo, ref_lse,
                                   jnp.asarray(delta), causal, q_offset=0)
    for impl in ta.IMPLS:
        o, lse = ta.block_attention_fwd(*_t(q, k, v), causal, q_offset=0,
                                        impl=impl)
        _close(o, ref_o, FWD_ATOL)
        _close(lse, ref_lse, FWD_ATOL)
        grads = ta.block_attention_bwd(*_t(q, k, v, do), lse,
                                       torch.tensor(delta), causal,
                                       q_offset=0, impl=impl)
        for g, r in zip(grads, ref_g):
            _close(g, r, BWD_ATOL)
    with pytest.raises(ValueError, match="impl"):
        ta.block_attention_fwd(*_t(q, k, v), causal, impl="pallas")


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_dot_product_attention_gradients_match_jax(kv_heads):
    """The port's FlashAttention Function against ``jax.vjp`` of the JAX
    custom-VJP kernel pair over expanded kv heads; GQA's kv gradients sum
    over each query group on both sides."""
    rng = np.random.default_rng(5)
    b, s, h, d = 2, 128, 4, 16
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv_heads, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv_heads, d)).astype(np.float32)
    g = rng.normal(size=(b, s, h, d)).astype(np.float32)

    def jfn(q, k, v):
        return ja._pallas_attention(q, ja.expand_kv_heads(k, h),
                                    ja.expand_kv_heads(v, h), True, True)

    ref_out, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    ta.reset_launch_counts()
    out = ta.dot_product_attention(tq, ta.expand_kv_heads(tk, h),
                                   ta.expand_kv_heads(tv, h), True)
    out.backward(torch.tensor(g))
    assert ta.flash_attention_reference.launches == 1
    assert ta.flash_bwd_reference.launches == 1
    assert ta.mha_reference.launches == 0
    _close(out, ref_out, FWD_ATOL)
    for t, r in zip((tq, tk, tv), ref_grads):
        _close(t.grad, r, BWD_ATOL)


def test_reduce_kv_heads_matches_jax():
    x = np.random.default_rng(6).normal(size=(2, 5, 8, 4)).astype(np.float32)
    for kv in (8, 4, 2, 1):
        _close(ta.reduce_kv_heads(torch.tensor(x), kv),
               ja.reduce_kv_heads(jnp.asarray(x), kv), 1e-6)


@pytest.mark.parametrize("sq,sk,causal,ok", [
    (128, 128, True, True), (128, 256, True, True), (256, 128, True, False),
    (256, 128, False, True), (100, 128, True, False), (128, 200, False, False),
])
def test_routing_rule_is_the_jax_packages(sq, sk, causal, ok):
    q = torch.zeros((1, sq, 1, 8))
    k = torch.zeros((1, sk, 1, 8))
    assert ta._pallas_ok(q, k, causal) is ok
    assert ja._pallas_ok(jnp.zeros((1, sq, 1, 8)), jnp.zeros((1, sk, 1, 8)),
                         causal) is ok


def test_unadmitted_shape_takes_checkpointed_reference():
    """A length the rule rejects runs mha_reference (under checkpointing);
    its gradients equal JAX's autodiff of the same reference."""
    q, k, v, g = _arrays(7, sq=100, sk=100)

    def jfn(q, k, v):
        return ja.mha_reference(q, k, v, True)

    ref_out, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    ta.reset_launch_counts()
    out = ta.dot_product_attention(tq, tk, tv, True)
    out.backward(torch.tensor(g))
    assert ta.flash_attention_reference.launches == 0
    assert ta.mha_reference.launches == 2        # forward, then recompute
    _close(out, ref_out, FWD_ATOL)
    for t, r in zip((tq, tk, tv), ref_grads):
        _close(t.grad, r, BWD_ATOL)


def test_wrapper_checks_refuse_what_the_kernels_do_not_take():
    q, k, v, do = _t(*_arrays(8, sq=64, sk=64))
    lse = torch.zeros((2, 2, 64))
    ta.check_flash_args(q, k, v, do, lse, lse)           # what they take
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ta.check_flash_args(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="one type"):
        ta.check_flash_args(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head dim"):
        ta.check_flash_args(q[..., :12], k[..., :12], v[..., :12])
    wide = torch.zeros((1, 64, 1, 136))
    with pytest.raises(ValueError, match="head dim"):
        ta.check_flash_args(wide, wide, wide)
    with pytest.raises(ValueError, match="expand"):
        ta.check_flash_args(q, k[:, :, :1], v[:, :, :1])
    with pytest.raises(ValueError, match="contiguous"):
        ta.check_flash_args(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2))
    with pytest.raises(ValueError, match="lse"):
        ta.check_flash_args(q, k, v, do, lse.double(), lse)
    with pytest.raises(ValueError, match="delta"):
        ta.check_flash_args(q, k, v, do, lse, lse[:, :, :32])
    with pytest.raises(ValueError, match="do must be like q"):
        ta.check_flash_args(q, k, v, do.bfloat16(), lse, lse)
    # A tensor on neither the CPU nor CUDA has no kernel and no fallback.
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no flash forward kernel"):
        ta.flash_attention(meta, meta, meta, True)
    with pytest.raises(ValueError, match="no flash dq kernel"):
        ta.flash_bwd_dq(meta, meta, meta, meta, lse.to("meta"),
                        lse.to("meta"), True)
