"""Ring attention: exact attention over a sequence cut into chunks across
the ranks of one mesh axis — the counterpart of
``tpu_task/ml/parallel/ring_attention.py``.

Each rank holds one q chunk and passes k/v chunks around the ring with
:func:`~tpu_task_torch.ml.parallel.collectives.ppermute`, folding each
block's (output, logsumexp) pair into a running softmax (:func:`_fold`).
Every block goes through ``ops.attention``'s block primitives: the flash
kernels on a CUDA tensor (``impl="cuda"``), the plain versions on the CPU
(``"reference"``); the default comes from the tensor's device, as JAX's
comes from the backend. The backward is an autograd Function that runs
the ring again: dk/dv accumulators ride one hop behind their k/v chunks,
each block's backward is fed the global lse and delta, and one last hop
brings every accumulator home.

Grouped-query k/v cross the ring at kv-head width and are expanded right
before each block; each block's dk/dv is summed back to kv-head width
(``reduce_kv_heads``) before it joins the ring, so the wire stays narrow
both ways. k and v travel as one stacked tensor, one ``ppermute`` a hop
(JAX's two), and a hop whose chunk no block would use is not made.

JAX's ``lax.cond`` on the source chunk's index is a Python branch on the
rank's own index here; every rank still makes the same ppermute calls in
the same order. The uniform ring skips a causal future chunk's block
outright where JAX computes it and folds it at weight 0 (the fold of a
NEG_INF lse is the identity, bit for bit), so its ranks launch different
numbers of blocks; the zigzag ring's ranks launch the same.

Layouts: :func:`ring_attention_shard` and :func:`zigzag_ring_attention_shard`
take the rank's local arrays (the zigzag one in zigzag layout: stripes i
and 2P-1-i); :func:`ring_attention` and :func:`zigzag_ring_attention` take
the rank's contiguous chunk of the sequence, the layout JAX's
``activation_spec`` gives (rank i holds stripes 2i and 2i+1), and the
zigzag one re-lays q, k and v into stripes and the output back with one
uneven all_to_all each way (:func:`_relayout`; its backward the reverse
exchange). The batch dim is the rank's own rows already: ``batch_axes``
asks for nothing more here and is kept for JAX's signature."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from tpu_task_torch.ml.ops.attention import (
    NEG_INF,
    block_attention_bwd,
    block_attention_fwd,
    expand_kv_heads,
    reduce_kv_heads,
)
from tpu_task_torch.ml.parallel import collectives
from tpu_task_torch.ml.parallel.sharding import mesh_axis_size


def _fold(o, lse, o_b, lse_b):
    """Combine two (output, logsumexp) pairs of the same q rows: JAX's
    ``_fold`` in float32. o/o_b (b, sq, h, d); lse/lse_b (b, h, sq).
    All-masked rows carry lse == NEG_INF and zero output; folding them is
    a no-op."""
    m = torch.maximum(lse, lse_b)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    w1 = torch.exp(lse - m_safe)
    w2 = torch.exp(lse_b - m_safe)
    denom = w1 + w2
    denom_safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)

    def to_o(w):
        return (w / denom_safe).transpose(1, 2)[..., None]

    o_new = o * to_o(w1) + o_b.to(torch.float32) * to_o(w2)
    lse_new = torch.where(denom == 0.0, torch.full_like(denom, NEG_INF),
                          m_safe + torch.log(denom_safe))
    return o_new, lse_new


def _pad_rows(o_half, lse_half, c: int):
    """Extend an (o, lse) pair covering the SECOND stripe to all 2c rows
    (first stripe: zero output, NEG_INF lse — a no-op under folding)."""
    b, _, h, d = o_half.shape
    o_full = torch.cat([o_half.new_zeros((b, c, h, d)), o_half], dim=1)
    lse_full = torch.cat(
        [torch.full((b, h, c), NEG_INF, dtype=lse_half.dtype,
                    device=lse_half.device), lse_half], dim=2)
    return o_full, lse_full


def _default_impl(q: torch.Tensor) -> str:
    return "cuda" if q.is_cuda else "reference"


def _block_fwd(q, k, v, causal: bool, impl: str):
    """(o, lse) of one block pair at q_offset 0, narrow k/v expanded to
    q's heads; every operand made contiguous, as the kernels take them."""
    heads = q.shape[2]
    return block_attention_fwd(
        q.contiguous(), expand_kv_heads(k, heads).contiguous(),
        expand_kv_heads(v, heads).contiguous(), causal, q_offset=0,
        impl=impl)


def _block_bwd(q, k, v, do, lse, delta, causal: bool, impl: str):
    """(dq, dk, dv) of one block pair given the global lse and delta;
    dk/dv summed back to k's kv-head width."""
    heads, kv_heads = q.shape[2], k.shape[2]
    dq, dk, dv = block_attention_bwd(
        q.contiguous(), expand_kv_heads(k, heads).contiguous(),
        expand_kv_heads(v, heads).contiguous(), do.contiguous(),
        lse.contiguous(), delta.contiguous(), causal, q_offset=0, impl=impl)
    return dq, reduce_kv_heads(dk, kv_heads), reduce_kv_heads(dv, kv_heads)


def _delta(o, do):
    """rowsum(dO * O) as (b, h, sq) float32."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


# -- the uniform ring ------------------------------------------------------------

def _ring_fwd_impl(q, k, v, mesh, axis: str, causal: bool, impl: str):
    n, i = mesh_axis_size(mesh, axis), mesh.axis_index(axis)
    o, lse = _block_fwd(q, k, v, causal, impl)
    o = o.to(torch.float32)
    kv = torch.stack([k, v])
    for step in range(1, n):
        kv = collectives.ppermute(mesh, kv, axis)
        if causal and (i - step) % n > i:
            continue                       # a future chunk: weight 0
        o, lse = _fold(o, lse, *_block_fwd(q, kv[0], kv[1], False, impl))
    return o.to(q.dtype), lse


def _ring_bwd_impl(q, k, v, o, lse, do, mesh, axis: str, causal: bool,
                   impl: str):
    n, i = mesh_axis_size(mesh, axis), mesh.axis_index(axis)
    delta = _delta(o, do)
    dq, dk, dv = _block_bwd(q, k, v, do, lse, delta, causal, impl)
    dq = dq.to(torch.float32)
    dkv = torch.stack([dk, dv]).to(torch.float32)
    kv = torch.stack([k, v])
    for step in range(1, n):
        kv = collectives.ppermute(mesh, kv, axis)
        # The accumulator of the chunk this step computes, from the rank
        # that computed it last.
        dkv = collectives.ppermute(mesh, dkv, axis)
        if causal and (i - step) % n > i:
            continue
        dq_b, dk_b, dv_b = _block_bwd(q, kv[0], kv[1], do, lse, delta,
                                      False, impl)
        dq = dq + dq_b.to(torch.float32)
        dkv = dkv + torch.stack([dk_b, dv_b]).to(torch.float32)
    # The accumulator of chunk j now sits at rank j - 1: one hop home.
    dkv = collectives.ppermute(mesh, dkv, axis)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, impl):
        o, lse = _ring_fwd_impl(q, k, v, mesh, axis, causal, impl)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (mesh, axis, causal, impl)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*_ring_bwd_impl(q, k, v, o, lse, do, *ctx.args),
                None, None, None, None)


# -- the zigzag (balanced causal) ring -------------------------------------------
#
# The sequence is split into 2P stripes and rank i holds the pair [stripe
# i, stripe 2P-1-i]. For a remote source s exactly half the (2 q-stripes x
# 2 k-stripes) rectangle is causally live: s < i, both q stripes attend
# k's first stripe; s > i, only the second q stripe attends, to both k
# stripes. Every rank does the same work each step and nothing is
# discarded.

def zigzag_permute(x: torch.Tensor, devices: int,
                   axis: int = 1) -> torch.Tensor:
    """Global → zigzag layout: stripe order [0, 2P-1, 1, 2P-2, ...] so a
    contiguous 1/P shard holds stripes (i, 2P-1-i)."""
    parts = _stripes(x, devices, axis)
    return torch.cat([parts[j] for j in _zigzag_order(devices)], dim=axis)


def zigzag_unpermute(x: torch.Tensor, devices: int,
                     axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`zigzag_permute`."""
    parts = _stripes(x, devices, axis)
    inverse = [0] * (2 * devices)
    for position, stripe in enumerate(_zigzag_order(devices)):
        inverse[stripe] = position
    return torch.cat([parts[j] for j in inverse], dim=axis)


def _zigzag_order(devices: int) -> List[int]:
    order = []
    for index in range(devices):
        order += [index, 2 * devices - 1 - index]
    return order


def _stripes(x: torch.Tensor, devices: int, axis: int):
    stripes, length = 2 * devices, x.shape[axis]
    if length % stripes:
        raise ValueError(f"sequence {length} not divisible by 2P={stripes}")
    return x.split(length // stripes, dim=axis)


def _zigzag_fwd_impl(q, k, v, mesh, axis: str, impl: str):
    n, i = mesh_axis_size(mesh, axis), mesh.axis_index(axis)
    c = q.shape[1] // 2
    # The diagonal, two causally tight blocks: every row against k's
    # first stripe (causal for the first c rows, whole for the second
    # stripe's), then the second stripe against k's second, causal.
    o, lse = _block_fwd(q, k[:, :c], v[:, :c], True, impl)
    o = o.to(torch.float32)
    o, lse = _fold(o, lse, *_pad_rows(
        *_block_fwd(q[:, c:], k[:, c:], v[:, c:], True, impl), c))
    kv = torch.stack([k, v])
    for step in range(1, n):
        kv = collectives.ppermute(mesh, kv, axis)
        if (i - step) % n < i:     # from the past: every row x k stripe 1
            o_b, lse_b = _block_fwd(q, kv[0][:, :c], kv[1][:, :c], False,
                                    impl)
        else:                      # from the future: q stripe 2 x all of k
            o_b, lse_b = _pad_rows(*_block_fwd(q[:, c:], kv[0], kv[1],
                                               False, impl), c)
        o, lse = _fold(o, lse, o_b, lse_b)
    return o.to(q.dtype), lse


def _zigzag_bwd_impl(q, k, v, o, lse, do, mesh, axis: str, impl: str):
    n, i = mesh_axis_size(mesh, axis), mesh.axis_index(axis)
    c = q.shape[1] // 2
    f32 = torch.float32
    delta = _delta(o, do)
    q2, do2 = q[:, c:], do[:, c:]
    lse2, delta2 = lse[:, :, c:], delta[:, :, c:]
    dq_a, dk1, dv1 = _block_bwd(q, k[:, :c], v[:, :c], do, lse, delta, True,
                                impl)
    dq = dq_a.to(f32)
    dq2, dk2, dv2 = _block_bwd(q2, k[:, c:], v[:, c:], do2, lse2, delta2,
                               True, impl)
    dq[:, c:] += dq2.to(f32)
    dkv = torch.stack([torch.cat([dk1, dk2], dim=1),
                       torch.cat([dv1, dv2], dim=1)]).to(f32)
    kv = torch.stack([k, v])
    for step in range(1, n):
        kv = collectives.ppermute(mesh, kv, axis)
        dkv = collectives.ppermute(mesh, dkv, axis)
        if (i - step) % n < i:
            dq_b, dk_h, dv_h = _block_bwd(q, kv[0][:, :c], kv[1][:, :c], do,
                                          lse, delta, False, impl)
            dq += dq_b.to(f32)
            dkv[:, :, :c] += torch.stack([dk_h, dv_h]).to(f32)
        else:
            dq_h, dk_b, dv_b = _block_bwd(q2, kv[0], kv[1], do2, lse2,
                                          delta2, False, impl)
            dq[:, c:] += dq_h.to(f32)
            dkv += torch.stack([dk_b, dv_b]).to(f32)
    dkv = collectives.ppermute(mesh, dkv, axis)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _Zigzag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, impl):
        o, lse = _zigzag_fwd_impl(q, k, v, mesh, axis, impl)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (mesh, axis, impl)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*_zigzag_bwd_impl(q, k, v, o, lse, do, *ctx.args),
                None, None, None)


def _stripe_routes(n: int, i: int, to_zigzag: bool):
    """Where this rank's two stripes go and where its two new ones come
    from, between the contiguous layout (rank r holds stripes 2r, 2r+1)
    and the zigzag one (rank r holds r, 2P-1-r): ``[(dst, stripe, local
    piece)]`` sorted by destination, ``[(src, stripe, new piece)]`` sorted
    by source, each pair's stripes in ascending order on both sides."""
    def contiguous(s):
        return s // 2, s % 2

    def zigzag(s):
        return (s, 0) if s < n else (2 * n - 1 - s, 1)

    here, there = (contiguous, zigzag) if to_zigzag else (zigzag, contiguous)
    sends = sorted((there(s)[0], s, here(s)[1]) for s in range(2 * n)
                   if here(s)[0] == i)
    recvs = sorted((here(s)[0], s, there(s)[1]) for s in range(2 * n)
                   if there(s)[0] == i)
    return sends, recvs


def _relayout(tensors: Sequence[torch.Tensor], mesh, axis: str,
              to_zigzag: bool) -> List[torch.Tensor]:
    """Each (b, 2c, ...) tensor moved between the contiguous and the zigzag
    stripe layout over ``axis``: one uneven all_to_all for all of them
    (:func:`collectives.exchange`), with its gradient."""
    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return list(tensors)
    sends, recvs = _stripe_routes(n, mesh.axis_index(axis), to_zigzag)
    pieces, incoming, where = [], [], []
    for dst in sorted({d for d, _, _ in sends}):
        for t in tensors:
            c = t.shape[1] // 2
            pieces += [(dst, t[:, p * c:(p + 1) * c]) for d, _, p in sends
                       if d == dst]
    for src in sorted({s for s, _, _ in recvs}):
        for j, t in enumerate(tensors):
            shape = (t.shape[0], t.shape[1] // 2) + tuple(t.shape[2:])
            for s, _, p in recvs:
                if s == src:
                    incoming.append((src, shape))
                    where.append((j, p))
    got = collectives.exchange(mesh, pieces, axis, incoming)
    parts = [[None, None] for _ in tensors]
    for (j, p), t in zip(where, got):
        parts[j][p] = t
    return [torch.cat(pair, dim=1) for pair in parts]


# -- the public functions ----------------------------------------------------------

def ring_attention_shard(q, k, v, mesh, axis_name: str = "sp",
                         causal: bool = True, impl: Optional[str] = None):
    """The uniform ring on this rank's chunks: q (b, chunk, heads, d), k/v
    (b, chunk, kv_heads, d), chunk j of the sequence on rank j of
    ``axis_name``. Differentiable: the backward re-runs the ring."""
    return _Ring.apply(q, k, v, mesh, axis_name, causal,
                       impl or _default_impl(q))


def ring_attention(q, k, v, mesh, axis_name: str = "sp", causal: bool = True,
                   impl: Optional[str] = None, batch_axes=None):
    """Ring attention on this rank's contiguous chunk of the sequence:
    :func:`ring_attention_shard`, whose layout that is."""
    return ring_attention_shard(q, k, v, mesh, axis_name, causal, impl)


def zigzag_ring_attention_shard(q, k, v, mesh, axis_name: str = "sp",
                                impl: Optional[str] = None):
    """The balanced causal ring on this rank's arrays in zigzag layout:
    [stripe i ; stripe 2P-1-i] (:func:`zigzag_permute`'s shard)."""
    return _Zigzag.apply(q, k, v, mesh, axis_name, impl or _default_impl(q))


def zigzag_ring_attention(q, k, v, mesh, axis_name: str = "sp",
                          impl: Optional[str] = None, batch_axes=None):
    """Exact causal attention at about half the uniform ring's block work,
    on this rank's contiguous chunk of the sequence (always causal): q, k
    and v re-laid into zigzag stripes over ``axis_name``, the balanced
    ring, the output put back. The chunk must hold two whole stripes."""
    n = mesh_axis_size(mesh, axis_name)
    if q.shape[1] % 2:
        raise ValueError(f"sequence {q.shape[1] * n} not divisible by "
                         f"2P={2 * n}")
    qz, kz, vz = _relayout((q, k, v), mesh, axis_name, True)
    o = zigzag_ring_attention_shard(qz, kz, vz, mesh, axis_name, impl)
    return _relayout((o,), mesh, axis_name, False)[0]


__all__ = ["ring_attention", "ring_attention_shard", "zigzag_permute",
           "zigzag_ring_attention", "zigzag_ring_attention_shard",
           "zigzag_unpermute"]
