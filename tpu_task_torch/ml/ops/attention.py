"""Plain attention cores in torch — the counterparts of
``tpu_task/ml/ops/attention.py``'s ``expand_kv_heads``,
``gqa_cached_attention`` and ``mha_reference``.

The flash kernels of that module (forward and the dq / dk-dv backward)
serve training and ring attention, not the serving path, and are ported
with the training slice (ROADMAP B1–B3). Shapes follow (batch, seq, heads,
head_dim) throughout, as in the JAX package."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def expand_kv_heads(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, s, kv_heads, d) → (b, s, n_heads, d): repeat each kv head over
    its contiguous query group (head ``h`` reads kv head ``h // group``)."""
    group = n_heads // kv.shape[2]
    return kv if group == 1 else torch.repeat_interleave(kv, group, dim=2)


def gqa_cached_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         q_positions: torch.Tensor) -> torch.Tensor:
    """Grouped-query attention of q (b, s, h, d) against a positional cache
    (b, L, kv, d), where cache slot j holds the token at position j. Query
    heads group contiguously over kv heads; slot j is visible to a query at
    position p iff j <= p, and a masked score pins to NEG_INF so its softmax
    weight is exactly 0.0. ``q_positions`` is (s,) (every row at the same
    offsets) or (b, s) (per-row depths, continuous batching)."""
    b, s, h, d = q.shape
    kv = k_cache.shape[2]
    if h % kv:
        raise ValueError(f"n_heads {h} not divisible by kv_heads {kv}")
    qg = q.reshape(b, s, kv, h // kv, d)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg, k_cache) / (d ** 0.5)
    slot = torch.arange(k_cache.shape[1], device=q.device)
    if q_positions.dim() == 1:                                 # (s, L)
        mask = (slot[None, :] <= q_positions[:, None])[None, None, None]
    else:                                                      # (b, s, L)
        mask = (slot[None, None, :] <= q_positions[:, :, None])[:, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    out = torch.einsum("bkgsl,blkd->bskgd", probs.to(q.dtype), v_cache)
    return out.reshape(b, s, h, d)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Plain attention over (b, s, h, d) — causal with the diagonal offset
    sk - sq, as the JAX reference."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if causal:
        q_len, k_len = q.shape[1], k.shape[1]
        mask = torch.ones((q_len, k_len), dtype=torch.bool,
                          device=q.device).tril(k_len - q_len)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
