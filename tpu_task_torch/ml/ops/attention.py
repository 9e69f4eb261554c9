"""Attention in torch — the counterpart of ``tpu_task/ml/ops/attention.py``.

The plain cores (``expand_kv_heads``, ``reduce_kv_heads``,
``gqa_cached_attention``, ``mha_reference``) and the flash path of
training: :func:`dot_product_attention` routes by the JAX package's
``_pallas_ok`` rule to :class:`FlashAttention`, an autograd Function over
three hand-written Hopper kernels in ``csrc/flash_attention.cu`` (the ports
of ``_flash_fwd_kernel``, ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel``), and otherwise to ``mha_reference`` under
activation checkpointing.

Beside the kernels stand their plain versions,
:func:`flash_attention_reference` and :func:`flash_bwd_reference` (the JAX
``block_attention_fwd``/``_bwd`` with ``impl="xla"``). Each counted
wrapper (:func:`flash_attention`, :func:`flash_bwd_dq`,
:func:`flash_bwd_dkv`) takes the plain version only for tensors on the
CPU; on a CUDA tensor it launches its kernel or raises. Every wrapper and
plain version counts its calls in a ``.launches`` attribute, which
:func:`reset_launch_counts` sets to 0.

The kernels for bf16 at head dims 64 and 128 walk schedules of tiles that
:func:`flash_fwd_tiles` (the forward and dq: 128-row q tiles over 128-row
kv stages) and :func:`flash_bwd_tiles` (both backward kernels; dk/dv:
128-row kv tiles over 64-row q stages) write out for the CPU tests to
check; nothing on the card path calls them.

Shapes follow (batch, seq, heads, head_dim) throughout, as in the JAX
package; ``lse`` and ``delta`` are (batch, heads, sq) float32."""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from tpu_task_torch.ml.ops import _build

NEG_INF = -1e30

#: The element types the flash kernels take, by their dtype code.
FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

IMPLS = ("reference", "cuda")

#: Rows of a q tile and of a kv ring stage in the wgmma forward kernel
#: (``kFwdBlockQ``, ``kFwdBlockK`` in ``csrc/flash_attention.cu``), at both
#: head dims it takes; the wgmma dq kernel uses the same.
FWD_BLOCK_Q = FWD_BLOCK_K = 128
#: Rows of a q ring stage and of a CTA's kv tile in the wgmma dk/dv kernel
#: (``kBwdBlockQ``, ``kBwdBlockK``).
BWD_BLOCK_Q, BWD_BLOCK_K = 64, 128
#: The wgmma kernels (bf16 at head dims 64 and 128) by the code their C
#: entries take.
WGMMA_KERNELS = {"fwd": 0, "dq": 1, "dkv": 2}


def expand_kv_heads(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, s, kv_heads, d) → (b, s, n_heads, d): repeat each kv head over
    its contiguous query group (head ``h`` reads kv head ``h // group``)."""
    group = n_heads // kv.shape[2]
    return kv if group == 1 else torch.repeat_interleave(kv, group, dim=2)


def reduce_kv_heads(d_expanded: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """Transpose of :func:`expand_kv_heads`: sum the expanded-width
    gradient over each query group back to kv_heads width."""
    b, s, h, d = d_expanded.shape
    if h == kv_heads:
        return d_expanded
    return d_expanded.reshape(b, s, kv_heads, h // kv_heads, d).sum(dim=3)


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


def gqa_cached_attention_tp(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, q_positions: torch.Tensor,
                            mesh, axis_name: str = "tp") -> torch.Tensor:
    """:func:`gqa_cached_attention` with the kv-head axis sharded over
    ``axis_name``: the JAX package's shard_map spelling, run by each rank
    of a gang on the whole arrays. The rank cuts its kv heads and their
    query groups (each its own contiguous tensor), runs the core on them
    and all-gathers the heads back in rank order. No reduction crosses
    ranks — softmax and both products are per kv head — so the result is
    BIT-EXACT against running the core on each head slice separately."""
    from tpu_task_torch.ml.parallel import gang

    kv = k_cache.shape[2]
    tp = dict(mesh.shape)[axis_name]
    if kv % tp:
        raise ValueError(f"kv_heads {kv} not divisible by {axis_name}={tp}")
    i, h = mesh.axis_index(axis_name), q.shape[2]
    kv_l, h_l = kv // tp, h // tp
    out = gqa_cached_attention(
        q[:, :, i * h_l:(i + 1) * h_l].contiguous(),
        k_cache[:, :, i * kv_l:(i + 1) * kv_l].contiguous(),
        v_cache[:, :, i * kv_l:(i + 1) * kv_l].contiguous(), q_positions)
    return gang.all_gather(mesh, out, axis_name, dim=2)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Plain attention over (b, s, h, d) — causal with the diagonal offset
    sk - sq, as the JAX reference."""
    mha_reference.launches += 1
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if causal:
        q_len, k_len = q.shape[1], k.shape[1]
        mask = torch.ones((q_len, k_len), dtype=torch.bool,
                          device=q.device).tril(k_len - q_len)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


mha_reference.launches = 0


# -- the flash kernels' plain versions ------------------------------------------

def _visible(sq: int, sk: int, q_offset: int, device) -> torch.Tensor:
    """(sq, sk): query row i (global position q_offset + i) sees key j."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    return q_pos >= torch.arange(sk, device=device)[None, :]


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool,
                              q_offset: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: (o, lse) in fp32 arithmetic — JAX's
    ``block_attention_fwd(impl="xla")``. o (b, sq, h, d) in q's type, lse
    (b, h, sq) float32; a row that sees no key gives o = 0 and lse = -1e30.
    ``q_offset`` (the global position of q row 0 relative to k col 0)
    defaults to sk - sq."""
    flash_attention_reference.launches += 1
    _, sq, _, d = q.shape
    sk = k.shape[1]
    if q_offset is None:
        q_offset = sk - sq
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    hidden = ~_visible(sq, sk, q_offset, q.device) if causal else None
    if causal:
        s = s.masked_fill(hidden, NEG_INF)
    m = s.amax(dim=-1)
    shift = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(s - shift[..., None])
    if causal:
        p = p.masked_fill(hidden, 0.0)
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l_safe[..., None], v.float())
    lse = torch.where(l == 0.0, torch.full_like(l, NEG_INF),
                      shift + torch.log(l_safe))
    return o.to(q.dtype), lse


flash_attention_reference.launches = 0


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, causal: bool,
                        q_offset: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward: (dq, dk, dv) for one block pair given the global
    lse and delta = rowsum(dO * O), in fp32 arithmetic — JAX's
    ``block_attention_bwd(impl="xla")``. Summing the results over the kv
    blocks of a row gives the full gradient."""
    flash_bwd_reference.launches += 1
    _, sq, _, d = q.shape
    sk = k.shape[1]
    if q_offset is None:
        q_offset = sk - sq
    scale = 1.0 / math.sqrt(d)
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    lse_safe = torch.where(lse <= NEG_INF / 2, torch.zeros_like(lse), lse)
    p = torch.exp(s - lse_safe[..., None])
    if causal:
        p = p.masked_fill(~_visible(sq, sk, q_offset, q.device), 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_bwd_reference.launches = 0


class FwdTile(NamedTuple):
    """One q tile of the forward's schedule: rows [q0, q0 + block_q) (those
    below sq are written) walk kv tiles [0, n) of block_k rows; the first
    ``unmasked`` apply no mask, the rest (the tiles that cross the diagonal
    or the ragged edge sk) do."""
    q0: int
    n: int
    unmasked: int


def flash_fwd_tiles(sq: int, sk: int, causal: bool, q_offset: int,
                    block_q: int = FWD_BLOCK_Q,
                    block_k: int = FWD_BLOCK_K) -> List[FwdTile]:
    """The wgmma forward kernel's tile schedule (``fwd_tiles`` in
    ``csrc/flash_attention.cu``), one entry per q tile in row order. The
    walk stops at the last tile the q tile's last row sees (``key_end``);
    tile t needs no mask iff all its keys lie below sk and the tile's first
    row sees them all, which holds for a prefix of the walk."""
    tiles = []
    for q0 in range(0, sq, block_q):
        if causal:
            last = min(q0 + block_q, sq) - 1
            end = max(0, min(sk, q_offset + last + 1))
            reach = min(sk, q_offset + q0 + 1)
        else:
            end = reach = sk
        n = -(-end // block_k)
        tiles.append(FwdTile(q0, n, min(n, max(0, reach) // block_k)))
    return tiles


class DkvTile(NamedTuple):
    """One kv tile of the dk/dv kernel's schedule: keys [k0, k0 + block_k)
    (those below sk are written) walk q tiles [begin, end) of block_q rows;
    tile t applies no mask iff lo <= t < hi (all its rows below sq, all
    the keys below sk, and its first row sees the last key)."""
    k0: int
    begin: int
    end: int
    lo: int
    hi: int


class BwdTiles(NamedTuple):
    """Both wgmma backward kernels' schedules: ``dq`` per q tile (the
    forward's, :func:`flash_fwd_tiles`) and ``dkv`` per kv tile."""
    dq: List[FwdTile]
    dkv: List[DkvTile]


def flash_bwd_tiles(sq: int, sk: int, causal: bool, q_offset: int,
                    block_q: int = BWD_BLOCK_Q, block_k: int = BWD_BLOCK_K,
                    dq_block_q: int = FWD_BLOCK_Q,
                    dq_block_k: int = FWD_BLOCK_K) -> BwdTiles:
    """The wgmma backward kernels' tile schedules (``fwd_tiles`` and
    ``dkv_tiles`` in ``csrc/flash_attention.cu``), in row order. The dk/dv
    walk starts at the q tile of the first row that sees the kv tile's
    first key, and is empty when no row does."""
    n_q = -(-sq // block_q)
    dkv = []
    for k0 in range(0, sk, block_k):
        hi = sq // block_q if k0 + block_k <= sk else 0
        first = max(0, k0 - q_offset) if causal else 0
        if first >= sq:
            dkv.append(DkvTile(k0, 0, 0, 0, 0))
            continue
        last = k0 + block_k - 1 - q_offset
        lo = -(-last // block_q) if causal and last > 0 else 0
        dkv.append(DkvTile(k0, first // block_q, n_q, lo, hi))
    return BwdTiles(flash_fwd_tiles(sq, sk, causal, q_offset, dq_block_q,
                                    dq_block_k), dkv)


# -- the kernels' wrappers ------------------------------------------------------

def check_flash_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     do: Optional[torch.Tensor] = None,
                     lse: Optional[torch.Tensor] = None,
                     delta: Optional[torch.Tensor] = None) -> None:
    """Raise on anything the flash kernels do not take, before any pointer
    reaches them: q (b, sq, h, d) and k/v (b, sk, h, d) of one type, fp32
    or bf16, d a multiple of 8 up to 128, k/v already at q's head count;
    do like q; lse and delta (b, h, sq) float32; all contiguous on one
    device."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be (b, sq, h, d) and k, v (b, sk, h, d) alike, got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(
            f"k/v {tuple(k.shape)} must match q {tuple(q.shape)} in batch, "
            "heads and head dim (expand grouped kv heads first)")
    if q.dtype not in FLASH_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(
            f"the flash kernels take fp32 or bf16 with q, k, v of one type, "
            f"got q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(
            f"the flash kernels take a head dim that is a multiple of 8 up "
            f"to 128, got {d}")
    if b * h > 65535:
        raise ValueError(f"batch x heads {b * h} exceeds the grid's 65535")
    tensors = [q, k, v]
    if do is not None:
        if do.shape != q.shape or do.dtype != q.dtype:
            raise ValueError(f"do must be like q, got {tuple(do.shape)} "
                             f"{do.dtype}")
        tensors.append(do)
    for name, t in (("lse", lse), ("delta", delta)):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq):
            raise ValueError(f"{name} must be float32 ({b}, {h}, {sq}), got "
                             f"{t.dtype} {tuple(t.shape)}")
        tensors.append(t)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all flash inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the flash kernels take contiguous tensors only")


def _q_offset(q_offset: Optional[int], sq: int, sk: int) -> int:
    q_offset = sk - sq if q_offset is None else int(q_offset)
    reach = max(sq, sk)
    if q_offset - reach <= -2 ** 31 or q_offset + reach >= 2 ** 31:
        raise ValueError(f"q_offset {q_offset} out of the kernels' int range")
    return q_offset


def _require_cuda(q: torch.Tensor, what: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {q.device}")


def _check_alignment(q: torch.Tensor, tensors) -> None:
    """Raise if the tensor-core kernels (bf16 at d 64 and 128, which move
    16-byte vectors) would get a pointer off a 16-byte boundary. Shared
    memory needs no check here: the source asserts at compile time that
    every kernel fits at the largest head dim."""
    lib = _build.load("flash_attention")
    if lib.tt_flash_tensor_cores(FLASH_DTYPES[q.dtype], q.shape[3]) and any(
            t.data_ptr() % 16 for t in tensors):
        raise ValueError("the bf16 tensor-core flash kernels take 16-byte "
                         "aligned tensors only")


def wgmma_ctas_per_sm(kernel: str, d: int) -> int:
    """CTAs of a wgmma kernel (``kernel`` "fwd", "dq" or "dkv"; bf16 at
    head dim 64 or 128) that fit one SM of the current card, by the CUDA
    occupancy calculator at the kernel's dynamic shared memory."""
    lib = _build.load("flash_attention")
    ctas = ctypes.c_int(0)
    rc = lib.tt_flash_ctas_per_sm(WGMMA_KERNELS[kernel], d,
                                  ctypes.addressof(ctas))
    if rc:
        raise RuntimeError(f"flash {kernel} occupancy query failed: CUDA "
                           f"error {rc} "
                           f"({lib.tt_cuda_error_string(rc).decode()})")
    return ctas.value


def wgmma_smem_bytes(kernel: str, d: int) -> int:
    """Dynamic shared memory of a wgmma kernel at head dim d."""
    return _build.load("flash_attention").tt_flash_smem_bytes(
        WGMMA_KERNELS[kernel], d)


def _check_out(out: torch.Tensor, like: torch.Tensor, name: str) -> None:
    if out.shape != like.shape or out.dtype != like.dtype \
            or out.device != like.device or not out.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor like its input")


def _run(what: str, fn, *args) -> None:
    """Call a kernel entry on the current stream; raise on a CUDA error."""
    lib = _build.load("flash_attention")
    rc = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {rc} "
            f"({lib.tt_cuda_error_string(rc).decode()})")


def _geometry(q, k, causal, q_offset):
    b, sq, h, d = q.shape
    return (b, sq, k.shape[1], h, d, int(bool(causal)), q_offset)


def _launch_fwd(q, k, v, causal: bool, q_offset: int, o: torch.Tensor,
                lse: torch.Tensor) -> None:
    """Launch the forward kernel into ``o`` and ``lse``; counts nothing
    (:func:`flash_attention` is the counted entry)."""
    check_flash_args(q, k, v, lse=lse)
    _check_out(o, q, "o")
    _check_alignment(q, (q, k, v, o))
    with torch.cuda.device(q.device):
        _run("flash forward", "tt_flash_fwd", FLASH_DTYPES[q.dtype],
             q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), *_geometry(q, k, causal, q_offset))


def _launch_dq(q, k, v, do, lse, delta, causal: bool, q_offset: int,
               dq: torch.Tensor) -> None:
    check_flash_args(q, k, v, do, lse, delta)
    _check_out(dq, q, "dq")
    _check_alignment(q, (q, k, v, do, dq))
    with torch.cuda.device(q.device):
        _run("flash dq", "tt_flash_bwd_dq", FLASH_DTYPES[q.dtype],
             q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             *_geometry(q, k, causal, q_offset))


def _launch_dkv(q, k, v, do, lse, delta, causal: bool, q_offset: int,
                dk: torch.Tensor, dv: torch.Tensor) -> None:
    check_flash_args(q, k, v, do, lse, delta)
    _check_out(dk, k, "dk")
    _check_out(dv, v, "dv")
    _check_alignment(q, (q, k, v, do, dk, dv))
    with torch.cuda.device(q.device):
        _run("flash dk/dv", "tt_flash_bwd_dkv", FLASH_DTYPES[q.dtype],
             q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *_geometry(q, k, causal, q_offset))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, *, q_offset: Optional[int] = None,
                    return_lse: bool = False):
    """Flash attention forward through ``csrc/flash_attention.cu``. q (b,
    sq, h, d), k/v (b, sk, h, d); ``q_offset`` defaults to sk - sq. With
    ``return_lse`` also the (b, h, sq) float32 logsumexp. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel, or
    raises."""
    if q.device.type == "cpu":
        o, lse = flash_attention_reference(q, k, v, causal, q_offset)
        return (o, lse) if return_lse else o
    _require_cuda(q, "flash forward")
    b, sq, h, _ = q.shape
    q_offset = _q_offset(q_offset, sq, k.shape[1])
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch_fwd(q, k, v, causal, q_offset, o, lse)
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool, *, q_offset: Optional[int] = None
                 ) -> torch.Tensor:
    """dq through the dq kernel (the plain version's dq on the CPU)."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, lse, delta, causal,
                                   q_offset)[0]
    _require_cuda(q, "flash dq")
    q_offset = _q_offset(q_offset, q.shape[1], k.shape[1])
    dq = torch.empty_like(q)
    _launch_dq(q, k, v, do, lse, delta, causal, q_offset, dq)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool, *, q_offset: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) through the dk/dv kernel (the plain version's on the
    CPU)."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, lse, delta, causal,
                                   q_offset)[1:]
    _require_cuda(q, "flash dk/dv")
    q_offset = _q_offset(q_offset, q.shape[1], k.shape[1])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_dkv(q, k, v, do, lse, delta, causal, q_offset, dk, dv)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def reset_launch_counts() -> None:
    for fn in (flash_attention, flash_bwd_dq, flash_bwd_dkv,
               flash_attention_reference, flash_bwd_reference,
               mha_reference):
        fn.launches = 0


def _flash_bwd_with_stats(q, k, v, do, lse, delta, causal: bool, *,
                          q_offset: Optional[int] = None):
    """(dq, dk, dv) given an lse and delta from outside (ring attention
    passes global ones): the dq and dk/dv kernels on the card, the plain
    version once on the CPU."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, lse, delta, causal, q_offset)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, q_offset=q_offset)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal,
                           q_offset=q_offset)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True, *,
                        q_offset: Optional[int] = None):
    """(dq, dk, dv) from the forward's o and lse: delta = rowsum(dO * O)
    in plain torch, then :func:`_flash_bwd_with_stats`."""
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
    return _flash_bwd_with_stats(q, k, v, do, lse, delta, causal,
                                 q_offset=q_offset)


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown block-attention impl {impl!r}; have "
                         f"{IMPLS}")


def block_attention_fwd(q, k, v, causal: bool, *,
                        q_offset: Optional[int] = None,
                        impl: str = "reference"):
    """(o, lse) for one attention block pair — the primitive ring attention
    folds over. ``impl``: ``"reference"`` = the plain version, ``"cuda"`` =
    the forward kernel (:func:`flash_attention`)."""
    _check_impl(impl)
    if impl == "reference":
        return flash_attention_reference(q, k, v, causal, q_offset)
    return flash_attention(q, k, v, causal, q_offset=q_offset,
                           return_lse=True)


def block_attention_bwd(q, k, v, do, lse, delta, causal: bool, *,
                        q_offset: Optional[int] = None,
                        impl: str = "reference"):
    """(dq, dk, dv) for one block pair given the global lse and delta."""
    _check_impl(impl)
    if impl == "reference":
        return flash_bwd_reference(q, k, v, do, lse, delta, causal, q_offset)
    return _flash_bwd_with_stats(q, k, v, do, lse, delta, causal,
                                 q_offset=q_offset)


# -- the fused op ------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """Attention whose forward and backward are the flash kernels (the
    plain versions on the CPU) — the JAX ``_pallas_attention`` custom VJP.
    Forward saves q, k, v, o and lse; backward computes delta and calls
    the dq and dk/dv wrappers. k and v are at q's head count."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention(q, k, v, causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None


def _pallas_ok(q: torch.Tensor, k: torch.Tensor, causal: bool,
               block: int = 128) -> bool:
    """The JAX package's routing rule: lengths a multiple of 128, and not
    causal with sq > sk (leading rows would see no key; the plain path
    keeps one semantics per call there)."""
    if q.shape[1] % block or k.shape[1] % block:
        return False
    return not causal or q.shape[1] <= k.shape[1]


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Attention over (b, s, h, d) with k/v at q's head count: the flash
    kernels (:class:`FlashAttention`) where :func:`_pallas_ok` admits the
    shape, else :func:`mha_reference` under activation checkpointing, so
    its backward recomputes rather than saving the (s, s) weights. A shape
    the rule admits and the kernels cannot take raises; nothing falls
    back."""
    if _pallas_ok(q, k, causal):
        return FlashAttention.apply(q, k, v, causal)
    return torch.utils.checkpoint.checkpoint(
        mha_reference, q, k, v, causal, use_reentrant=False)
