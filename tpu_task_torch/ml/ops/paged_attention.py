"""Paged decode attention: the CUDA kernels' wrappers, their plain version,
and the one dispatch the serving model calls — the counterpart of
``tpu_task/ml/ops/paged_attention.py``.

Two hand-written Hopper kernels compute one function, as their TPU
originals do:

- :func:`paged_decode_attention` launches ``csrc/paged_decode.cu``, the
  port of ``_paged_decode_kernel``: it walks each row's block table over
  the physical KV pools in 64-token tiles, so the gathered dense view never
  exists.
- :func:`paged_decode_pipelined_attention` launches
  ``csrc/paged_decode_pipelined.cu``, the port of
  ``_paged_decode_pipelined_kernel``: the same walk over a double-buffered
  shared-memory ring that ``cp.async`` fills with the pool's own bytes, the
  next copy issued before the current one is computed; for bf16 queries at
  head dims that are a multiple of 16 (up to 128) its two products run on
  the tensor cores.

Both cut each row's walk across CTAs (split-KV) as far as
:func:`split_plan` says to fill the card, at the kernel's own occupancy
(:func:`planned_splits`); past one split, a second kernel
(``combine_splits_kernel`` in ``csrc/paged_kv.cuh``, which each kernel's
library exports) merges the splits' partial softmax states. The pipelined
kernel's 64-token stages are the tile kernel's 64-token tiles
(:func:`stage_blocks_for` equals :func:`tile_blocks_for`), so one split
arithmetic (:func:`split_blocks`, :func:`split_ranges`) serves both.

Both take model-dtype pools (fp32, bf16) and quantized ones: int8 or fp8
e4m3 codes, or int4 pairs packed in uint8 (trailing dim ``d / 2``), with
``k_scale``/``v_scale`` (n_blocks, kv) fp32 sidecars; codes are converted
in registers and the scales applied to each block's scores and p·v.
:func:`paged_reference_attention` is the plain version of both (gather
through the tables, dequantize, then the shared dense core); the CPU tests
compare it with the JAX package and ``chip_smoke.py`` compares the kernels
with it on the card. :func:`paged_split_partials` and
:func:`combine_partials` are the plain versions of the split kernels'
partial states and of their merge. A wrapper takes the plain version only
for tensors that lie on the CPU; for a CUDA tensor it launches its kernel
or raises.

Each function counts its launches in a plain integer attribute
(``paged_decode_attention.launches``,
``paged_decode_pipelined_attention.launches``,
``paged_reference_attention.launches``) so a run can show which one the
serving path went through; each kernel wrapper's ``combine_launches``
counts the combine kernel's launches after it, where they are launched."""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Tuple

import torch

from tpu_task_torch.ml.ops import _build
from tpu_task_torch.ml.ops.attention import NEG_INF, gqa_cached_attention
from tpu_task_torch.ml.serving.cache import flat_pool, gather_kv, unpack_int4

#: The query (and output) types the kernels take, by their code.
Q_TYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The pool storage types the kernels take, by their code
#: (``csrc/paged_kv.cuh``); uint8 is int4 packed two codes per byte.
KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.float8_e4m3fn: 3, torch.uint8: 4}
QUANT_TYPES = (torch.int8, torch.float8_e4m3fn, torch.uint8)

#: Dynamic shared memory one CTA may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232_448

IMPLS = ("reference", "cuda", "pipelined")

#: Tokens the tile kernel takes per iteration (``kTileTokens`` in
#: ``csrc/paged_decode.cu``), rounded to whole blocks.
TILE_TOKENS = 64
#: Tokens of one stage of the pipelined kernel's walk (``kStageTokens`` in
#: ``csrc/paged_decode_pipelined.cu``), rounded to whole blocks.
STAGE_TOKENS = 64
#: Floats ahead of acc in one partial state: m and l (``kPartialHead``).
PARTIAL_HEAD = 2


def dequantize_view(view: torch.Tensor, scale: torch.Tensor,
                    block_tables: torch.Tensor, block_size: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """(rows, L, kv, d) gathered codes × their per-(block, kv-head) scales
    → values in ``dtype``. The scales gather through the same tables and
    broadcast over each block's tokens; a uint8 view is int4-packed and
    unpacks to the full head dim first."""
    if view.dtype == torch.uint8:
        view = unpack_int4(view)
    s_view = scale[block_tables.to(torch.int64)].repeat_interleave(
        block_size, dim=1)
    return (view.to(torch.float32) * s_view[..., None]).to(dtype)


def _gathered_views(k_pool, v_pool, block_tables, k_scale, v_scale,
                    dtype: torch.dtype):
    """Each row's logical (rows, L, kv, d) K and V views through its block
    table, a quantized pool's dequantized to ``dtype``."""
    bs = k_pool.shape[1]

    def gather(pool, scale):
        if scale is None:
            return gather_kv(flat_pool(pool), block_tables, bs)
        # One-byte codes are gathered as bytes, so no indexing kernel has
        # to know float8.
        raw = gather_kv(flat_pool(pool.view(torch.uint8)), block_tables, bs)
        return dequantize_view(raw.view(pool.dtype), scale, block_tables, bs,
                               dtype)

    return gather(k_pool, k_scale), gather(v_pool, v_scale)


def paged_reference_attention(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor,
                              block_tables: torch.Tensor,
                              q_positions: torch.Tensor,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The plain version: gather each row's logical (rows, L, kv, d) view
    through its block table (dequantized to q's dtype when scales are
    given) and run the shared dense core. q (rows, w, h, d); pools
    (n_blocks, bs, kv, d), or (…, d/2) uint8 for int4; tables (rows,
    max_blocks); positions (rows, w); scales (n_blocks, kv). Returns
    (rows, w, h, d) in q's dtype."""
    paged_reference_attention.launches += 1
    k_view, v_view = _gathered_views(k_pool, v_pool, block_tables, k_scale,
                                     v_scale, q.dtype)
    return gqa_cached_attention(q, k_view, v_view, q_positions)


paged_reference_attention.launches = 0


def tile_blocks_for(block_size: int) -> int:
    """Blocks per tile of the tile kernel (``tile_blocks_for`` in
    ``csrc/paged_decode.cu``)."""
    return 1 if block_size >= TILE_TOKENS else TILE_TOKENS // block_size


def stage_blocks_for(block_size: int) -> int:
    """Blocks per stage of the pipelined kernel (``stage_blocks_for`` in
    ``csrc/paged_decode_pipelined.cu``). Equal to :func:`tile_blocks_for`
    at every block size, so the split arithmetic below serves both
    kernels."""
    return 1 if block_size >= STAGE_TOKENS else STAGE_TOKENS // block_size


def n_tiles(max_blocks: int, block_size: int) -> int:
    """Tiles of a table ``max_blocks`` wide; the last may be ragged."""
    return -(-max_blocks // tile_blocks_for(block_size))


def split_plan(rows: int, kv_heads: int, max_blocks: int, block_size: int,
               n_sms: int, ctas_per_sm: int) -> int:
    """How many CTAs a paged kernel cuts each (row, kv head) walk into,
    from shapes alone: enough CTAs for one resident wave of the card
    (``n_sms * ctas_per_sm``), each split a whole number of tiles (stages),
    and no more splits than the table has tiles. A grid already a wave wide
    takes one split (no combine). Reads no positions or tables, so it never
    waits for the card."""
    tiles = n_tiles(max_blocks, block_size)
    ctas = rows * kv_heads
    wave = n_sms * ctas_per_sm
    if ctas == 0 or ctas >= wave or tiles <= 1:
        return 1
    split_tiles = -(-tiles // min(tiles, -(-wave // ctas)))
    return -(-tiles // split_tiles)


def split_blocks(max_blocks: int, block_size: int, splits: int) -> int:
    """Table entries each split covers: ceil(tiles / splits) whole tiles.
    The kernel takes this number as it is."""
    return -(-n_tiles(max_blocks, block_size) // splits) \
        * tile_blocks_for(block_size)


def split_ranges(max_blocks: int, block_size: int,
                 splits: int) -> List[Tuple[int, int]]:
    """Table entries [lo, hi) of each split, as the kernel cuts them: every
    split :func:`split_blocks` entries, the last ragged, any past the table
    empty."""
    span = split_blocks(max_blocks, block_size, splits)
    return [(min(s * span, max_blocks), min((s + 1) * span, max_blocks))
            for s in range(splits)]


def paged_split_partials(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, block_tables: torch.Tensor,
                         q_positions: torch.Tensor,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None, *,
                         splits: int) -> torch.Tensor:
    """The plain version of the split kernel's output: for each query row
    and split of :func:`split_ranges`, the online-softmax state over the
    slots of that split the query sees, from the gathered view in fp32.
    Returns (rows, w, h, splits, 2 + d) fp32: m (the max score, NEG_INF
    where the split shows the query nothing), l (the sum of e^(s - m)) and
    acc (the unnormalised sum of e^(s - m) v); the empty state is
    (NEG_INF, 0, 0). Arguments as :func:`paged_reference_attention`."""
    rows, w, h, d = q.shape
    bs, kv = k_pool.shape[1], k_pool.shape[2]
    k_view, v_view = (t.float() for t in _gathered_views(
        k_pool, v_pool, block_tables, k_scale, v_scale, torch.float32))
    qg = q.float().reshape(rows, w, kv, h // kv, d)
    scores = torch.einsum("bwkgd,blkd->bwkgl", qg, k_view) / math.sqrt(d)
    slot = torch.arange(k_view.shape[1], device=q.device)
    visible = slot[None, None, :] <= q_positions[:, :, None]     # (b, w, L)
    parts = []
    for lo, hi in split_ranges(block_tables.shape[1], bs, splits):
        mask = (visible & (slot >= lo * bs) & (slot < hi * bs))[:, :, None,
                                                                 None]
        s = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        m = s.amax(dim=-1)
        shift = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
        p = torch.where(mask, torch.exp(s - shift[..., None]),
                        torch.zeros_like(s))
        acc = torch.einsum("bwkgl,blkd->bwkgd", p, v_view)
        parts.append(torch.cat([m[..., None], p.sum(-1)[..., None], acc], -1))
    return torch.stack(parts, dim=-2).reshape(rows, w, h, splits,
                                              PARTIAL_HEAD + d)


def combine_partials(partials: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of the combine kernel: merge (…, splits, 2 + d)
    partial states into (…, d) in ``dtype``. M = max m_s; a state weighs
    e^(m_s - M), or 0 when m_s is the mask value; o = Σ acc_s w_s / L with
    L = Σ l_s w_s (1 where L is 0), so a query that sees no slot gets 0."""
    m, l, acc = (partials[..., 0], partials[..., 1],
                 partials[..., PARTIAL_HEAD:])
    big = m.amax(dim=-1, keepdim=True)
    weight = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                         torch.exp(m - big))
    total = (l * weight).sum(-1)
    out = (acc * weight[..., None]).sum(-2)
    return (out / torch.where(total == 0, torch.ones_like(total),
                              total)[..., None]).to(dtype)


def _check_kernel_args(q, k_pool, v_pool, block_tables, q_positions,
                       k_scale, v_scale, *, pipelined: bool) -> None:
    """Raise on anything the kernels do not take, before any pointer
    reaches them."""
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"q must be (rows, w, h, d) and the pools (n_blocks, bs, kv, d) "
            f"alike, got q {tuple(q.shape)}, k {tuple(k_pool.shape)}, "
            f"v {tuple(v_pool.shape)}")
    rows, w, h, d = q.shape
    n_blocks, _, kv, dp = k_pool.shape
    if q.dtype not in Q_TYPES:
        raise ValueError(f"the kernels take fp32 or bf16 queries, got "
                         f"{q.dtype}")
    if k_pool.dtype != v_pool.dtype or k_pool.dtype not in KV_TYPES:
        raise ValueError(
            f"the pools must share one storage type of {list(KV_TYPES)}, "
            f"got k {k_pool.dtype}, v {v_pool.dtype}")
    quantized = k_pool.dtype in QUANT_TYPES
    if not quantized and k_pool.dtype != q.dtype:
        raise ValueError(
            f"a model-dtype pool must have q's one type, got q {q.dtype}, "
            f"pools {k_pool.dtype}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if quantized != (k_scale is not None):
        raise ValueError(
            f"a quantized pool needs k_scale and v_scale and a "
            f"{k_pool.dtype} pool takes none")
    if quantized and any(
            s.dtype != torch.float32 or tuple(s.shape) != (n_blocks, kv)
            for s in (k_scale, v_scale)):
        raise ValueError(
            f"scales must be float32 of shape (n_blocks, kv) = "
            f"({n_blocks}, {kv}), got {k_scale.dtype} "
            f"{tuple(k_scale.shape)} and {v_scale.dtype} "
            f"{tuple(v_scale.shape)}")
    if k_pool.dtype == torch.uint8 and (d % 2 or dp * 2 != d):
        raise ValueError(
            f"an int4 pool packs head-dim pairs: it needs an even head dim "
            f"{d} and a pool width of d/2, got {dp}")
    if k_pool.dtype != torch.uint8 and dp != d:
        raise ValueError(f"head dim {d} vs pool {dp}")
    if h % kv:
        raise ValueError(f"n_heads {h} not divisible by kv_heads {kv}")
    if pipelined and dp * k_pool.element_size() % 4:
        raise ValueError(
            f"the pipelined kernel copies pool rows in 4-byte units; a row "
            f"of this pool is {dp * k_pool.element_size()} bytes")
    if block_tables.dtype != torch.int32 or q_positions.dtype != torch.int32:
        raise ValueError(
            f"block tables and positions must be int32, got "
            f"{block_tables.dtype} and {q_positions.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != rows \
            or tuple(q_positions.shape) != (rows, w):
        raise ValueError(
            f"tables must be (rows, max_blocks) and positions (rows, w) = "
            f"({rows}, {w}), got {tuple(block_tables.shape)} and "
            f"{tuple(q_positions.shape)}")
    tensors = (q, k_pool, v_pool, block_tables, q_positions) + (
        (k_scale, v_scale) if quantized else ())
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernels take contiguous tensors only")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("q and the pools must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _smem_bytes(pipelined: bool, q_type: int, kv_type: int, w: int, h: int,
                kv: int, d: int, bs: int) -> int:
    """Shared memory one CTA needs at this geometry; raises past the
    card's limit."""
    if pipelined:
        smem = _build.load("paged_decode_pipelined") \
            .tt_paged_decode_pipelined_smem_bytes(q_type, kv_type, w, h, kv,
                                                  d, bs)
    else:
        smem = _build.load("paged_decode").tt_paged_decode_smem_bytes(
            w, h, kv, d, bs)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"paged decode{' (pipelined)' if pipelined else ''} needs {smem} "
            f"bytes of shared memory per CTA at w={w}, group={h // kv}, "
            f"d={d}, block_size={bs}; the card offers {MAX_SMEM_BYTES}")
    return smem


def require_geometry(q_dtype: torch.dtype, pool_dtype: torch.dtype, w: int,
                     h: int, kv: int, d: int, bs: int, *,
                     pipelined: bool) -> None:
    """Raise ValueError, naming the cause, if a paged kernel cannot take
    this geometry at all: shared memory past the card's limit at query
    width ``w`` (it grows with ``w`` × the GQA group), or, for the
    pipelined kernel, pool rows that are not whole 4-byte units. Builds
    the kernel's library to ask it. An engine checks its steps' shapes at
    construction with this, rather than at a launch mid-stream."""
    row_bytes = (d // 2 if pool_dtype == torch.uint8 else d) * \
        torch.empty((), dtype=pool_dtype).element_size()
    if pipelined and row_bytes % 4:
        raise ValueError(
            f"the pipelined kernel copies pool rows in 4-byte units; a row "
            f"of this pool is {row_bytes} bytes (d={d}, {pool_dtype})")
    _smem_bytes(pipelined, Q_TYPES[q_dtype], KV_TYPES[pool_dtype], w, h, kv,
                d, bs)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library(pipelined: bool) -> str:
    return "paged_decode_pipelined" if pipelined else "paged_decode"


@functools.lru_cache(maxsize=None)
def _ctas_per_sm(index: int, pipelined: bool, q_type: int, kv_type: int,
                 w: int, h: int, kv: int, d: int, bs: int) -> int:
    """CTAs of the kernel that this instantiation and geometry launch that
    one SM holds at once, from the CUDA occupancy calculator (the pipelined
    library picks its tensor-core or scalar kernel by the geometry)."""
    name = _library(pipelined)
    lib = _build.load(name)
    smem = _smem_bytes(pipelined, q_type, kv_type, w, h, kv, d, bs)
    ctas = ctypes.c_int(0)
    with torch.cuda.device(index):
        if pipelined:
            rc = lib.tt_paged_decode_pipelined_ctas_per_sm(
                q_type, kv_type, w, h, kv, d, bs, ctypes.addressof(ctas))
        else:
            rc = lib.tt_paged_decode_ctas_per_sm(q_type, kv_type, smem,
                                                 ctypes.addressof(ctas))
    if rc:
        raise RuntimeError(
            f"{name} occupancy query failed: CUDA error {rc} "
            f"({lib.tt_cuda_error_string(rc).decode()})")
    if ctas.value < 1:
        raise RuntimeError(f"{name}: no CTA of {smem} bytes of shared memory "
                           f"fits an SM")
    return ctas.value


def planned_splits(q: torch.Tensor, k_pool: torch.Tensor, max_blocks: int,
                   *, pipelined: bool = False) -> int:
    """:func:`split_plan` for the tile kernel, or the pipelined one, at
    these shapes and types on q's card (its SM count and the kernel's
    occupancy, both cached per device and instantiation)."""
    rows, w, h, d = q.shape
    _, bs, kv, _ = k_pool.shape
    index = q.device.index
    if index is None:
        index = torch.cuda.current_device()
    ctas = _ctas_per_sm(index, pipelined, Q_TYPES[q.dtype],
                        KV_TYPES[k_pool.dtype], w, h, kv, d, bs)
    return split_plan(rows, kv, max_blocks, bs, _sm_count(index), ctas)


def pipelined_uses_tensor_cores(q: torch.Tensor,
                                k_pool: torch.Tensor) -> bool:
    """Whether the pipelined kernel runs its two products on the tensor
    cores at q's type and this geometry (bf16 queries, d a multiple of 16
    up to 128, at most 16 query rows per CTA), or on its scalar path."""
    _, w, h, d = q.shape
    return bool(_build.load("paged_decode_pipelined")
                .tt_paged_decode_pipelined_uses_mma(
                    Q_TYPES[q.dtype], w, h, k_pool.shape[2], d))


def _raise_on(rc: int, lib, name: str) -> None:
    if rc:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} "
            f"({lib.tt_cuda_error_string(rc).decode()})")


def _launch_combine(partials: torch.Tensor, out: torch.Tensor, *,
                    pipelined: bool = False) -> None:
    """Launch the combine kernel from the tile kernel's library, or the
    pipelined one's: merge ``partials`` (rows, w, h, splits, 2 + d) fp32
    into ``out`` (rows, w, h, d, fp32 or bf16) on the current stream;
    raises on any CUDA error. Counts nothing."""
    *lead, splits, width = partials.shape
    if partials.dtype != torch.float32 or out.dtype not in Q_TYPES \
            or tuple(out.shape) != (*lead, width - PARTIAL_HEAD) \
            or out.device != partials.device \
            or not (partials.is_contiguous() and out.is_contiguous()):
        raise ValueError(
            f"combine takes contiguous fp32 partials (…, splits, 2 + d) and "
            f"an out (…, d) beside them, got {partials.dtype} "
            f"{tuple(partials.shape)} and {out.dtype} {tuple(out.shape)}")
    name = _library(pipelined)
    lib = _build.load(name)
    entry = (lib.tt_paged_decode_pipelined_combine if pipelined
             else lib.tt_paged_decode_combine)
    with torch.cuda.device(out.device):
        rc = entry(Q_TYPES[out.dtype], partials.data_ptr(), out.data_ptr(),
                   out.numel() // out.shape[-1], splits, out.shape[-1],
                   torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, lib, f"{name} combine")


def _launch(q, k_pool, v_pool, block_tables, q_positions,
            out: torch.Tensor, k_scale=None, v_scale=None, *,
            pipelined: bool = False, splits: Optional[int] = None,
            partials: Optional[torch.Tensor] = None) -> int:
    """Launch one kernel into ``out`` (q's shape and type) on the current
    stream after checking its arguments; raises on any CUDA error. The
    kernel cuts its walk into :func:`planned_splits` splits and, past one,
    merges them with its library's combine kernel through ``partials``
    scratch, adding one to its wrapper's ``combine_launches`` at that
    launch; the split walk's own launch is counted by its wrapper. Tests may
    force ``splits`` (1 .. the table's tiles) and pass the scratch. Returns
    the split count."""
    _check_kernel_args(q, k_pool, v_pool, block_tables, q_positions,
                       k_scale, v_scale, pipelined=pipelined)
    if out.shape != q.shape or out.dtype != q.dtype \
            or out.device != q.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous tensor like q")
    rows, w, h, d = q.shape
    _, bs, kv, _ = k_pool.shape
    max_blocks = block_tables.shape[1]
    q_type, kv_type = Q_TYPES[q.dtype], KV_TYPES[k_pool.dtype]

    def check_partials():
        shape = (rows, w, h, splits, PARTIAL_HEAD + d)
        if splits > 1 and partials is not None and (
                tuple(partials.shape) != shape
                or partials.dtype != torch.float32
                or partials.device != q.device
                or not partials.is_contiguous()):
            raise ValueError(f"partials must be contiguous fp32 {shape} on "
                             f"q's device")

    if splits is not None:                 # forced: checked before any build
        if not 1 <= splits <= n_tiles(max_blocks, bs):
            raise ValueError(
                f"splits must be 1 .. {n_tiles(max_blocks, bs)} (the "
                f"table's tiles), got {splits}")
        check_partials()
    _smem_bytes(pipelined, q_type, kv_type, w, h, kv, d, bs)
    if splits is None:
        splits = planned_splits(q, k_pool, max_blocks, pipelined=pipelined)
        check_partials()
    if splits > 1 and partials is None:
        partials = torch.empty((rows, w, h, splits, PARTIAL_HEAD + d),
                               dtype=torch.float32, device=q.device)
    name = _library(pipelined)
    lib = _build.load(name)
    entry = lib.tt_paged_decode_pipelined if pipelined else \
        lib.tt_paged_decode
    scales = ((k_scale.data_ptr(), v_scale.data_ptr())
              if k_scale is not None else (None, None))
    with torch.cuda.device(q.device):
        rc = entry(q_type, kv_type, q.data_ptr(), k_pool.data_ptr(),
                   v_pool.data_ptr(), *scales, block_tables.data_ptr(),
                   q_positions.data_ptr(), out.data_ptr(),
                   partials.data_ptr() if splits > 1 else None, rows, w, h,
                   kv, d, bs, max_blocks, splits,
                   split_blocks(max_blocks, bs, splits),
                   torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, lib, name)
    if splits > 1:
        _launch_combine(partials, out, pipelined=pipelined)
        wrapper = paged_decode_pipelined_attention if pipelined else \
            paged_decode_attention
        wrapper.combine_launches += 1
    return splits


def _kernel_call(wrapper, pipelined: bool, q, k_pool, v_pool, block_tables,
                 q_positions, k_scale, v_scale) -> torch.Tensor:
    if q.device.type == "cpu":
        return paged_reference_attention(q, k_pool, v_pool, block_tables,
                                         q_positions, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged-decode kernel for device {q.device}")
    out = torch.empty_like(q)
    _launch(q, k_pool, v_pool, block_tables, q_positions, out, k_scale,
            v_scale, pipelined=pipelined)
    wrapper.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           q_positions: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Paged GQA decode attention through ``csrc/paged_decode.cu`` — the
    arguments and result of :func:`paged_reference_attention`. A CPU tensor
    takes the plain version (there is no CUDA there); a CUDA tensor
    launches the kernel on the current stream, cut into
    :func:`planned_splits` splits and followed by the combine kernel when
    there is more than one, or raises. ``launches`` counts calls (one per
    layer per fused step), ``combine_launches`` the combine kernel's
    launches."""
    return _kernel_call(paged_decode_attention, False, q, k_pool, v_pool,
                        block_tables, q_positions, k_scale, v_scale)


paged_decode_attention.launches = 0
paged_decode_attention.combine_launches = 0


def paged_decode_pipelined_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     q_positions: torch.Tensor,
                                     k_scale: Optional[torch.Tensor] = None,
                                     v_scale: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """The same function through ``csrc/paged_decode_pipelined.cu`` (the
    double-buffered ``cp.async`` walk of the pool's own bytes, its products
    on the tensor cores where :func:`pipelined_uses_tensor_cores` says so);
    same arguments, same CPU and CUDA rules, split plan and counters as
    :func:`paged_decode_attention`, at this kernel's own occupancy. Pool
    rows must be a multiple of 4 bytes."""
    return _kernel_call(paged_decode_pipelined_attention, True, q, k_pool,
                        v_pool, block_tables, q_positions, k_scale, v_scale)


paged_decode_pipelined_attention.launches = 0
paged_decode_pipelined_attention.combine_launches = 0


def launch_counts() -> dict:
    """This process's launch counters by function name."""
    return {
        "paged_decode_attention": paged_decode_attention.launches,
        "paged_decode_combine": paged_decode_attention.combine_launches,
        "paged_decode_pipelined_attention":
            paged_decode_pipelined_attention.launches,
        "paged_decode_pipelined_combine":
            paged_decode_pipelined_attention.combine_launches,
        "paged_reference_attention": paged_reference_attention.launches,
    }


def reset_launch_counts() -> None:
    paged_decode_attention.launches = 0
    paged_decode_attention.combine_launches = 0
    paged_decode_pipelined_attention.launches = 0
    paged_decode_pipelined_attention.combine_launches = 0
    paged_reference_attention.launches = 0


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    q_positions: torch.Tensor,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None, *,
                    impl: str = "reference", mesh=None,
                    axis_name: str = "tp") -> torch.Tensor:
    """The one paged-attention entry the serving model calls. ``impl``:
    ``"reference"`` = the plain gather + dense version, ``"cuda"`` =
    :func:`paged_decode_attention`, ``"pipelined"`` =
    :func:`paged_decode_pipelined_attention`. ``q_positions`` may be
    (rows,) for width-1 queries; the scales come with a quantized pool.

    With a gang's ``mesh`` the kv-head axis is sharded over ``axis_name``
    (the JAX package's ``_tp_kernel``): each rank passes its own block —
    its query heads, its pools and scales at ``kv_heads / tp`` heads, the
    tables and positions whole — and runs the chosen kernel, and the
    combine on its own partials, on that block alone. No reduction
    crosses ranks, so a rank's output is the unsharded call's over its
    head slice. The block must be tensors of its own: a kernel takes no
    strided view of a wider pool."""
    if impl not in IMPLS:
        raise ValueError(f"unknown paged-attention impl {impl!r}")
    if mesh is not None and dict(mesh.shape).get(axis_name, 1) > 1:
        shard = (q, k_pool, v_pool) + (
            (k_scale, v_scale) if k_scale is not None else ())
        if not all(t.is_contiguous() for t in shard):
            raise ValueError(
                "a kv-head shard must be its own contiguous tensor, not a "
                "view of the whole pool")
        if q.shape[2] % k_pool.shape[2]:
            raise ValueError(
                f"query heads {q.shape[2]} of the shard do not group over "
                f"its kv heads {k_pool.shape[2]}")
    if q_positions.dim() == 1:
        q_positions = q_positions[:, None]
    fn = {"reference": paged_reference_attention,
          "cuda": paged_decode_attention,
          "pipelined": paged_decode_pipelined_attention}[impl]
    return fn(q, k_pool, v_pool, block_tables, q_positions, k_scale, v_scale)
