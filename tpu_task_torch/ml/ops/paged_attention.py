"""Paged decode attention: the CUDA kernel's wrapper, its plain version, and
the one dispatch the serving model calls — the counterpart of
``tpu_task/ml/ops/paged_attention.py``.

:func:`paged_decode_attention` launches ``csrc/paged_decode.cu``, the
hand-written Hopper port of the TPU kernel ``_paged_decode_kernel``: it
walks each row's block table over the physical KV pools, so the gathered
dense view never exists. :func:`paged_reference_attention` is the plain
version (gather through the tables, then the shared dense core); the CPU
tests compare it with the JAX package and ``chip_smoke.py`` compares the
kernel with it on the card. The wrapper takes the plain version only for
tensors that lie on the CPU; for a CUDA tensor it launches the kernel or
raises.

Each function counts its launches in a plain integer attribute
(``paged_decode_attention.launches``, ``paged_reference_attention.launches``)
so a run can show which one the serving path went through.

Quantized pools (int8 / fp8 / int4 codes with scale sidecars) come with the
quantized-KV slice (ROADMAP A6) and raise here."""

from __future__ import annotations

import functools

import torch

from tpu_task_torch.ml.ops import _build
from tpu_task_torch.ml.ops.attention import gqa_cached_attention
from tpu_task_torch.ml.serving.cache import flat_pool, gather_kv

#: The pool element types the kernel takes, by its dtype code.
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Dynamic shared memory one CTA may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232_448

IMPLS = ("reference", "cuda")


def paged_reference_attention(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor,
                              block_tables: torch.Tensor,
                              q_positions: torch.Tensor) -> torch.Tensor:
    """The plain version: gather each row's logical (rows, L, kv, d) view
    through its block table and run the shared dense core. q (rows, w, h,
    d); pools (n_blocks, bs, kv, d); tables (rows, max_blocks); positions
    (rows, w). Returns (rows, w, h, d) in q's dtype."""
    paged_reference_attention.launches += 1
    bs = k_pool.shape[1]
    k_view = gather_kv(flat_pool(k_pool), block_tables, bs)
    v_view = gather_kv(flat_pool(v_pool), block_tables, bs)
    return gqa_cached_attention(q, k_view, v_view, q_positions)


paged_reference_attention.launches = 0


def _check_kernel_args(q, k_pool, v_pool, block_tables, q_positions):
    """Raise on anything the kernel does not take, before any pointer
    reaches it."""
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"q must be (rows, w, h, d) and the pools (n_blocks, bs, kv, d) "
            f"alike, got q {tuple(q.shape)}, k {tuple(k_pool.shape)}, "
            f"v {tuple(v_pool.shape)}")
    rows, w, h, d = q.shape
    _, _, kv, dp = k_pool.shape
    if k_pool.dtype in (torch.int8, torch.uint8) or \
            k_pool.dtype.is_floating_point and k_pool.dtype.itemsize == 1:
        raise NotImplementedError(
            f"quantized KV pools ({k_pool.dtype}) are not ported yet: "
            "ROADMAP A6 (the kernel's int8/fp8/int4 variants)")
    if q.dtype not in KERNEL_DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(
            f"the kernel takes fp32 or bf16 with q and the pools of one "
            f"type, got q {q.dtype}, k {k_pool.dtype}, v {v_pool.dtype}")
    if dp != d or h % kv:
        raise ValueError(
            f"head dim {d} vs pool {dp}, or n_heads {h} not divisible by "
            f"kv_heads {kv}")
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
    tensors = (q, k_pool, v_pool, block_tables, q_positions)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors only")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("q and the pools must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _smem_bytes(w: int, h: int, kv: int, d: int, bs: int) -> int:
    """Shared memory one CTA needs at this geometry; raises past the
    card's limit."""
    smem = _build.load("paged_decode").tt_paged_decode_smem_bytes(
        w, h, kv, d, bs)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"paged decode needs {smem} bytes of shared memory per CTA at "
            f"w={w}, group={h // kv}, d={d}, block_size={bs}; the card "
            f"offers {MAX_SMEM_BYTES}")
    return smem


def _launch(q, k_pool, v_pool, block_tables, q_positions,
            out: torch.Tensor) -> None:
    """Launch the kernel into ``out`` (q's shape and type) on the current
    stream after checking its arguments; raises on any CUDA error. Counts
    nothing: :func:`paged_decode_attention` is the counted entry."""
    _check_kernel_args(q, k_pool, v_pool, block_tables, q_positions)
    if out.shape != q.shape or out.dtype != q.dtype \
            or out.device != q.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous tensor like q")
    rows, w, h, d = q.shape
    _, bs, kv, _ = k_pool.shape
    _smem_bytes(w, h, kv, d, bs)
    lib = _build.load("paged_decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tt_paged_decode(
            KERNEL_DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_tables.data_ptr(),
            q_positions.data_ptr(), out.data_ptr(), rows, w, h, kv, d, bs,
            block_tables.shape[1], stream)
    if rc:
        raise RuntimeError(
            f"paged_decode kernel launch failed: CUDA error {rc} "
            f"({lib.tt_cuda_error_string(rc).decode()})")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           q_positions: torch.Tensor) -> torch.Tensor:
    """Paged GQA decode attention through the CUDA kernel — the arguments
    and result of :func:`paged_reference_attention`. A CPU tensor takes
    the plain version (there is no CUDA there); a CUDA tensor launches the
    kernel on the current stream, or raises."""
    if q.device.type == "cpu":
        return paged_reference_attention(q, k_pool, v_pool, block_tables,
                                          q_positions)
    if q.device.type != "cuda":
        raise ValueError(f"no paged-decode kernel for device {q.device}")
    out = torch.empty_like(q)
    _launch(q, k_pool, v_pool, block_tables, q_positions, out)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def reset_launch_counts() -> None:
    paged_decode_attention.launches = 0
    paged_reference_attention.launches = 0


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    q_positions: torch.Tensor, *,
                    impl: str = "reference") -> torch.Tensor:
    """The one paged-attention entry the serving model calls. ``impl``:
    ``"reference"`` = the plain gather + dense version, ``"cuda"`` = the
    kernel (:func:`paged_decode_attention`). ``q_positions`` may be (rows,)
    for width-1 queries."""
    if impl not in IMPLS:
        raise ValueError(f"unknown paged-attention impl {impl!r}")
    if q_positions.dim() == 1:
        q_positions = q_positions[:, None]
    if impl == "reference":
        return paged_reference_attention(q, k_pool, v_pool, block_tables,
                                         q_positions)
    return paged_decode_attention(q, k_pool, v_pool, block_tables,
                                  q_positions)
