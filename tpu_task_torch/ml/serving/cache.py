"""Paged KV cache: one shared physical block pool per layer plus per-slot
block tables — the counterpart of ``tpu_task/ml/serving/cache.py``.

Each layer holds ``k``/``v`` pools of shape ``(n_blocks, block_size,
kv_heads, d_head)`` in the model dtype; a slot's logical token ``p`` lives
at flat pool slot ``table[p // block_size] * block_size + p % block_size``.
Physical block 0 is the SCRATCH block: never allocated, ``0`` in a table
means "unallocated", and every masked write lands there, where the
position mask keeps it out of every output.

A quantized pool (``ServingConfig.kv_dtype`` ``"int8"``, ``"fp8"`` or
``"int4"``) stores codes (int8, float8 e4m3, or two int4 codes per uint8
byte, so ``d_head / 2`` wide) plus ``k_scale``/``v_scale`` sidecars of one
fp32 scale per (block, kv head). Writes requantize whole blocks
(:func:`quantized_append`); the codes and scales are bit-identical to the
JAX package's.

Where the JAX package rebuilt donated pool arrays each step, the port
writes the pools IN PLACE (``index_copy_`` on a flat view, indexed
assignment for a block copy and for quantized blocks), so a step costs
only the bytes it writes.

The host-side :class:`BlockAllocator`, :func:`chain_block_hashes` and
:class:`PrefixCache` are this package's own copies of the JAX package's
(which the port does not import), fleet-KV adoption and the host-tier
demotion marks included.

Fleet block shipping (:func:`kv_fingerprint` … :func:`write_blocks`) is
byte-compatible with the JAX package's: for the same config and the same
pool contents, the same fingerprint, payload length and payload bytes, so
blocks published by an engine of either package import into the other.
The host tier (:mod:`~tpu_task_torch.ml.serving.offload`) keeps the same
payloads: :class:`BlockStaging` reads a demote pass's blocks back through
one pinned buffer and an event, and :func:`write_block_payloads` uploads
a promotion through one pinned buffer, so neither waits for the programs
already on the stream."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_task_torch.ml.models.transformer import TransformerConfig
from tpu_task_torch.ml.parallel import gang
from tpu_task_torch.ml.parallel.sharding import (
    match_partition_rules,
    shard_slices,
)

#: Physical block index reserved for masked writes / the "unallocated"
#: block-table sentinel. Never handed out by the allocator.
SCRATCH_BLOCK = 0

#: ServingConfig.decode_impl values: "auto" picks the kernel on a CUDA
#: device and the plain version on the CPU; "pipelined" is the
#: double-buffered kernel (CUDA only).
DECODE_IMPLS = ("auto", "reference", "cuda", "pipelined")

#: Floor for the per-(block, kv-head) quantization scale: an all-zero
#: block quantizes to zero codes at this scale and dequantizes back to
#: exact zeros, so a fresh quantized pool reads as zeros.
INT8_SCALE_EPS = 1e-8

#: Largest finite float8 e4m3 value: the scale maps a block's amax to it.
FP8_MAX = 448.0

#: The quantized ``ServingConfig.kv_dtype`` values (scale sidecars, writes
#: through :func:`quantized_append`).
QUANT_DTYPES = ("int8", "fp8", "int4")

#: Largest int4 code magnitude: the symmetric grid is ±7 so the amax
#: element maps to exactly ±7 and nothing clips.
INT4_MAX = 7


def kv_code_dtype(kv_dtype: str) -> torch.dtype:
    """Storage dtype of a quantized pool's codes. ``torch.uint8`` marks
    int4 (two codes per byte): int8 pools are ``torch.int8`` and fp8 pools
    ``torch.float8_e4m3fn``, so a pool's dtype alone says how to read it."""
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "fp8":
        return torch.float8_e4m3fn
    if kv_dtype == "int4":
        return torch.uint8
    raise ValueError(f"not a quantized kv_dtype: {kv_dtype!r}")


def fp8_supported() -> bool:
    """Whether this torch build stores and converts float8 e4m3: the
    construction-time gate for ``kv_dtype="fp8"``."""
    if not hasattr(torch, "float8_e4m3fn"):
        return False
    try:
        x = torch.tensor([1.5]).to(torch.float8_e4m3fn).to(torch.float32)
    except (RuntimeError, TypeError):
        return False
    return float(x[0]) == 1.5


@dataclass(frozen=True)
class ServingConfig:
    """Admission knobs for the continuous-batching engine — the JAX
    package's fields and validation. ``slots``: the decode batch width;
    ``block_size``/``n_blocks``: pool geometry (``n_blocks`` includes the
    scratch block); ``max_len``: per-slot logical capacity; ``chunk_tokens``:
    prompt positions one fused step ingests; ``prefix_cache``: share full
    KV blocks across requests by content hash; ``prefill_slots``: admitting
    slots that share one step's chunk budget; ``decode_impl``: the paged
    attention of every fused step (see :data:`DECODE_IMPLS`); ``kv_dtype``:
    None keeps the pools in the model dtype, ``"int8"``/``"fp8"``/``"int4"``
    store codes with per-(block, kv-head) scales (int4 needs an even
    ``d_head``); ``micro_k``: decode iterations one pure-decode step runs
    (a captured CUDA graph of the K-step loop on a CUDA device);
    ``spec_k``: draft tokens a speculative round proposes per slot (0 is
    off; the engine then needs ``draft_params``/``draft_cfg``);
    ``lora_rank``: rank of the paged LoRA adapter pool (0 is off; adapters
    of a smaller rank zero-pad to it); ``n_adapter_blocks``: the adapter
    pool's blocks, block 0 the zero scratch block, one block a layer of
    one adapter (see :mod:`~tpu_task_torch.ml.serving.lora`); ``overlap``:
    the asynchronous loop, which dispatches the next program before it
    sweeps the previous one (chunked prefill only, no speculative
    decoding); ``host_offload_blocks``: the host-RAM tier's budget in
    blocks (0 is off; it needs the prefix cache, whose chained hashes
    address it); ``prefill``: ``"chunked"`` (the default) folds prompt
    ingestion into the fused steps, ``"bucketed"`` runs each admission's
    whole context through one program padded to the smallest of
    ``prefill_buckets`` that holds it (:meth:`bucket_for`; no prefix
    cache, no overlapped loop)."""

    slots: int = 8
    block_size: int = 16
    n_blocks: int = 128
    max_len: int = 256
    prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128)
    prefill: str = "chunked"
    chunk_tokens: int = 16
    prefix_cache: bool = True
    spec_k: int = 0
    decode_impl: str = "auto"
    kv_dtype: Optional[str] = None
    micro_k: int = 1
    overlap: bool = False
    prefill_slots: int = 1
    host_offload_blocks: int = 0
    lora_rank: int = 0
    n_adapter_blocks: int = 0

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {self.block_size}")
        if self.n_blocks < 2:
            raise ValueError(
                f"n_blocks must be >= 2 (block 0 is scratch), got "
                f"{self.n_blocks}")
        if not self.prefill_buckets or list(self.prefill_buckets) != sorted(
                set(self.prefill_buckets)):
            raise ValueError(
                f"prefill_buckets must be non-empty strictly ascending, got "
                f"{self.prefill_buckets}")
        if self.prefill == "bucketed" and \
                self.prefill_buckets[-1] > self.max_len:
            # Chunked prefill never pads to a bucket, so the default bucket
            # table may exceed a small max_len there without harm.
            raise ValueError(
                f"largest prefill bucket {self.prefill_buckets[-1]} exceeds "
                f"max_len {self.max_len}")
        if self.prefill not in ("chunked", "bucketed"):
            raise ValueError(
                f"prefill must be 'chunked' or 'bucketed', got "
                f"{self.prefill!r}")
        if self.chunk_tokens < 1:
            raise ValueError(
                f"chunk_tokens must be >= 1, got {self.chunk_tokens}")
        if self.prefix_cache and self.prefill != "chunked":
            raise ValueError(
                "prefix_cache needs prefill='chunked': a cache-hit "
                "admission prefills only the tail, which is a chunk step")
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        if self.decode_impl not in DECODE_IMPLS:
            raise ValueError(
                f"decode_impl must be one of {DECODE_IMPLS}, got "
                f"{self.decode_impl!r}")
        if self.kv_dtype not in (None,) + QUANT_DTYPES:
            raise ValueError(
                f"kv_dtype must be None (model dtype), 'int8', 'fp8', or "
                f"'int4', got {self.kv_dtype!r}")
        if self.micro_k < 1:
            raise ValueError(f"micro_k must be >= 1, got {self.micro_k}")
        if self.micro_k > self.max_len:
            raise ValueError(
                f"micro_k {self.micro_k} exceeds max_len {self.max_len}")
        if self.prefill_slots < 1:
            raise ValueError(
                f"prefill_slots must be >= 1, got {self.prefill_slots}")
        if self.prefill_slots > self.slots:
            raise ValueError(
                f"prefill_slots {self.prefill_slots} exceeds slots "
                f"{self.slots}")
        if self.overlap and self.prefill != "chunked":
            raise ValueError(
                "overlap=True needs prefill='chunked': admissions are "
                "staged into the next program's chunk rows")
        if self.overlap and self.spec_k > 0:
            raise ValueError(
                "overlap=True is incompatible with speculative decoding "
                "(spec_k > 0): the draft/score round-trip is a host "
                "sync point every round")
        if self.host_offload_blocks < 0:
            raise ValueError(
                f"host_offload_blocks must be >= 0, got "
                f"{self.host_offload_blocks}")
        if self.host_offload_blocks and not self.prefix_cache:
            raise ValueError(
                "host_offload_blocks needs prefix_cache=True: the host "
                "tier is content-addressed by the cache's chained block "
                "hashes")
        if self.lora_rank < 0:
            raise ValueError(f"lora_rank must be >= 0, got {self.lora_rank}")
        if self.n_adapter_blocks < 0:
            raise ValueError(
                f"n_adapter_blocks must be >= 0, got "
                f"{self.n_adapter_blocks}")
        if self.lora_rank > 0 and self.n_adapter_blocks < 2:
            raise ValueError(
                f"lora_rank > 0 needs n_adapter_blocks >= 2 (block 0 is "
                f"the zero scratch block), got {self.n_adapter_blocks}")

    @property
    def max_blocks_per_slot(self) -> int:
        return -(-self.max_len // self.block_size)

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest prefill bucket holding ``prompt_len`` tokens."""
        for b in self.prefill_buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt of {prompt_len} tokens exceeds the largest prefill "
            f"bucket {self.prefill_buckets[-1]}")

    def blocks_for(self, n_tokens: int) -> int:
        """Physical blocks covering ``n_tokens`` logical tokens."""
        return -(-n_tokens // self.block_size)


def kv_token_bytes(cfg: TransformerConfig,
                   scfg: Optional[ServingConfig] = None) -> int:
    """KV bytes one token occupies across all layers (k + v). Without
    ``scfg`` (or with ``kv_dtype=None``) each element is one model-dtype
    value; a quantized pool stores one byte (int8/fp8) or half a byte
    (int4) per element plus the per-(block, kv-head) fp32 scales amortized
    over the block's tokens."""
    per_channel = 2 * cfg.n_layers * cfg.kv_heads
    if scfg is None or scfg.kv_dtype is None:
        return per_channel * cfg.d_head * _itemsize(cfg.dtype)
    d_bytes = cfg.d_head // 2 if scfg.kv_dtype == "int4" else cfg.d_head
    return per_channel * d_bytes + -(-per_channel * 4 // scfg.block_size)


def kv_block_bytes(cfg: TransformerConfig, scfg: ServingConfig) -> int:
    """Exact bytes of ONE physical block across all layers (codes and
    scales): the unit :func:`blocks_in_budget` divides a budget by."""
    per_channel = 2 * cfg.n_layers * cfg.kv_heads
    if scfg.kv_dtype in QUANT_DTYPES:
        d_bytes = (cfg.d_head // 2 if scfg.kv_dtype == "int4"
                   else cfg.d_head)
        return per_channel * (scfg.block_size * d_bytes + 4)
    return per_channel * scfg.block_size * cfg.d_head * _itemsize(cfg.dtype)


def blocks_in_budget(cfg: TransformerConfig, scfg: ServingConfig,
                     budget_bytes: int) -> int:
    """Physical blocks (scratch included) that fit ``budget_bytes`` under
    this config's KV dtype."""
    return budget_bytes // kv_block_bytes(cfg, scfg)


def paged_cache_bytes(cfg: TransformerConfig, scfg: ServingConfig,
                      n_blocks: int) -> int:
    """Bytes of ``n_blocks`` physical blocks, scales included when the pool
    is quantized."""
    return n_blocks * kv_block_bytes(cfg, scfg)


def dense_cache_bytes(cfg: TransformerConfig, slots: int,
                      max_len: int) -> int:
    """Worst-case bytes of the dense layout: every slot reserves max_len."""
    return slots * max_len * kv_token_bytes(cfg)


def kv_shard_bytes(cfg: TransformerConfig, scfg: ServingConfig,
                   n_blocks: int, tp: int) -> int:
    """Per-device bytes of ``n_blocks`` physical blocks under a ``tp``-way
    kv-head shard: each rank holds ``kv_heads / tp`` heads of every
    block, so the pool cost divides by tp exactly (kv_heads % tp == 0 is
    checked at engine construction)."""
    return paged_cache_bytes(cfg, scfg, n_blocks) // max(1, tp)


#: Regex partition rules for the paged pools (the JAX package's): every
#: ``<layer>/k`` and ``<layer>/v`` leaf is ``(n_blocks, block_size,
#: kv_heads, d_head)`` and shards its KV-HEAD axis wherever the "heads"
#: logical axis goes (tp). Paging stays along the token axis, so block
#: accounting — tables, allocator, scratch block — is identical at every
#: tp width. Scale sidecars are (n_blocks, kv_heads): the kv-head axis
#: shards with the pool it scales.
SERVING_POOL_RULES = (
    (r"(^|/)[kv]_scale$", (None, "heads")),
    (r"(^|/)[kv]$", (None, None, "heads", None)),
)


def pool_pspecs(pools, mesh) -> List[dict]:
    """PartitionSpecs for the pool tree via the shared partition rules
    (kv-heads over tp; block grid, block offset and head_dim
    replicated)."""
    return match_partition_rules(SERVING_POOL_RULES, pools, mesh=mesh)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def init_pools(cfg: TransformerConfig, scfg: ServingConfig,
               device, mesh=None) -> List[Dict[str, torch.Tensor]]:
    """Per-layer zeroed k/v pools on ``device``: in the model dtype, or,
    with a quantized ``kv_dtype``, zero codes (int4: ``d_head / 2`` packed
    bytes) plus ``k_scale``/``v_scale`` (n_blocks, kv_heads) fp32 sidecars
    at :data:`INT8_SCALE_EPS`, so a fresh pool dequantizes to exact
    zeros. With a ``mesh``, each leaf is this rank's block under
    :func:`pool_pspecs` (``kv_heads / tp`` heads), allocated at that width
    (its own tensor, never a view of a wider one)."""
    shape = (scfg.n_blocks, scfg.block_size, cfg.kv_heads, cfg.d_head)
    if scfg.kv_dtype == "int4":
        if cfg.d_head % 2:
            raise ValueError(
                f"kv_dtype='int4' packs adjacent d_head pairs and needs an "
                f"even d_head, got {cfg.d_head}")
        shape = shape[:-1] + (cfg.d_head // 2,)
    quant = scfg.kv_dtype in QUANT_DTYPES
    code = kv_code_dtype(scfg.kv_dtype) if quant else cfg.dtype
    pool = torch.empty(shape, dtype=code, device="meta")
    layer = {"k": pool, "v": pool}
    if quant:
        scale = torch.empty((scfg.n_blocks, cfg.kv_heads),
                            dtype=torch.float32, device="meta")
        layer.update(k_scale=scale, v_scale=scale)
    full = [layer] * cfg.n_layers
    specs = pool_pspecs(full, mesh)

    def alloc(leaf: torch.Tensor, spec, name: str) -> torch.Tensor:
        local = leaf.shape if mesh is None else tuple(
            s.stop - s.start for s in shard_slices(leaf.shape, spec, mesh))
        fill = INT8_SCALE_EPS if name.endswith("_scale") else 0
        return torch.full(local, fill, dtype=leaf.dtype, device=device)

    return [{name: alloc(leaf, spec[name], name)
             for name, leaf in layer.items()}
            for spec in specs]


def flat_pool(pool: torch.Tensor) -> torch.Tensor:
    """(n_blocks, block_size, kv, d) → (n_blocks·block_size, kv, d), a view
    of the same storage: writes through it land in the pool."""
    n, bs = pool.shape[:2]
    return pool.view(n * bs, *pool.shape[2:])


@gang.program
def copy_block(pools: List[Dict[str, torch.Tensor]], src: int,
               dst: int, *, mesh=None) -> None:
    """Copy physical block ``src`` to ``dst`` in every layer's pools, in
    place — the device half of copy-on-write. Generic over the layer's
    leaves, so a quantized block's scales copy with its codes. With a
    gang's ``mesh``, every rank copies in its own pools."""
    for pool in pools:
        for arr in pool.values():
            arr[dst] = arr[src]


def gather_kv(pool_flat: torch.Tensor, block_tables: torch.Tensor,
              block_size: int) -> torch.Tensor:
    """(rows, max_blocks·block_size, kv, d) logical-order view of the pool
    through the block tables. Unallocated entries read the scratch block;
    the attention core's position mask zeroes them exactly."""
    idx = (block_tables.to(torch.int64)[:, :, None] * block_size
           + torch.arange(block_size, device=block_tables.device))
    return pool_flat[idx.reshape(block_tables.shape[0], -1)]


# -- int8 / fp8 / int4 KV block quantization ---------------------------------

def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """(..., d) int8 codes in [-7, 7] → (..., d/2) uint8: adjacent channel
    pairs share a byte, even channel in the low nibble. The int8 → uint8
    cast wraps (-7 → 249), so ``& 15`` is the two's-complement nibble."""
    pairs = codes.reshape(codes.shape[:-1] + (codes.shape[-1] // 2, 2))
    lo = pairs[..., 0].to(torch.uint8) & 15
    hi = pairs[..., 1].to(torch.uint8) & 15
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (..., d/2) uint8 → (..., d) int8, by
    the branch-free sign extension ``(n ^ 8) - 8`` (9 → -7, 0 → 0)."""
    nibbles = torch.stack([packed & 15, (packed >> 4) & 15], dim=-1)
    signed = (nibbles.to(torch.int8) ^ 8) - 8
    return signed.reshape(packed.shape[:-1] + (packed.shape[-1] * 2,))


def _over(amax: torch.Tensor, constant: float) -> torch.Tensor:
    """``amax / constant`` as XLA compiles it: ``amax`` times the
    constant's float32 reciprocal (torch rounds a Python scalar to the
    tensor's float32 before it multiplies)."""
    return amax * (1.0 / constant)


def quantize_blocks(x: torch.Tensor, code_dtype: torch.dtype = torch.int8):
    """(n, block_size, kv, d) values → (codes, (n, kv) float32 scales):
    symmetric per-(block, kv-head) quantization, the JAX package's
    arithmetic step for step as its serving engine's compiled programs
    run it (so codes and scales are bit-identical).

    int8: ``scale = amax / 127`` floored at :data:`INT8_SCALE_EPS`, codes
    rounded half to even; error ≤ scale/2. fp8 (``float8_e4m3fn``):
    ``scale = amax / FP8_MAX``, the scaled value keeps fp8's own mantissa
    (relative error). uint8 (int4): ``scale = amax / INT4_MAX``, codes
    clipped to ±7 and packed two per byte (trailing dim ``d/2``).

    Each scale is ``amax`` times the float32 reciprocal of its constant,
    not a division by it: XLA folds JAX's ``amax / 127.0`` into that
    product when it compiles the step, and the two differ by an ulp for
    about half the blocks. An ulp of scale moves a value at an fp8 or
    int4 rounding edge by a code."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=(1, 3))
    if code_dtype == torch.int8:
        scale = torch.clamp_min(_over(amax, 127.0), INT8_SCALE_EPS)
        codes = torch.clamp(torch.round(xf / scale[:, None, :, None]),
                            -127, 127).to(torch.int8)
        return codes, scale
    if code_dtype == torch.uint8:
        scale = torch.clamp_min(_over(amax, INT4_MAX), INT8_SCALE_EPS)
        codes = torch.clamp(torch.round(xf / scale[:, None, :, None]),
                            -INT4_MAX, INT4_MAX).to(torch.int8)
        return pack_int4(codes), scale
    if code_dtype != torch.float8_e4m3fn:
        raise ValueError(f"no quantized code dtype {code_dtype}")
    scale = torch.clamp_min(_over(amax, FP8_MAX), INT8_SCALE_EPS)
    return (xf / scale[:, None, :, None]).to(code_dtype), scale


def dequantize_blocks(codes: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks` (up to its rounding); uint8 codes
    unpack to the full head dim first."""
    if codes.dtype == torch.uint8:
        codes = unpack_int4(codes)
    return (codes.to(torch.float32) * scale[:, None, :, None]).to(dtype)


def quantized_append(pool: Dict[str, torch.Tensor], new_k: torch.Tensor,
                     new_v: torch.Tensor, touched: torch.Tensor,
                     filled: torch.Tensor, wt: torch.Tensor, wo: torch.Tensor,
                     measure_error: bool = False) -> torch.Tensor:
    """Append one step's tokens to a quantized pool layer IN PLACE,
    requantizing every block the step writes: dequantize the touched
    blocks, scatter the new rows at their offsets, zero the rows at or past
    each block's ``filled`` count, requantize, write codes and scales back.

    ``touched`` (T,) int64: the physical blocks the step writes, deduped on
    the host (packed chunk rows share blocks, and every row of a block must
    be staged before the block is requantized once), padded with the
    scratch block; ``filled`` (T,): valid tokens in each after the step;
    ``wt``/``wo`` (tokens,) int64: each new token's touched index and
    in-block offset (invalid tokens point at the trailing pad entry, whose
    ``filled`` is 0). ``new_k``/``new_v`` (tokens, kv, d).

    Only exclusively-owned blocks are written (copy-on-write gives a slot
    its own copy first). Returns the largest |dequantized - staged| over
    the live rows when ``measure_error``, else an exact 0.0, as a 0-d fp32
    tensor on the pool's device."""
    bs = pool["k"].shape[1]
    n_touched = touched.shape[0]
    device = pool["k"].device
    rows_live = (torch.arange(bs, device=device)[None, :]
                 < filled[:, None])[..., None, None]
    qerr = torch.zeros((), dtype=torch.float32, device=device)
    for name, new in (("k", new_k), ("v", new_v)):
        codes, scale = pool[name], pool[name + "_scale"]
        raw = codes.view(torch.uint8)    # one-byte codes move as bytes
        staged = dequantize_blocks(raw[touched].view(codes.dtype),
                                   scale[touched])
        flat = staged.view(n_touched * bs, *staged.shape[2:])
        flat[wt * bs + wo] = new.to(torch.float32)
        staged = torch.where(rows_live, staged, 0.0)
        q_codes, q_scale = quantize_blocks(staged, codes.dtype)
        if measure_error:
            err = (staged - dequantize_blocks(q_codes, q_scale)).abs()
            qerr = torch.maximum(qerr, torch.where(rows_live, err, 0.0).max())
        raw[touched] = q_codes.view(torch.uint8)
        scale[touched] = q_scale
    return qerr


# -- fleet block shipping (export/import of physical blocks) -----------------

def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``'float32'``, ``'bfloat16'``): the
    spelling the JAX package's fingerprint hashes."""
    return str(dtype).replace("torch.", "")


def kv_fingerprint(cfg: TransformerConfig, scfg: ServingConfig) -> str:
    """Compatibility fingerprint of a pool's BLOCK PAYLOAD layout — the
    namespace of the fleet KV plane's bucket, equal to the JAX package's
    for the same geometry. Two engines may exchange block bytes iff their
    fingerprints match: same per-block geometry (block_size, kv_heads,
    d_head, n_layers) and storage (model dtype or quantized codes). What
    does not change a block's bytes (n_blocks, slots, chunking, spec_k)
    is left out, so differently sized pools share."""
    parts = (cfg.n_layers, cfg.kv_heads, cfg.d_head, _dtype_name(cfg.dtype),
             scfg.block_size, scfg.kv_dtype or "model")
    return hashlib.blake2b(repr(parts).encode(), digest_size=8).hexdigest()


def block_payload_nbytes(cfg: TransformerConfig, scfg: ServingConfig) -> int:
    """Exact byte length of one exported block payload: the importer's
    gate (a payload of any other length is a miss, never written). A
    payload is every byte of one block, codes and scales, so this is
    :func:`kv_block_bytes`."""
    return kv_block_bytes(cfg, scfg)


def stage_block_arrays(pools: List[Dict[str, torch.Tensor]],
                       block: int) -> List[torch.Tensor]:
    """The non-blocking half of :func:`export_block_bytes`: a device copy
    of physical block ``block`` of every leaf, in (layer, sorted leaf name)
    order, without reading it back. The copies are enqueued on the current
    stream, behind every step already dispatched there (a micro-step
    graph replays on it too), and they are new tensors: a later in-place
    write into the pools cannot change what they hold."""
    return [layer[name][block].clone()
            for layer in pools for name in sorted(layer)]


def staged_block_to_bytes(staged: List[torch.Tensor]) -> bytes:
    """Read a :func:`stage_block_arrays` staging back as the payload
    bytes, in one device-to-host copy. Every leaf goes through its raw
    bytes (``view(torch.uint8)``), so bf16 and fp8, which numpy lacks,
    export as they are stored."""
    raw = torch.cat([leaf.reshape(-1).view(torch.uint8) for leaf in staged])
    return raw.cpu().numpy().tobytes()


def export_block_bytes(pools: List[Dict[str, torch.Tensor]],
                       block: int) -> bytes:
    """ONE physical block's bytes across every layer, in (layer, sorted
    leaf name) order: codes and scale sidecars for quantized pools, raw
    model-dtype values otherwise. Byte-identical to the JAX package's
    export of the same pool contents; round-trips through
    :func:`split_block_bytes` and :func:`write_block`."""
    return staged_block_to_bytes(stage_block_arrays(pools, block))


def _upload(arrays, device):
    """``step_graph.upload``, imported at the call: ``step_graph`` imports
    ``model``, which imports this module."""
    from tpu_task_torch.ml.serving.step_graph import upload

    return upload(arrays, device)


def _leaf_rows(leaf: torch.Tensor) -> torch.Tensor:
    """A pool leaf as (n_blocks, bytes a block) raw bytes, a view of the
    same storage."""
    return leaf.view(torch.uint8).view(leaf.shape[0], -1)


class BlockStaging:
    """Several physical blocks on their way to the host as payloads: the
    demote pass's batched, non-blocking counterpart of
    :func:`export_block_bytes`.

    The constructor uploads the block ids (:func:`step_graph.upload`),
    gathers each pool leaf's rows of those blocks with ONE
    ``index_select`` into a device buffer laid out leaf by leaf, in
    (layer, sorted leaf name) order, and, on a CUDA device, copies that
    buffer into a fresh pinned host buffer without blocking and records an
    event behind the copy. Everything is enqueued on the current stream,
    behind the programs already there, so the bytes are the pools' state
    once those have run; a later in-place write to the pools cannot change
    them. :meth:`payload` waits on that event alone, never on work
    enqueued after it, and cuts each block's payload out of the leaf
    columns in JAX's byte order. On the CPU the same gathers run without
    pinning or event. ``launches`` counts the device operations one
    staging enqueues: the id upload, a gather a leaf and the copy out."""

    def __init__(self, pools: List[Dict[str, torch.Tensor]],
                 blocks: Sequence[int]):
        device = pools[0]["k"].device
        self.n = n = len(blocks)
        leaves = [_leaf_rows(layer[name])
                  for layer in pools for name in sorted(layer)]
        self._widths = [rows.shape[1] for rows in leaves]
        idx = _upload({"blocks": (np.asarray(blocks, np.int64),
                                  torch.int64)}, device)["blocks"]
        gathered = torch.empty((n * sum(self._widths),), dtype=torch.uint8,
                               device=device)
        offset = 0
        for rows, width in zip(leaves, self._widths):
            torch.index_select(rows, 0, idx, out=gathered[
                offset:offset + n * width].view(n, width))
            offset += n * width
        self.launches = 1 + len(leaves)
        self.event = None
        if device.type == "cuda":
            host = torch.empty(gathered.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(gathered, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            gathered = host
            self.launches += 1
        self._host = gathered
        self._payloads: Optional[List[bytes]] = None

    def payload(self, i: int) -> bytes:
        """Block ``i``'s payload (the ``i``-th of ``blocks``), byte-identical
        to :func:`export_block_bytes` of the pools as the staging read
        them. The first call waits on the staging's event and cuts every
        block's payload."""
        if self._payloads is None:
            if self.event is not None:
                self.event.synchronize()
            raw = self._host.numpy()
            columns, offset = [], 0
            for width in self._widths:
                columns.append(raw[offset:offset + self.n * width].reshape(
                    self.n, width))
                offset += self.n * width
            rows = np.concatenate(columns, axis=1)
            self._payloads = [row.tobytes() for row in rows]
            self._host = None
        return self._payloads[i]


def _payload_leaves(cfg: TransformerConfig, scfg: ServingConfig):
    """(name, dtype, shape) of each leaf of one layer's payload, in order."""
    d_store = cfg.d_head // 2 if scfg.kv_dtype == "int4" else cfg.d_head
    shape = (scfg.block_size, cfg.kv_heads, d_store)
    if scfg.kv_dtype in QUANT_DTYPES:
        code = kv_code_dtype(scfg.kv_dtype)
        scale = (cfg.kv_heads,)
        return (("k", code, shape), ("k_scale", torch.float32, scale),
                ("v", code, shape), ("v_scale", torch.float32, scale))
    return (("k", cfg.dtype, shape), ("v", cfg.dtype, shape))


def split_block_bytes(data: bytes, cfg: TransformerConfig,
                      scfg: ServingConfig
                      ) -> Optional[List[Dict[str, torch.Tensor]]]:
    """Inverse of :func:`export_block_bytes`: one payload as the per-layer
    {leaf name: CPU tensor} list :func:`write_block` takes (shapes without
    the leading n_blocks axis). Returns None — a miss, never an exception
    — when the length does not match this config's layout (a foreign or
    torn object). Each leaf is a writable copy of its bytes, viewed as
    the pool's dtype (numpy has no bf16 or fp8)."""
    if len(data) != block_payload_nbytes(cfg, scfg):
        return None
    out: List[Dict[str, torch.Tensor]] = []
    offset = 0
    for _ in range(cfg.n_layers):
        layer = {}
        for name, dtype, shape in _payload_leaves(cfg, scfg):
            n = int(np.prod(shape)) * _itemsize(dtype)
            raw = np.frombuffer(data, np.uint8, count=n, offset=offset)
            layer[name] = torch.from_numpy(raw.copy()).view(dtype).reshape(
                shape)
            offset += n
        out.append(layer)
    return out


def write_blocks(pools: List[Dict[str, torch.Tensor]], dsts,
                 values: List[Dict[str, torch.Tensor]]) -> None:
    """Write imported blocks IN PLACE: ``dsts`` (N,) physical block ids,
    every ``values`` leaf with a leading N axis (the :func:`split_block_bytes`
    leaves stacked). A byte copy through ``view(torch.uint8)`` (one index
    write a leaf), so an imported block reads exactly as the publisher's
    and the pool tensors the micro-step graphs hold stay the same
    tensors. Unlike the JAX package, which pads the batch to
    ``max_blocks_per_slot`` so that XLA compiles once, only the N real
    rows are written."""
    for pool, vals in zip(pools, values):
        for name, arr in pool.items():
            idx = torch.as_tensor(dsts, dtype=torch.int64, device=arr.device)
            src = vals[name].to(arr.device, arr.dtype)
            arr.view(torch.uint8)[idx] = src.view(torch.uint8)


def write_block_payloads(pools: List[Dict[str, torch.Tensor]], dsts,
                         payloads: List[bytes]) -> None:
    """:func:`write_blocks` straight from payload bytes, each of
    :func:`block_payload_nbytes` (the caller checks): the N payloads and
    the destination ids go to the device through one fresh pinned buffer
    in ONE non-blocking copy (:func:`step_graph.upload`), so an import
    adds no wait for the programs already on the stream, and each leaf's
    rows are then written from their byte columns (one ``index_copy_`` a
    leaf), in the payload's (layer, sorted leaf name) order. The same
    bytes land where :func:`split_block_bytes` and :func:`write_blocks`
    would put them."""
    host = np.frombuffer(b"".join(payloads), np.uint8).reshape(
        len(payloads), -1)
    t = _upload({"raw": (host, torch.uint8),
                 "dsts": (np.asarray(dsts, np.int64), torch.int64)},
                pools[0]["k"].device)
    offset = 0
    for pool in pools:
        for name in sorted(pool):
            rows = _leaf_rows(pool[name])
            n = rows.shape[1]
            rows.index_copy_(0, t["dsts"], t["raw"][:, offset:offset + n])
            offset += n


def write_block(pools: List[Dict[str, torch.Tensor]], dst: int,
                values: List[Dict[str, torch.Tensor]]) -> None:
    """Write one imported block's :func:`split_block_bytes` values into
    physical block ``dst`` of every layer, in place."""
    write_blocks(pools, [dst], [{name: leaf[None] for name, leaf in
                                 layer.items()} for layer in values])


class BlockAllocator:
    """Host-side refcounted free list over the physical blocks (block 0 is
    scratch). ``alloc`` hands out blocks at refcount 1, shared-prefix
    mappings ``incref``, releases ``decref``; a block at refcount 0 returns
    to the free list unless the prefix cache ``retain``-ed it. Tracks the
    high-water mark of referenced blocks. A retained refcount-0 block may
    also carry a ``demoted`` mark (its bytes have a host-tier copy, which
    makes it eviction's first victim); ``incref`` cancels the mark. The
    engine's demotion marks a block once its bytes are on the host tier."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(f"n_blocks must be >= 2, got {n_blocks}")
        self.n_blocks = n_blocks
        # Pop from the tail → lowest block numbers first (determinism aid).
        self._free = list(range(n_blocks - 1, SCRATCH_BLOCK, -1))
        self._ref: Dict[int, int] = {}     # block -> refcount (>= 1)
        self._retained: set = set()        # refcount-0 blocks the cache holds
        self._demoted: set = set()         # retained blocks with a host copy
        self.high_water = 0

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Blocks off the free list — referenced or cache-retained."""
        return (self.n_blocks - 1) - len(self._free)

    @property
    def referenced(self) -> int:
        """Blocks some slot still holds (0 after a full drain)."""
        return len(self._ref)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def is_free(self, block: int) -> bool:
        return block in self._free

    def is_retained(self, block: int) -> bool:
        return block in self._retained

    def is_demoted(self, block: int) -> bool:
        return block in self._demoted

    @property
    def demoted(self) -> int:
        """Retained refcount-0 blocks whose bytes also live on the host
        tier: the instantly evictable set."""
        return len(self._demoted)

    def mark_demoted(self, block: int) -> None:
        """Record that ``block``'s bytes now live on the host tier; only a
        retained refcount-0 block qualifies."""
        self._check(block)
        if block not in self._retained or block in self._ref:
            raise ValueError(
                f"mark_demoted of block {block}: only retained "
                f"refcount-0 blocks demote")
        self._demoted.add(block)

    def _check(self, block: int) -> None:
        if not SCRATCH_BLOCK < block < self.n_blocks:
            raise ValueError(f"invalid block {block}")

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh blocks at refcount 1, or None (nothing allocated)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._ref[b] = 1
        self.high_water = max(self.high_water, len(self._ref))
        return got

    def incref(self, block: int) -> int:
        self._check(block)
        if block in self._free:
            raise ValueError(f"incref of free block {block}")
        self._demoted.discard(block)       # touched again: no longer cold
        self._ref[block] = self._ref.get(block, 0) + 1
        self.high_water = max(self.high_water, len(self._ref))
        return self._ref[block]

    def decref(self, block: int) -> int:
        """Drop a reference; at 0 the block frees unless retained."""
        self._check(block)
        count = self._ref.get(block, 0)
        if count < 1:
            raise ValueError(f"decref of unreferenced block {block}")
        count -= 1
        if count:
            self._ref[block] = count
        else:
            del self._ref[block]
            if block not in self._retained:
                self._free.append(block)
        return count

    def retain(self, block: int) -> None:
        """Prefix-cache hold: keep the block off the free list at ref 0."""
        self._check(block)
        if block in self._free:
            raise ValueError(f"retain of free block {block}")
        self._retained.add(block)

    def release(self, block: int) -> None:
        """Drop the cache hold (eviction); frees the block iff ref 0."""
        self._check(block)
        if block not in self._retained:
            raise ValueError(f"release of unretained block {block}")
        self._retained.discard(block)
        self._demoted.discard(block)
        if block not in self._ref:
            self._free.append(block)


def chain_block_hashes(token_ids, block_size: int) -> List[bytes]:
    """Content hash of each FULL block of ``token_ids``, chained on the
    previous block's hash — equal hashes mean equal prefixes, hence equal
    KV contents."""
    ids = np.asarray(token_ids, np.int32)
    out: List[bytes] = []
    h = b""
    for i in range(len(ids) // block_size):
        h = hashlib.blake2b(
            h + ids[i * block_size:(i + 1) * block_size].tobytes(),
            digest_size=16).digest()
        out.append(h)
    return out


class PrefixCache:
    """Content-addressed registry of full KV blocks: hash → physical block.
    Releasing slots ``register`` their full blocks; ``lookup`` maps a new
    prompt's longest cached prefix to existing blocks (incref). Refcount-0
    cached blocks stay retained and are evicted in LRU order only when the
    free list runs dry."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self._alloc = allocator
        self.block_size = block_size
        self._by_hash: Dict[bytes, int] = {}
        self._hash_of: Dict[int, bytes] = {}
        self._lru: Dict[int, int] = {}     # block -> last-touch tick
        self._tick = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._by_hash)

    def has(self, h: bytes) -> bool:
        """Whether ``h`` is cached, without an incref (the prefetch path's
        skip test)."""
        return h in self._by_hash

    def cached_block(self, h: bytes) -> Optional[int]:
        """Physical block registered under ``h``, or None; no incref, no
        LRU touch."""
        return self._by_hash.get(h)

    def _touch(self, block: int) -> None:
        self._tick += 1
        self._lru[block] = self._tick

    def lookup(self, token_ids) -> List[int]:
        """Longest cached full-block prefix of ``token_ids``; each matched
        block is incref'd and LRU-touched. The caller decrefs them if the
        admission falls through."""
        blocks: List[int] = []
        for h in chain_block_hashes(token_ids, self.block_size):
            b = self._by_hash.get(h)
            if b is None:
                break
            blocks.append(b)
        for b in blocks:
            self._alloc.incref(b)
            self._touch(b)
        return blocks

    def register(self, token_ids, table_blocks: Sequence[int]) -> int:
        """Offer a releasing slot's full blocks (``table_blocks[i]`` covers
        tokens [i·bs, (i+1)·bs)) under their chained hashes, or dedupe onto
        existing entries. Call BEFORE the caller decrefs them. Returns the
        newly registered count."""
        hashes = chain_block_hashes(token_ids, self.block_size)
        if len(hashes) != len(table_blocks):
            raise ValueError(
                f"register: {len(table_blocks)} blocks but the token ids "
                f"cover {len(hashes)} full blocks")
        new = 0
        for h, b in zip(hashes, table_blocks):
            have = self._by_hash.get(h)
            if have is not None:
                self._touch(have)
                continue
            self._by_hash[h] = b
            self._hash_of[b] = h
            self._alloc.retain(b)
            self._touch(b)
            new += 1
        return new

    def adopt(self, h: bytes, block: int) -> bool:
        """Register an ALLOCATED block imported from the fleet KV plane
        under the publisher's chained hash ``h`` (equal hashes mean equal
        token prefixes, so the imported bytes are the KV a local prefill
        would have written, up to the quantization contract). The block is
        retained like any registered one; the importing slot's reference
        comes from its allocation. Returns False, adopting nothing, when
        ``h`` is already cached."""
        if h in self._by_hash:
            self._touch(self._by_hash[h])
            return False
        self._by_hash[h] = block
        self._hash_of[block] = h
        self._alloc.retain(block)
        self._touch(block)
        return True

    def _ref0_cached(self):
        """(last touch, block) of every retained refcount-0 cached block."""
        return [(t, b) for b, t in self._lru.items()
                if self._alloc.refcount(b) == 0
                and self._alloc.is_retained(b)]

    def hot_entries(self, limit: Optional[int] = None
                    ) -> List[Tuple[bytes, int]]:
        """The publishable set: (hash, block) of every retained refcount-0
        cached block, most recently touched first. Such blocks are frozen
        (no slot writes them without a copy first), so a publish reads
        exact bytes."""
        entries = sorted(self._ref0_cached(), reverse=True)[:limit]
        return [(self._hash_of[b], b) for _, b in entries]

    def cold_entries(self, limit: int) -> List[Tuple[bytes, int]]:
        """Demotion candidates: (hash, block) of up to ``limit`` retained
        refcount-0 cached blocks not yet demoted, coldest first."""
        entries = sorted((t, b) for t, b in self._ref0_cached()
                         if not self._alloc.is_demoted(b))
        return [(self._hash_of[b], b) for _, b in entries[:limit]]

    def evict(self, n: int) -> int:
        """Evict up to ``n`` refcount-0 cached blocks back to the free list,
        demoted blocks first (their bytes survive on the host tier), then
        in LRU order; referenced blocks are never touched. Returns how
        many were reclaimed."""
        victims = sorted((not self._alloc.is_demoted(b), t, b)
                         for b, t in self._lru.items()
                         if self._alloc.refcount(b) == 0)
        freed = 0
        for _, _, b in victims[:n]:
            del self._by_hash[self._hash_of.pop(b)]
            del self._lru[b]
            self._alloc.release(b)
            self.evictions += 1
            freed += 1
        return freed

    def shared_blocks(self) -> int:
        """Registered blocks currently referenced by at least one slot."""
        return sum(1 for b in self._hash_of if self._alloc.refcount(b) > 0)
