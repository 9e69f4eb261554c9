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
(which the port does not import), trimmed to what this slice runs: the
host-tier demotion marks and fleet-KV adoption come with those slices."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_task_torch.ml.models.transformer import TransformerConfig

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


def _not_ported(knob: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"ServingConfig({knob}) is not ported to tpu_task_torch yet: "
        f"ROADMAP {item}")


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
    (a captured CUDA graph of the K-step loop on a CUDA device).

    Knobs of later slices (bucketed prefill, speculative decoding, the
    async loop, the host tier, LoRA) keep their fields so
    configs carry over, and raise NotImplementedError naming their ROADMAP
    item when set."""

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
        if self.prefill not in ("chunked", "bucketed"):
            raise ValueError(
                f"prefill must be 'chunked' or 'bucketed', got "
                f"{self.prefill!r}")
        if self.chunk_tokens < 1:
            raise ValueError(
                f"chunk_tokens must be >= 1, got {self.chunk_tokens}")
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
        if self.host_offload_blocks < 0:
            raise ValueError(
                f"host_offload_blocks must be >= 0, got "
                f"{self.host_offload_blocks}")
        if self.lora_rank < 0:
            raise ValueError(f"lora_rank must be >= 0, got {self.lora_rank}")
        if self.n_adapter_blocks < 0:
            raise ValueError(
                f"n_adapter_blocks must be >= 0, got "
                f"{self.n_adapter_blocks}")
        if self.prefill == "bucketed":
            raise _not_ported("prefill='bucketed'", "A2 (paged_prefill)")
        if self.spec_k > 0:
            raise _not_ported("spec_k > 0", "A3 (speculative decoding)")
        if self.overlap:
            raise _not_ported("overlap=True", "A5 (the async loop)")
        if self.host_offload_blocks:
            raise _not_ported("host_offload_blocks", "A9 (the host tier)")
        if self.lora_rank or self.n_adapter_blocks:
            raise _not_ported("lora_rank", "A7 (LoRA)")

    @property
    def max_blocks_per_slot(self) -> int:
        return -(-self.max_len // self.block_size)

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


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def init_pools(cfg: TransformerConfig, scfg: ServingConfig,
               device) -> List[Dict[str, torch.Tensor]]:
    """Per-layer zeroed k/v pools on ``device``: in the model dtype, or,
    with a quantized ``kv_dtype``, zero codes (int4: ``d_head / 2`` packed
    bytes) plus ``k_scale``/``v_scale`` (n_blocks, kv_heads) fp32 sidecars
    at :data:`INT8_SCALE_EPS`, so a fresh pool dequantizes to exact
    zeros."""
    shape = (scfg.n_blocks, scfg.block_size, cfg.kv_heads, cfg.d_head)
    if scfg.kv_dtype not in QUANT_DTYPES:
        return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                 "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
                for _ in range(cfg.n_layers)]
    if scfg.kv_dtype == "int4":
        if cfg.d_head % 2:
            raise ValueError(
                f"kv_dtype='int4' packs adjacent d_head pairs and needs an "
                f"even d_head, got {cfg.d_head}")
        shape = shape[:-1] + (cfg.d_head // 2,)
    code = kv_code_dtype(scfg.kv_dtype)

    def scale():
        return torch.full((scfg.n_blocks, cfg.kv_heads), INT8_SCALE_EPS,
                          dtype=torch.float32, device=device)

    return [{"k": torch.zeros(shape, dtype=code, device=device),
             "v": torch.zeros(shape, dtype=code, device=device),
             "k_scale": scale(), "v_scale": scale()}
            for _ in range(cfg.n_layers)]


def flat_pool(pool: torch.Tensor) -> torch.Tensor:
    """(n_blocks, block_size, kv, d) → (n_blocks·block_size, kv, d), a view
    of the same storage: writes through it land in the pool."""
    n, bs = pool.shape[:2]
    return pool.view(n * bs, *pool.shape[2:])


def token_slots(block_tables: torch.Tensor, positions: torch.Tensor,
                block_size: int) -> torch.Tensor:
    """Flat pool slot of each row's ``positions`` entry through its table
    row. block_tables (rows, max_blocks); positions (rows,)."""
    block = (positions // block_size).to(torch.int64)
    phys = torch.gather(block_tables.to(torch.int64), 1, block[:, None])[:, 0]
    return phys * block_size + positions % block_size


def copy_block(pools: List[Dict[str, torch.Tensor]], src: int,
               dst: int) -> None:
    """Copy physical block ``src`` to ``dst`` in every layer's pools, in
    place — the device half of copy-on-write. Generic over the layer's
    leaves, so a quantized block's scales copy with its codes."""
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


def quantize_blocks(x: torch.Tensor, code_dtype: torch.dtype = torch.int8):
    """(n, block_size, kv, d) values → (codes, (n, kv) float32 scales):
    symmetric per-(block, kv-head) quantization, the JAX package's
    arithmetic step for step (so codes and scales are bit-identical).

    int8: ``scale = amax / 127`` floored at :data:`INT8_SCALE_EPS`, codes
    rounded half to even; error ≤ scale/2. fp8 (``float8_e4m3fn``):
    ``scale = amax / FP8_MAX``, the scaled value keeps fp8's own mantissa
    (relative error). uint8 (int4): ``scale = amax / INT4_MAX``, codes
    clipped to ±7 and packed two per byte (trailing dim ``d/2``)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=(1, 3))
    if code_dtype == torch.int8:
        scale = torch.clamp_min(amax / 127.0, INT8_SCALE_EPS)
        codes = torch.clamp(torch.round(xf / scale[:, None, :, None]),
                            -127, 127).to(torch.int8)
        return codes, scale
    if code_dtype == torch.uint8:
        scale = torch.clamp_min(amax / float(INT4_MAX), INT8_SCALE_EPS)
        codes = torch.clamp(torch.round(xf / scale[:, None, :, None]),
                            -INT4_MAX, INT4_MAX).to(torch.int8)
        return pack_int4(codes), scale
    if code_dtype != torch.float8_e4m3fn:
        raise ValueError(f"no quantized code dtype {code_dtype}")
    scale = torch.clamp_min(amax / FP8_MAX, INT8_SCALE_EPS)
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


class BlockAllocator:
    """Host-side refcounted free list over the physical blocks (block 0 is
    scratch). ``alloc`` hands out blocks at refcount 1, shared-prefix
    mappings ``incref``, releases ``decref``; a block at refcount 0 returns
    to the free list unless the prefix cache ``retain``-ed it. Tracks the
    high-water mark of referenced blocks."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(f"n_blocks must be >= 2, got {n_blocks}")
        self.n_blocks = n_blocks
        # Pop from the tail → lowest block numbers first (determinism aid).
        self._free = list(range(n_blocks - 1, SCRATCH_BLOCK, -1))
        self._ref: Dict[int, int] = {}     # block -> refcount (>= 1)
        self._retained: set = set()        # refcount-0 blocks the cache holds
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

    def is_retained(self, block: int) -> bool:
        return block in self._retained

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

    def evict(self, n: int) -> int:
        """Evict up to ``n`` refcount-0 cached blocks back to the free list
        in LRU order; referenced blocks are never touched. Returns how many
        were reclaimed."""
        victims = sorted((t, b) for b, t in self._lru.items()
                         if self._alloc.refcount(b) == 0)
        freed = 0
        for _, b in victims[:n]:
            del self._by_hash[self._hash_of.pop(b)]
            del self._lru[b]
            self._alloc.release(b)
            self.evictions += 1
            freed += 1
        return freed

    def shared_blocks(self) -> int:
        """Registered blocks currently referenced by at least one slot."""
        return sum(1 for b in self._hash_of if self._alloc.refcount(b) > 0)
