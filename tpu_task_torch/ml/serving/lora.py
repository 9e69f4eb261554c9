"""Paged LoRA adapters — the counterpart of ``tpu_task/ml/serving/lora.py``.

A tenant's fine-tune is a pair of thin matrices a layer, ``h += ((x @ A) *
scale) @ B`` with ``A: (d, r)``, ``B: (r, d)``, ``r << d``, applied as a
parallel branch around each unmodified transformer block of every fused
step (:func:`~tpu_task_torch.ml.serving.model._multitoken_features`). One
engine holds many tenants resident and mixes them in one batch.

Adapter weights live in one device pool of fixed-shape blocks,
``(n_adapter_blocks, 2, rank, d_model)`` in the model dtype: one block
holds one layer of one adapter, ``[b, 0]`` its Aᵀ (rank, d) and ``[b, 1]``
its B (rank, d). A second
:class:`~tpu_task_torch.ml.serving.cache.BlockAllocator` hands the blocks
out, so an adapter occupies ``n_layers`` blocks and a slot's gather is a
(slots, n_layers) table, the adapter analogue of a KV block table. Block 0
is the all-zero scratch block: an adapter-less row points at it (or
carries scale 0) and its delta is an exact 0.0, so its stream is the one a
LoRA-free engine gives. The engine writes the pool in place and never
rebinds it, so a captured K-step graph reads the adapters loaded after
its capture.

:func:`apply_lora` is row-independent: a row's delta depends on its own
block and scale only, whoever shares its step. The packing, payload and
hash helpers are plain numpy copies of the JAX package's: the same
adapter gives the same bytes and the same hash in both packages, so
replicas of either share one fleet bucket and a router sees one hash."""

from __future__ import annotations

import hashlib
from typing import List, Tuple

import numpy as np
import torch

__all__ = [
    "adapter_bytes",
    "adapter_fingerprint",
    "adapter_payload",
    "apply_lora",
    "gather_tables",
    "init_adapter_pool",
    "lora_pool_bytes",
    "pack_adapter",
    "split_adapter_payload",
    "validate_lora_tables",
]


def init_adapter_pool(n_adapter_blocks: int, rank: int, d_model: int,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """The device adapter pool: ``(n_adapter_blocks, 2, rank, d_model)``
    zeros. Axis 1 is the (Aᵀ, B) pair; block 0 is the scratch block every
    adapter-less table row points at, never allocated."""
    return torch.zeros((n_adapter_blocks, 2, rank, d_model), dtype=dtype,
                       device=device)


def apply_lora(x: torch.Tensor, pool: torch.Tensor, blocks: torch.Tensor,
               scales: torch.Tensor) -> torch.Tensor:
    """The per-row LoRA delta: ``x + apply_lora(x, ...)`` is ``h += ((x @
    A) * scale) @ B`` for each row. ``x`` (rows, w, d) the layer's input;
    ``blocks`` (rows,) integer, each row's adapter block for this layer (0
    is the scratch block, an exact 0.0); ``scales`` (rows,) float32, cast
    to ``x.dtype`` before it multiplies the shrink, as in the JAX package.
    One gather of the pool, then the shrink and the expand as two batched
    products over the rows."""
    ab = pool[blocks.to(torch.int64)]            # (rows, 2, rank, d)
    a, b = ab[:, 0], ab[:, 1]
    shrink = torch.bmm(x, a.transpose(1, 2))     # (rows, w, rank)
    return torch.bmm(shrink * scales.to(x.dtype)[:, None, None], b)


def pack_adapter(layers, rank: int, d_model: int,
                 dtype=np.float32) -> np.ndarray:
    """One adapter's per-layer (A, B) pairs in the pool's block layout,
    (n_layers, 2, rank, d_model). ``layers`` holds one ``{"a": (d, r),
    "b": (r, d)}`` dict (or (A, B) tuple) a layer with any ``r <= rank``:
    a smaller rank zero-pads, and the padded rows add exact zeros."""
    blocks = np.zeros((len(layers), 2, rank, d_model), dtype)
    for i, layer in enumerate(layers):
        if isinstance(layer, dict):
            a, b = layer["a"], layer["b"]
        else:
            a, b = layer
        a = np.asarray(a, dtype)
        b = np.asarray(b, dtype)
        if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(
                f"layer {i}: A must be (d, r) and B (r, d) with matching "
                f"r, got {a.shape} and {b.shape}")
        r = a.shape[1]
        if r > rank:
            raise ValueError(
                f"layer {i}: adapter rank {r} exceeds the pool rank "
                f"{rank} (ServingConfig.lora_rank)")
        if a.shape[0] != d_model or b.shape[1] != d_model:
            raise ValueError(
                f"layer {i}: adapter width {a.shape[0]}x{b.shape[1]} "
                f"does not match d_model {d_model}")
        blocks[i, 0, :r] = a.T
        blocks[i, 1, :r] = b
    return blocks


def adapter_payload(blocks: np.ndarray, scale: float) -> bytes:
    """A packed adapter and its scale as the bytes the fleet bucket
    stores: a 4-byte header length, the header (shape, dtype, scale) and
    the raw block bytes."""
    header = repr((tuple(int(s) for s in blocks.shape),
                   str(blocks.dtype), float(scale))).encode()
    return (len(header).to_bytes(4, "little") + header
            + np.ascontiguousarray(blocks).tobytes())


def split_adapter_payload(data: bytes) -> Tuple[np.ndarray, float]:
    """The inverse of :func:`adapter_payload`. A malformed or foreign
    payload raises ValueError: a torn bucket object must never load as
    weights."""
    if len(data) < 4:
        raise ValueError("truncated adapter payload")
    hlen = int.from_bytes(data[:4], "little")
    header = data[4:4 + hlen].decode()
    shape, dtype, scale = eval(header, {"__builtins__": {}})  # noqa: S307
    blocks = np.frombuffer(data[4 + hlen:], np.dtype(dtype))
    if blocks.size != int(np.prod(shape)):
        raise ValueError(
            f"adapter payload size mismatch: header claims {shape}, "
            f"got {blocks.size} elements")
    return blocks.reshape(shape).copy(), float(scale)


def adapter_fingerprint(blocks: np.ndarray, scale: float) -> str:
    """Content hash of a packed adapter and its scale: the bucket key and
    the registry's identity (the same weights and scale hash alike on any
    replica, so a re-register ships nothing)."""
    return hashlib.blake2b(
        adapter_payload(blocks, scale), digest_size=16).hexdigest()


def adapter_bytes(n_layers: int, rank: int, d_model: int,
                  itemsize: int = 4) -> int:
    """Device bytes one resident adapter occupies (its ``n_layers``
    blocks)."""
    return n_layers * 2 * rank * d_model * itemsize


def validate_lora_tables(blocks: np.ndarray, n_blocks: int) -> None:
    """Host check before the tables go to the device: every entry is the
    scratch block or a pool block (a CUDA gather out of range asserts on
    the device, where XLA would clamp)."""
    arr = np.asarray(blocks)
    if arr.size and (arr.min() < 0 or arr.max() >= n_blocks):
        raise ValueError(
            f"adapter block table entry out of range [0, {n_blocks})")


def lora_pool_bytes(n_adapter_blocks: int, rank: int, d_model: int,
                    itemsize: int = 4) -> int:
    """Total device bytes of the adapter pool."""
    return n_adapter_blocks * 2 * rank * d_model * itemsize


def gather_tables(slot_blocks: np.ndarray, rows: List[int]) -> np.ndarray:
    """Per-slot adapter tables (slots, n_layers) expanded to per-row
    tables of a packed step: ``rows[i]`` is the slot that owns row i (-1,
    no owner: the scratch block)."""
    out = np.zeros((len(rows), slot_blocks.shape[1]), np.int32)
    for i, slot in enumerate(rows):
        if slot >= 0:
            out[i] = slot_blocks[slot]
    return out
