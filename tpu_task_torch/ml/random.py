"""The JAX key schedule in torch: threefry2x32, bit for bit.

Sampled serving streams are keyed by ``fold_in(request_key, token_index)``
and the router hands every replica raw two-word ``uint32`` keys, so a
stream is only reproducible across the JAX package and this port if both
draw the SAME random bits from the same key. This module reimplements the
pieces of ``jax.random`` the serving path uses, matching jax 0.9.0 with
``jax_threefry_partitionable=True`` (its default) on raw ``(2,)`` keys:
:func:`PRNGKey`, :func:`fold_in`, :func:`split`, :func:`random_bits`
(32-bit), :func:`uniform`, :func:`gumbel` and :func:`categorical`.

Keys and bits are ``int64`` tensors holding ``uint32`` values (torch's
``uint32`` dtype lacks the shift and add kernels this needs); every
function runs on the device of its key, so the sampler stays on the card.
Batched keys ``(..., 2)`` map over their leading dims the way ``jax.vmap``
maps the scalar functions."""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
#: smallest positive normal float32 — ``jnp.finfo(float32).tiny``
_F32_TINY = float(np.finfo(np.float32).tiny)

KeyLike = Union[torch.Tensor, np.ndarray, Sequence[int]]


def as_key(key: KeyLike, device=None) -> torch.Tensor:
    """A raw key (``(..., 2)`` uint32 words from numpy, a list, or a
    tensor) as the int64 tensor form every function here takes."""
    if isinstance(key, torch.Tensor):
        key = key.to(torch.int64)
        return key if device is None else key.to(device)
    arr = np.asarray(key).astype(np.uint32).astype(np.int64)
    return torch.as_tensor(arr, device=device)


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    """The raw ``uint32`` words of a key (or of any bits tensor)."""
    return key.cpu().numpy().astype(np.uint32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds), elementwise over
    broadcast ``uint32``-valued int64 tensors — the body of jax's
    ``threefry2x32_p``."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: ``[0, seed mod
    2**32]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: KeyLike, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with counter ``(0, data)``.
    ``key`` (..., 2) and ``data`` (...) broadcast — the vmapped form the
    engine uses for per-slot keys."""
    key = as_key(key)
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def _counters(shape: Tuple[int, ...], device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """jax's ``iota_2x32_shape``: the row-major flat index of every
    element, as (high, low) 32-bit words."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape)
    return idx >> 32, idx & MASK


def split(key: KeyLike, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable form): (num, 2) keys."""
    key = as_key(key)
    hi, lo = _counters((num,), key.device)
    y1, y2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: KeyLike, shape: Sequence[int]) -> torch.Tensor:
    """32-bit ``jax.random.bits``: (..., *shape) for keys (..., 2)."""
    key = as_key(key)
    shape = tuple(shape)
    hi, lo = _counters(shape, key.device)
    pad = (1,) * len(shape)
    k1 = key[..., 0].reshape(key.shape[:-1] + pad)
    k2 = key[..., 1].reshape(key.shape[:-1] + pad)
    y1, y2 = threefry2x32(k1, k2, hi, lo)
    return y1 ^ y2


def uniform(key: KeyLike, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform``: 23 random mantissa bits under the
    exponent of 1.0, shifted and scaled into [minval, maxval)."""
    bits = random_bits(key, shape)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    # Filled on the device rather than copied from the host: a CUDA graph
    # of the sampler captures no host-to-device copy.
    lo = torch.full((), minval, dtype=torch.float32, device=floats.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: KeyLike, shape: Sequence[int]) -> torch.Tensor:
    """float32 ``jax.random.gumbel`` in its default ("low") mode."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: KeyLike, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (the Gumbel-max
    trick). A single (2,) key draws noise of ``logits``'s whole shape, as
    ``generate`` does; keys (n, 2) with logits (n, vocab) draw one row per
    key, as the engine's vmapped sampler does."""
    key = as_key(key, logits.device)
    if key.dim() == 1:
        noise = gumbel(key, logits.shape)
    else:
        if key.shape[:-1] != logits.shape[:-1]:
            raise ValueError(
                f"batched keys {tuple(key.shape)} do not match logits "
                f"{tuple(logits.shape)}")
        noise = gumbel(key, logits.shape[-1:])
    return torch.argmax(noise + logits.to(torch.float32), dim=-1)
