"""The JAX key schedule in torch: threefry2x32, bit for bit.

Sampled serving streams are keyed by ``fold_in(request_key, token_index)``
and the router hands every replica raw two-word ``uint32`` keys, so a
stream is only reproducible across the JAX package and this port if both
draw the SAME random bits from the same key. This module reimplements the
pieces of ``jax.random`` the serving path uses, matching jax 0.9.0 with
``jax_threefry_partitionable=True`` (its default) on raw ``(2,)`` keys:
:func:`PRNGKey`, :func:`fold_in`, :func:`split`, :func:`random_bits`
(32-bit), :func:`uniform`, :func:`gumbel`, :func:`categorical` and
:func:`normal` (with the XLA CPU ``log1p`` and ``erf_inv`` it draws
through, so preset weights drawn here equal the JAX package's).

Keys and bits are ``int64`` tensors holding ``uint32`` values (torch's
``uint32`` dtype lacks the shift and add kernels this needs); every
function runs on the device of its key, so the sampler stays on the card.
Batched keys ``(..., 2)`` map over their leading dims the way ``jax.vmap``
maps the scalar functions."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

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


# -- jax.random.normal --------------------------------------------------------
#
# XLA's CPU backend computes float32 ``erf_inv`` (and the ``log1p`` inside
# it) with its own polynomials, and LLVM fuses each multiply feeding an add
# into one FMA. The functions below repeat that arithmetic operation for
# operation: an FMA rounds once (:func:`_fma`), every other step is a
# float32 torch op, and ``sqrt`` and the one division run in float64 and
# round once (exact for float32 inputs), because torch's float32 ``sqrt``
# on the CPU is not always correctly rounded.

_INF64 = float("inf")


def _f32(value: float) -> float:
    return float(np.float32(value))


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a hardware FMA rounds. The
    product of two float32 values is exact in float64; the float64 sum is
    rounded to odd (Boldo-Melquiond) before the one rounding to float32,
    which makes the double rounding exact."""
    a64 = a.double() if torch.is_tensor(a) else a
    b64 = b.double() if torch.is_tensor(b) else b
    c64 = (c.double() if torch.is_tensor(c)
           else torch.tensor(c, dtype=torch.float64))
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)               # exact: p + c - s
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, _INF64)
    toward = torch.where(err > 0, inf, -inf)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


#: XLA CPU's float32 ``log`` polynomial (Cephes ``logf``): three degree-2
#: pieces, combined in powers of x^3.
_LOG_C = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, -1.2420140846e-1, 1.4249322787e-1,
    2.0000714765e-1, -2.4999993993e-1, 1.1676998740e-1, -1.6668057665e-1,
    3.3333331174e-1))


def _xla_log(u: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` of positive finite ``u`` as XLA's CPU backend
    computes it: frexp into a mantissa in [sqrt(1/2), sqrt(2)) and an
    exponent, the Cephes polynomial, the exponent times ln 2 split in
    two parts."""
    bits = torch.clamp_min(u, _F32_TINY).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    mant = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = mant < _f32(0.707106769)
    x = (mant - 1.0) + torch.where(small, mant, torch.zeros_like(mant))
    e = torch.where(small, e - 1.0, e)
    z = x * x
    z3 = z * x
    c = _LOG_C
    p3 = _fma(_fma(x, c[0], c[1]), x, c[6])
    p4 = _fma(_fma(x, c[2], c[3]), x, c[7])
    p5 = _fma(_fma(x, c[4], c[5]), x, c[8])
    p7 = _fma(_fma(p3, z3, p4), z3, p5)
    r = _fma(p7, z3, e * _f32(-2.12194440e-4))
    r = _fma(torch.full_like(z, -0.5), z, x) + r
    return _fma(e, _f32(0.693359375), r)


#: XLA's ``log1p`` rational function for |x| < sqrt(2) - 1 (Cephes).
_LOG1P_DEN = tuple(_f32(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))
_LOG1P_NUM = tuple(_f32(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``jnp.log1p`` as XLA's CPU backend computes it (jax 0.9.0):
    a rational function for |x| < sqrt(2) - 1, else :func:`_xla_log` of
    ``x + 1``. Bit-identical over every input ``-u * u`` that
    :func:`normal` feeds it; for x > -1 only (what ``erf_inv`` needs)."""
    x = x.float()
    x2 = x * x
    den = torch.full_like(x, _LOG1P_DEN[0])
    num = torch.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_DEN[1:]:
        den = _fma(den, x, c)
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, x, c)
    ratio = (num.double() / den.double()).float()
    small = x + _fma(torch.full_like(x, -0.5), x2, (x * x2) * ratio)
    return torch.where(x.abs() < _f32(0.41421356237309504880), small,
                       _xla_log(x + 1.0))


#: XLA's ``ErfInv32`` (Giles' single-precision approximation): the degree-8
#: polynomial coefficients for w < 5 and for w >= 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613, 0.00943887047,
               1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor, log1p_value: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """float32 ``jax.lax.erf_inv`` on XLA's CPU backend, for |x| < 1:
    w = -log1p(-x^2), a Horner polynomial in w - 2.5 (w < 5) or sqrt(w) - 3,
    times x. ``log1p_value`` stands in for :func:`log1p` of ``x * -x``
    (the tests feed JAX's own to hold this stage alone)."""
    x = x.float()
    w = -(log1p(x * -x) if log1p_value is None else log1p_value.float())
    lt = w < 5.0
    root = torch.sqrt(w.double().clamp_min(0.0)).float()
    w = torch.where(lt, w - 2.5, root - 3.0)
    lt5 = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    ge5 = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, torch.where(lt, lt5[i], ge5[i]))
    return p * x


def normal(key: KeyLike, shape: Sequence[int]) -> torch.Tensor:
    """float32 ``jax.random.normal(key, shape)``, bit for bit (jax 0.9.0 on
    the CPU): uniforms in (-1, 1) through ``sqrt(2) * erf_inv``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return erf_inv(u) * _f32(math.sqrt(2.0))


def randint(key: KeyLike, shape: Sequence[int], minval, maxval
            ) -> torch.Tensor:
    """int32 ``jax.random.randint(key, shape, minval, maxval)``, bit for bit
    (jax 0.9.0, 64-bit mode off): the key split in two, two 32-bit
    ``random_bits`` draws ``hi`` and ``lo``, and ``(hi % span * m + lo %
    span) % span`` in wrapping uint32 arithmetic with ``m = (2^16 % span)^2
    % span``, added to ``minval``. The square wraps too: past a span of
    2^16 it is 2^32, so ``m`` is 0 and the draw is ``lo % span``, as in
    JAX. ``minval`` and ``maxval`` are int32 values (JAX refuses wider
    ones) that broadcast against ``shape``; a span of 0 or less draws
    ``minval``."""
    key = as_key(key)
    k1, k2 = split(key)
    shape = tuple(shape)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    low = torch.as_tensor(minval, device=key.device).to(torch.int64)
    high = torch.as_tensor(maxval, device=key.device).to(torch.int64)
    span = torch.where(high <= low, torch.ones_like(high), high - low)
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & MASK) % span
    offset = (((hi % span) * multiplier) & MASK) + lo % span
    offset = (offset & MASK) % span
    return (low + offset).to(torch.int32)
