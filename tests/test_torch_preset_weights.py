"""The port's preset weights equal the JAX package's bit for bit.

``jax.random.normal`` draws threefry uniforms and maps them through XLA's
float32 ``erf_inv``, which on the CPU computes ``log1p`` with its own
polynomials and fuses each multiply-add. The port repeats that arithmetic
(``tpu_task_torch.ml.random.normal``), so ``init_from_key`` and with it
``build_engine`` give a preset the JAX package's own weights: a drain file
of one package's replica continues the same stream on the other's.

``log1p`` is held over every float32 input that ``normal`` can feed it
(``-u * u`` for each of the 2**23 uniforms), ``erf_inv`` over the same
uniforms given JAX's own ``log1p`` values, and the draws, the init and
the presets over several keys and shapes."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.models import transformer as jtf
from tpu_task.serve.replica import build_engine as jax_build_engine
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.models import transformer as ttf
from tpu_task_torch.serve.replica import MODEL_PRESETS, build_engine
from torch_port_util import port_config

SEEDS = [0, 1, 42, 2**31 + 3]
#: Every preset, the mixture-of-experts one among them.
PRESETS = sorted(MODEL_PRESETS)
SHAPES = [(7,), (256, 128), (33, 65), (2, 3, 50)]


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _every_uniform() -> np.ndarray:
    """Each float32 value ``uniform(key, shape, nextafter(-1, 0), 1)`` can
    take: 2**23 mantissas times 2 plus the lower bound, clamped at it."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    mant = np.arange(1 << 23, dtype=np.uint32) | np.uint32(0x3F800000)
    floats = mant.view(np.float32) - np.float32(1)
    return np.maximum(lo, floats * np.float32(2) + lo)


def _chunks(u, n=1 << 21):
    for i in range(0, len(u), n):
        yield u[i:i + n]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax_bit_for_bit(seed, shape):
    want = jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)
    got = R.normal(R.PRNGKey(seed), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_log1p_matches_xla_over_every_normal_input():
    f = jax.jit(jnp.log1p)
    for u in _chunks(_every_uniform()):
        x = u * -u
        got = R.log1p(torch.from_numpy(x.copy()))
        np.testing.assert_array_equal(_bits(got), _bits(f(x)))


def test_erf_inv_given_jax_log1p_is_bit_exact():
    """The erf_inv stage alone: fed JAX's own ``log1p`` of ``-u * u``, the
    port's polynomial gives ``sqrt(2) * erf_inv(u)`` bit for bit, over
    every uniform ``normal`` draws."""
    sqrt2 = np.float32(np.sqrt(2))
    log1p = jax.jit(jnp.log1p)
    erf_inv = jax.jit(lambda v: sqrt2 * jax.lax.erf_inv(v))
    for u in _chunks(_every_uniform()):
        given = torch.from_numpy(np.asarray(log1p(u * -u)).copy())
        got = R.erf_inv(torch.from_numpy(u.copy()), given) * float(sqrt2)
        np.testing.assert_array_equal(_bits(got), _bits(erf_inv(u)))


def test_fma_rounds_once():
    """The float32 FMA stand-in against exact rational arithmetic rounded
    once, on random operands and on sums that land on float32 ties."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=2000).astype(np.float32)
    b = rng.normal(size=2000).astype(np.float32)
    c = (rng.normal(size=2000) * 4).astype(np.float32)
    # ties: a*b a float32 value plus half an ulp of c, plus a tiny tail
    a[:500], b[:500] = np.float32(1.0), np.float32(2.0 ** -24)
    c[:500] = np.float32(1.0) + np.arange(500, dtype=np.float32) * \
        np.float32(2.0 ** -23)
    b[250:500] = np.float32(2.0 ** -24 + 2.0 ** -40)
    got = R._fma(torch.from_numpy(a), torch.from_numpy(b),
                 torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        want = np.float32(_round_to_f32(exact))
        assert _bits(g) == _bits(want), (x, y, z)


def _round_to_f32(q: Fraction) -> float:
    """Round-to-nearest-even of an exact rational to float32."""
    lo = np.float32(float(q))                     # within an ulp of q
    for cand in (np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))):
        nxt = np.nextafter(cand, np.float32(np.inf))
        fc, fn = Fraction(float(cand)), Fraction(float(nxt))
        if fc <= q <= fn:
            dc, dn = q - fc, fn - q
            if dc != dn:
                return float(cand if dc < dn else nxt)
            return float(cand if _bits(cand) % 2 == 0 else nxt)
    raise AssertionError(q)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("geometry", [
    dict(vocab_size=96, d_model=48, n_layers=3, n_heads=4, d_head=12,
         d_ff=80, n_kv_heads=2),
    dict(vocab_size=40, d_model=16, n_layers=1, n_heads=2, d_head=8,
         d_ff=24, n_kv_heads=None),
])
def test_init_from_key_matches_jax_init(geometry, seed):
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **geometry)
    want = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed), jcfg))
    got = ttf.init_from_key(R.PRNGKey(seed), port_config(jcfg))
    _assert_same_tree(got, want)


def _assert_same_tree(got, want):
    assert set(got) == set(want)
    for name in ("embed", "unembed", "final_norm"):
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]))
    assert len(got["layers"]) == len(want["layers"])
    for g, w in zip(got["layers"], want["layers"]):
        assert set(g) == set(w)
        for name in w:
            assert g[name].dtype == torch.float32
            np.testing.assert_array_equal(_bits(g[name]), _bits(w[name]))


@pytest.mark.parametrize("preset", PRESETS)
def test_build_engine_params_equal_jax(preset):
    got = build_engine(preset, device="cpu").params
    want = jax.tree.map(np.asarray, jax_build_engine(preset).params)
    _assert_same_tree(got, want)


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_engines_serve_the_same_streams(preset):
    """A JAX and a port engine of one preset name, each built by its own
    package, serve the same greedy and keyed-sampled streams."""
    jax_engine = jax_build_engine(preset, serving={"decode_impl": "xla"})
    port = build_engine(preset, device="cpu")
    vocab = port.cfg.vocab_size
    rng = np.random.default_rng(4)
    wave = [(rng.integers(0, vocab, size=n), 8,
             {"temperature": 0.8, "key": [n, 1]} if n % 2 else {})
            for n in (3, 10, 6, 17)]
    outs = []
    for engine in (jax_engine, port):
        rids = [engine.submit(p, m, **kw) for p, m, kw in wave]
        out = engine.drain()
        outs.append([out[r] for r in rids])
    assert outs[1] == outs[0]
