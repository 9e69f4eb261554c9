"""The port's threefry key schedule (``tpu_task_torch.ml.random``) is
bit-identical to ``jax.random`` (jax 0.9.0, partitionable threefry) on raw
(2,) uint32 keys: keys, splits, fold-ins, 32-bit bits and uniforms compare
word for word, categorical draws index for index. Gumbel noise agrees to
within one float32 rounding of each log (the two libraries' logs may round
differently), which never moves a categorical draw in these sweeps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task_torch.ml import random as R

SEEDS = [0, 1, 42, 2**31 - 1, 2**31 + 3, -5]


def _same(jax_words, port_words):
    np.testing.assert_array_equal(np.asarray(jax_words, np.uint32),
                                  R.key_to_numpy(port_words))


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in(seed):
    k, tk = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    _same(k, tk)
    for num in (1, 2, 7):
        _same(jax.random.split(k, num), R.split(tk, num))
    for data in (0, 1, 12345, 2**32 - 1):
        _same(jax.random.fold_in(k, data), R.fold_in(tk, data))
    keys = jax.random.split(k, 5)
    _same(jax.vmap(jax.random.fold_in)(keys, jnp.arange(5) * 3),
          R.fold_in(R.split(tk, 5), torch.arange(5) * 3))


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 7), (2, 3, 4), (1000,)])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits_and_uniform(seed, shape):
    k, tk = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    _same(jax.random.bits(k, shape, jnp.uint32), R.random_bits(tk, shape))
    u = np.asarray(jax.random.uniform(k, shape))
    np.testing.assert_array_equal(u.view(np.uint32),
                                  R.uniform(tk, shape).numpy().view(np.uint32))
    g = np.asarray(jax.random.gumbel(k, shape))
    np.testing.assert_allclose(R.gumbel(tk, shape).numpy(), g, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("vocab", [2, 64, 256, 3000])
def test_categorical(seed, vocab):
    k, tk = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    logits = np.random.default_rng(abs(seed) % 1000 + vocab).normal(
        size=(6, vocab)).astype(np.float32) * 3
    # One key over a (batch, vocab) array, as generate draws...
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(k, jnp.asarray(logits))),
        R.categorical(tk, torch.tensor(logits)).numpy())
    # ...and one key per row, as the engine's vmapped sampler draws.
    keys = jax.random.split(k, 6)
    want = jax.vmap(lambda kk, row: jax.random.categorical(kk, row))(
        keys, jnp.asarray(logits))
    np.testing.assert_array_equal(
        np.asarray(want), R.categorical(R.split(tk, 6),
                                        torch.tensor(logits)).numpy())


def test_batched_keys_must_match_rows():
    with pytest.raises(ValueError, match="batched keys"):
        R.categorical(R.split(R.PRNGKey(0), 3), torch.zeros(4, 8))
