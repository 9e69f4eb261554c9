"""The port's MNIST workload (``tpu_task_torch.ml.models.mnist``) and its
``randint`` against the JAX package's: for the same keys, ``init_mlp``'s
weights, ``synthetic_mnist``'s data and ``randint``'s draws are equal bit
for bit; the loss and accuracy of the same weights on the same data agree
within 1e-6 (float32 sums taken in another order); the MLP learns, as
``tests/test_ml_models.py::test_mnist_learns`` asks of JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.models import mnist as jmnist
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.models import mnist


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (1000,)])
@pytest.mark.parametrize("span", [
    (0, 10), (-5, 5), (0, 1), (3, 3), (5, 2), (0, 65536), (0, 65537),
    (-100, 2**30 + 12345), (-2**31, 2**31 - 1), (-2**31, 0)])
@pytest.mark.parametrize("seed", [0, 42, 2**31 + 3])
def test_randint_matches_jax(seed, span, shape):
    lo, hi = span
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                         lo, hi))
    got = R.randint(R.PRNGKey(seed), shape, lo, hi).numpy()
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_randint_broadcasts_array_bounds():
    lo, hi = np.array([0, -3, 10]), np.array([5, 3, 11])
    want = jax.random.randint(jax.random.PRNGKey(5), (4, 3), lo, hi)
    got = R.randint(R.PRNGKey(5), (4, 3), torch.tensor(lo), torch.tensor(hi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,dims", [(1, {}), (4, dict(d_in=20,
                                                         d_hidden=12,
                                                         n_classes=3))])
def test_init_mlp_matches_jax(seed, dims):
    want = jmnist.init_mlp(jax.random.PRNGKey(seed), **dims)
    got = mnist.init_mlp(R.PRNGKey(seed), device="cpu", **dims)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


@pytest.fixture(scope="module")
def data():
    x, y = jmnist.synthetic_mnist(jax.random.PRNGKey(0), n=512)
    tx, ty = mnist.synthetic_mnist(R.PRNGKey(0), n=512, device="cpu")
    return (x, y), (tx, ty)


def test_synthetic_mnist_matches_jax(data):
    (x, y), (tx, ty) = data
    assert tx.shape == (512, 784) and tx.dtype == torch.float32
    assert ty.dtype == torch.int32
    np.testing.assert_array_equal(tx.numpy(), np.asarray(x))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(y))


def test_loss_and_accuracy_match_jax(data):
    (x, y), (tx, ty) = data
    params = jmnist.init_mlp(jax.random.PRNGKey(1))
    tparams = mnist.init_mlp(R.PRNGKey(1), device="cpu")
    # A trained point too: a few JAX SGD steps, loaded into the port.
    grad = jax.jit(jax.grad(jmnist.loss_fn))
    for _ in range(3):
        params = jax.tree.map(lambda p, g: p - 0.1 * g, params,
                              grad(params, x, y))
    for p, tp in ((jmnist.init_mlp(jax.random.PRNGKey(1)), tparams),
                  (params, {k: torch.tensor(np.asarray(v))
                            for k, v in params.items()})):
        np.testing.assert_allclose(float(mnist.loss_fn(tp, tx, ty)),
                                   float(jmnist.loss_fn(p, x, y)),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(mnist.accuracy(tp, tx, ty)),
                                   float(jmnist.accuracy(p, x, y)),
                                   rtol=0, atol=1e-6)


def test_mnist_learns(data):
    _, (x, y) = data
    params = {k: v.requires_grad_(True)
              for k, v in mnist.init_mlp(R.PRNGKey(1), device="cpu").items()}
    for _ in range(40):
        grads = torch.autograd.grad(mnist.loss_fn(params, x, y),
                                    list(params.values()))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p -= 0.1 * g
    assert float(mnist.accuracy(params, x, y)) > 0.9
