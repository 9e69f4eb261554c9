"""MNIST reference models — the counterpart of ``tpu_task/ml/models/mnist.py``,
the workload of the baseline configs (``BASELINE.md`` configs 1-2, the task
script of ``bench.py``'s lifecycle bench), with the synthetic-data generator
that lets those runs go without network egress.

Every draw goes through the port's ``jax.random`` counterparts
(``tpu_task_torch.ml.random``) on the CPU, so for the same keys the weights
and data equal the JAX package's bit for bit on every device; ``init_mlp``
and ``synthetic_mnist`` then place them on ``device``, CUDA unless the
caller passes ``device="cpu"``. The model functions run on the device of
their inputs."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tpu_task_torch.device import resolve_device
from tpu_task_torch.ml import random as jrandom


def _scaled_normal(key, shape, scale: float) -> torch.Tensor:
    """``jax.random.normal(key, shape) * scale`` with the scale rounded to
    float32 first, as JAX's weakly typed constant is."""
    draw = jrandom.normal(key, shape)
    return draw * torch.tensor(scale, dtype=torch.float32, device=draw.device)


def init_mlp(rng, d_in: int = 784, d_hidden: int = 256,
             n_classes: int = 10, device=None) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    k1, k2 = jrandom.split(jrandom.as_key(rng, "cpu"))
    params = {
        "w1": _scaled_normal(k1, (d_in, d_hidden), d_in ** -0.5),
        "b1": torch.zeros((d_hidden,), dtype=torch.float32),
        "w2": _scaled_normal(k2, (d_hidden, n_classes), d_hidden ** -0.5),
        "b2": torch.zeros((n_classes,), dtype=torch.float32),
    }
    return {name: value.to(device) for name, value in params.items()}


def apply_mlp(params, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def loss_fn(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(apply_mlp(params, x), dim=-1)
    nll = -torch.gather(logp, -1, y.long()[:, None])[:, 0]
    return nll.mean()


def accuracy(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (apply_mlp(params, x).argmax(-1) == y).float().mean()


def synthetic_mnist(rng, n: int = 4096,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linearly-separable-ish synthetic digits: class-dependent mean + noise.
    ``x`` float32 (n, 784), ``y`` int32 (n,), on ``device``."""
    device = resolve_device(device)
    k1, k2 = jrandom.split(jrandom.as_key(rng, "cpu"))
    y = jrandom.randint(k1, (n,), 0, 10)
    protos = _scaled_normal(jrandom.PRNGKey(0), (10, 784), 2.0)
    x = protos[y.long()] + jrandom.normal(k2, (n, 784))
    return x.to(device), y.to(device)
