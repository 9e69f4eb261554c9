"""Shared fixtures of the ``test_torch_*`` files: one model preset built in
the JAX package and, from the same weights (crossing as numpy), in the
PyTorch port on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpu_task.ml.models import transformer as jtf
from tpu_task.serve.replica import MODEL_PRESETS, SERVING_PRESETS
from tpu_task_torch.ml.models import transformer as ttf

CPU = torch.device("cpu")


def jax_model(preset: str):
    """(cfg, params) of a JAX preset at fp32, as ``build_engine`` makes
    them."""
    spec = dict(MODEL_PRESETS[preset])
    seed = spec.pop("seed")
    cfg = jtf.TransformerConfig(dtype=jnp.float32, **spec)
    return cfg, jtf.init(jax.random.PRNGKey(seed), cfg)


def port_config(jcfg, dtype=torch.float32) -> ttf.TransformerConfig:
    return ttf.TransformerConfig(
        vocab_size=jcfg.vocab_size, d_model=jcfg.d_model,
        n_layers=jcfg.n_layers, n_heads=jcfg.n_heads, d_head=jcfg.d_head,
        d_ff=jcfg.d_ff, rope_theta=jcfg.rope_theta, dtype=dtype,
        n_kv_heads=jcfg.n_kv_heads)


def port_model(jcfg, jparams):
    """The port's (cfg, params) holding the JAX weights, on the CPU."""
    cfg = port_config(jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, ttf.params_from_jax(tree, cfg, CPU)


def serving_knobs(preset: str, **over) -> dict:
    knobs = dict(SERVING_PRESETS[preset])
    knobs.update(over)
    return knobs
