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

# The tier-1 run puts 6 pytest-xdist workers on 8 cores. torch's default of
# one intra-op thread a core then oversubscribes them, and these tests'
# small CPU ops spend their time handing work between threads: one thread
# a worker (every worker imports this module while it collects the tests).
torch.set_num_threads(1)


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
        n_kv_heads=jcfg.n_kv_heads, moe_every=jcfg.moe_every,
        n_experts=jcfg.n_experts, moe_top_k=jcfg.moe_top_k,
        moe_capacity_factor=jcfg.moe_capacity_factor,
        moe_aux_weight=jcfg.moe_aux_weight)


def port_model(jcfg, jparams):
    """The port's (cfg, params) holding the JAX weights, on the CPU."""
    cfg = port_config(jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, ttf.params_from_jax(tree, cfg, CPU)


def serving_knobs(preset: str, **over) -> dict:
    knobs = dict(SERVING_PRESETS[preset])
    knobs.update(over)
    return knobs


#: The JAX engines' jitted step programs, by what each closes over
#: (:func:`share_jax_programs`).
_JAX_PROGRAMS: dict = {}


def share_jax_programs(engine):
    """``engine``, a JAX package ``ServingEngine``, made to run the jitted
    step programs that earlier engines of this process compiled, and
    returned. ``jax.jit`` keeps what it compiles on the function object,
    and every engine wraps its own programs, so each new engine would
    compile the same programs again. A program takes the params and pools
    as arguments and closes over configuration alone (the model config,
    the decode impl, K, the mesh, the debug flag): two programs with the
    same code over equal closed-over values are the same program."""
    for name, fn in list(vars(engine).items()):
        inner = getattr(fn, "__wrapped__", None)
        if not name.endswith("_fn") or inner is None:
            continue
        key = (name, inner.__code__, repr(
            [cell.cell_contents for cell in inner.__closure__ or ()]))
        setattr(engine, name, _JAX_PROGRAMS.setdefault(key, fn))
    return engine
