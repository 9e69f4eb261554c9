"""The port's sequence-parallel train step (``train.make_sp_train_step``)
against the JAX package's, step for step, on JAX's own sp configs (vocab
64, d_model 32, tokens (2, 33)) on ("sp",) meshes: one SPMD group of 4
gloo ranks, each taking the rows at full length and cutting its own
window of the sequence. JAX runs its step on the host devices of this
process.

Tolerances: after each of two steps, loss and grad norm within 1e-5 and
every rank's params within 2e-5 of JAX's (the port's mesh-step
tolerances: fp32 sums in another order, reaching the weights scaled by
lr; the params replicate over sp, so each rank holds them whole)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml import train as jtrain
from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.parallel import mesh as jmesh
from tpu_task_torch.ml import train as ttrain
from tpu_task_torch.ml.models import transformer as ttf
from tpu_task_torch.ml.parallel.sharding import spec_leaves

import torch_sp_cases as cases
from test_torch_train_mesh import (
    ATOL,
    PARAM_ATOL,
    _check_rank_blocks,
    _layout,
    _port_numpy,
)
from torch_spmd_util import SpmdGroup

SP_MODEL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
                d_ff=64)
GQA_MODEL = dict(SP_MODEL, n_kv_heads=2)
STEPS = 2


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with SpmdGroup(4, tmp_path_factory.mktemp("spmd")) as g:
        yield g


def sp_tokens(batch=2, seq=33):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1),
                                         (batch, seq), 0, 64))


def jax_sp_steps(model, names, sizes, tokens, mode, steps=STEPS):
    """JAX's sp step on the same mesh shape: the state and metrics after
    each step."""
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **model)
    jm = jmesh.make_mesh(int(np.prod(sizes)), axis_names=names,
                         axis_sizes=sizes)
    state, _ = jtrain.shard_state(jtrain.init_state(jax.random.PRNGKey(0),
                                                    jcfg), jcfg, jm)
    step = jtrain.make_sp_train_step(jcfg, jm, donate=False,
                                     context_parallel=mode)(state)
    out = []
    for _ in range(steps):
        state, metrics = step(state, jnp.asarray(tokens))
        out.append((state, {k: float(v) for k, v in metrics.items()}))
    return out


def run_sp(group, model, names, sizes, mode, tokens, **kw):
    """The port's ranks against JAX's step on the same mesh; returns the
    ranks' results."""
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **model)
    start = _port_numpy(jtrain.init_state(jax.random.PRNGKey(0), jcfg),
                        model)
    want = jax_sp_steps(model, names, sizes, tokens, mode)
    ranks = group.run(cases.sp_steps, names=names, sizes=sizes, model=model,
                      state=start, tokens=tokens, mode=mode, **kw)
    n = int(np.prod(sizes))
    assert ranks[n:] == [None] * (4 - n)
    cfg = ttf.TransformerConfig(dtype=torch.float32, **model)
    specs = spec_leaves(ttrain.state_pspecs(
        cases.state_from_numpy(start), cfg, _layout(names, sizes)))
    for i, (jstate, jmetrics) in enumerate(want):
        for rank in ranks[:n]:
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(rank["metrics"][i][key],
                                           jmetrics[key], rtol=0, atol=ATOL,
                                           err_msg=key)
        _check_rank_blocks([r["states"][i] for r in ranks[:n]],
                           [np.asarray(x) for x in jax.tree.leaves(jstate)],
                           specs, names, sizes, PARAM_ATOL)
    return ranks[:n]


@pytest.mark.parametrize("model,sp,mode", [
    (SP_MODEL, 4, "zigzag"),
    (SP_MODEL, 4, "ulysses"),
    (GQA_MODEL, 4, "zigzag"),
    (GQA_MODEL, 2, "ulysses"),
], ids=["zigzag_sp4", "ulysses_sp4", "gqa_zigzag_sp4", "gqa_ulysses_sp2"])
def test_sp_steps_match_jax(group, model, sp, mode):
    ranks = run_sp(group, model, ("sp",), (sp,), mode, sp_tokens())
    kinds = set(ranks[0]["collectives"])
    ring = {"ppermute"} if mode == "zigzag" else set()
    assert kinds == {"all_reduce", "all_to_all"} | ring
