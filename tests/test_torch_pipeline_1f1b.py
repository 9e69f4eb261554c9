"""The port's 1F1B schedule (``ml/parallel/pipeline.py``'s
``pipeline_train``) against the JAX package's, on the CPU: JAX's toy MLP
stages at (P, M) = (2, 4), (4, 4), (4, 8), (dp 2, pp 2) with a head and
dx, and the flagship's blocks as stages. One SPMD group of 4 gloo ranks,
each a stage (and, on (dp 2, pp 2), a batch piece); JAX runs on this
process's host devices.

Tolerances: loss, stage and head gradients and dx within 1e-5 of JAX's
schedule (fp32 sums in another order), and within JAX's own 1e-4 of
sequential autodiff (``tests/test_ml_moe_pipeline.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.parallel.pipeline import pipeline_train
from tpu_task_torch.ml.parallel import mesh as tmesh

import torch_pp_cases as cases
from test_torch_pipeline import (
    ATOL,
    IDS,
    SCHEDULES,
    SEQ_ATOL,
    _check_stage_grads,
    _jax_mesh,
    _mse,
    _np,
    _sequential_loss,
    _stacked,
    _stage_mlp,
)
from torch_spmd_util import SpmdGroup


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with SpmdGroup(4, tmp_path_factory.mktemp("spmd")) as g:
        yield g


@pytest.mark.parametrize("n_stages,n_micro", SCHEDULES, ids=IDS)
def test_pipeline_train_matches_jax(group, n_stages, n_micro):
    """JAX's toy MLP stages (``test_1f1b_matches_sequential_autodiff``):
    loss and every stage's gradients."""
    d, batch = 8, 16
    params = _stacked(jax.random.PRNGKey(0), n_stages, d)
    x = jax.random.normal(jax.random.PRNGKey(1), (batch, d))
    targets = jax.random.normal(jax.random.PRNGKey(2), (batch, d))
    loss, grads = pipeline_train(_stage_mlp, params, x, targets, _mse,
                                 _jax_mesh(("pp",), (n_stages,)), n_micro)
    ref, ref_grads = jax.value_and_grad(
        lambda p: _sequential_loss(_stage_mlp, p, x, targets, n_stages,
                                   n_micro))(params)
    ranks = group.run(cases.train_case, names=("pp",), sizes=(n_stages,),
                      params=_np(params), x=np.asarray(x),
                      targets=np.asarray(targets), n_micro=n_micro)
    ranks = ranks[:n_stages]
    for rank in ranks:
        np.testing.assert_allclose(rank["loss"], float(loss), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(rank["loss"], float(ref), rtol=0,
                                   atol=ATOL)
    _check_stage_grads(ranks, grads, ATOL, "jax pipeline")
    _check_stage_grads(ranks, ref_grads, SEQ_ATOL, "sequential")


def test_dp_pipeline_with_a_head_matches_jax(group):
    """(dp 2, pp 2), each dp piece pipelining its own rows with a head
    after the last stage: loss, stage and head gradients and each rank's
    rows of dx against JAX's ``pipeline_train(..., head_params=...,
    batch_axes=("dp",))``."""
    d, batch, n_micro = 8, 16, 2
    params = _stacked(jax.random.PRNGKey(3), 2, d)
    head = {"w": jax.random.normal(jax.random.PRNGKey(4), (d, d)) * 0.3}
    x = jax.random.normal(jax.random.PRNGKey(5), (batch, d))
    targets = jax.random.normal(jax.random.PRNGKey(6), (batch, d))

    def head_mse(h, out, tgt):
        return _mse(out @ h["w"], tgt)

    names, sizes = ("dp", "pp"), (2, 2)
    loss, grads, head_grads, dx = pipeline_train(
        _stage_mlp, params, x, targets, head_mse, _jax_mesh(names, sizes),
        n_micro, head_params=head, batch_axes=("dp",))
    ranks = group.run(cases.train_case, names=names, sizes=sizes,
                      params=_np(params), x=np.asarray(x),
                      targets=np.asarray(targets), n_micro=n_micro,
                      head=_np(head), batch_axes=("dp",))
    layout = tmesh.Mesh(sizes, names)
    for r, rank in enumerate(ranks):
        coords = layout.coords(r)
        np.testing.assert_allclose(rank["loss"], float(loss), rtol=0,
                                   atol=ATOL)
        _check_stage_grads([rank], jax.tree.map(
            lambda g: g[coords["pp"]:coords["pp"] + 1], grads), ATOL)
        np.testing.assert_allclose(rank["head_grads"]["w"],
                                   np.asarray(head_grads["w"]), rtol=0,
                                   atol=ATOL)
        rows = slice(coords["dp"] * batch // 2, (coords["dp"] + 1) * batch
                     // 2)
        np.testing.assert_allclose(rank["dx"], np.asarray(dx)[rows], rtol=0,
                                   atol=ATOL)
        assert set(rank["collectives"]) == {"pipeline_hop", "pipeline_head",
                                            "pipeline_dx", "all_reduce"}


def test_1f1b_trains_transformer_stages(group):
    """JAX's ``test_1f1b_trains_transformer_stages``: the flagship's
    blocks as stages (one layer each), the MSE at the last stage."""
    n_stages, n_micro = 4, 4
    model = dict(vocab_size=64, d_model=16, n_layers=n_stages, n_heads=2,
                 d_head=8, d_ff=32)
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **model)
    full = jtf.init(jax.random.PRNGKey(0), jcfg)
    stage_params = jax.tree.map(lambda *leaves: jnp.stack(leaves),
                                *full["layers"])
    batch, seq = 8, 8
    tokens = jax.random.randint(jax.random.PRNGKey(1), (batch, seq), 0, 64)
    x = jtf.embed_lookup(full["embed"], tokens)
    targets = jax.random.normal(jax.random.PRNGKey(2),
                                (batch, seq, jcfg.d_model))
    from tpu_task.ml.ops.attention import mha_reference

    def stage_fn(layer, h):
        return jtf._block(h, layer, jcfg,
                          lambda q, k, v: mha_reference(q, k, v, True))[0]

    loss, grads = pipeline_train(stage_fn, stage_params, x, targets, _mse,
                                 _jax_mesh(("pp",), (n_stages,)), n_micro)
    ref, ref_grads = jax.value_and_grad(
        lambda p: _sequential_loss(stage_fn, p, x, targets, n_stages,
                                   n_micro))(stage_params)
    ranks = group.run(cases.train_case, names=("pp",), sizes=(n_stages,),
                      params=_np(stage_params), x=np.asarray(x),
                      targets=np.asarray(targets), n_micro=n_micro,
                      stage="block", model=model)
    for rank in ranks:
        np.testing.assert_allclose(rank["loss"], float(loss), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(rank["loss"], float(ref), rtol=0,
                                   atol=ATOL)
    _check_stage_grads(ranks, grads, ATOL, "jax pipeline")
    _check_stage_grads(ranks, ref_grads, SEQ_ATOL, "sequential")
