"""The port's pipeline schedules (``ml/parallel/pipeline.py``) against the
JAX package's, on the CPU: GPipe's ``pipeline_apply``, the hops of 1F1B's
``pipeline_train`` and the ragged-batch refusals (1F1B's values are
``test_torch_pipeline_1f1b.py``'s). One SPMD group of 4 gloo ranks, each a
stage; JAX runs on this process's host devices.

Tolerances: outputs within 1e-5 of JAX's schedule (fp32 sums in another
order) and of the stages applied in turn. The hops: one call a tick, M +
2P - 2 a training step, and a rank sends bytes only on ticks where the
schedule hands it something to pass on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.parallel import mesh as jmesh
from tpu_task.ml.parallel.pipeline import pipeline_apply, pipeline_train
from tpu_task_torch.ml.parallel import mesh as tmesh
from tpu_task_torch.ml.parallel import pipeline as tpipe

import torch_pp_cases as cases
from torch_spmd_util import SpmdGroup

ATOL = 1e-5
SEQ_ATOL = 1e-4
SCHEDULES = [(2, 4), (4, 4), (4, 8)]
IDS = ["p2_m4", "p4_m4", "p4_m8"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with SpmdGroup(4, tmp_path_factory.mktemp("spmd")) as g:
        yield g


def _stage_mlp(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _mse(out, tgt):
    return jnp.mean((out.astype(jnp.float32) - tgt) ** 2)


def _stacked(key, n_stages, d, scale=0.5):
    """JAX's toy stage params: (n_stages, d, d) weights, (n_stages, d)
    biases."""
    ks = jax.random.split(key, 2 * n_stages)
    return {"w": jnp.stack([jax.random.normal(ks[2 * i], (d, d)) * scale
                            for i in range(n_stages)]),
            "b": jnp.stack([jax.random.normal(ks[2 * i + 1], (d,)) * 0.1
                            for i in range(n_stages)])}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_mesh(names, sizes):
    return jmesh.make_mesh(int(np.prod(sizes)), axis_names=names,
                           axis_sizes=sizes)


def _sequential_loss(stage_fn, params, x, targets, n_stages, n_micro,
                     loss_fn=_mse):
    """The mean of the microbatches' losses through every stage in turn."""
    micro = x.reshape(n_micro, -1, *x.shape[1:])
    micro_t = targets.reshape(n_micro, -1, *targets.shape[1:])
    total = 0.0
    for m in range(n_micro):
        h = micro[m]
        for s in range(n_stages):
            h = stage_fn(jax.tree.map(lambda p: p[s], params), h)
        total = total + loss_fn(h, micro_t[m])
    return total / n_micro


def _check_stage_grads(ranks, want, atol, err=""):
    """Each rank's (1, ...) gradient block against JAX's stage slice."""
    for s, rank in enumerate(ranks):
        for name in want:
            np.testing.assert_allclose(rank["grads"][name][0],
                                       np.asarray(want[name])[s], rtol=0,
                                       atol=atol, err_msg=f"{err} stage {s} "
                                                          f"{name}")


@pytest.mark.parametrize("n_stages,n_micro", SCHEDULES, ids=IDS)
def test_pipeline_apply_matches_jax(group, n_stages, n_micro):
    d = 16
    params = _stacked(jax.random.PRNGKey(0), n_stages, d, scale=d ** -0.5)
    x = jax.random.normal(jax.random.PRNGKey(1), (n_micro * 2, d))
    want = pipeline_apply(_stage_mlp, params, x,
                          _jax_mesh(("pp",), (n_stages,)), n_micro)
    ref = x
    for s in range(n_stages):
        ref = _stage_mlp(jax.tree.map(lambda p: p[s], params), ref)
    ranks = group.run(cases.apply_case, sizes=(n_stages,),
                      params=_np(params), x=np.asarray(x), n_micro=n_micro)
    for rank in ranks[:n_stages]:
        np.testing.assert_allclose(rank["out"], np.asarray(want), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(rank["out"], np.asarray(ref), rtol=0,
                                   atol=ATOL)
        hops = rank["collectives"]["pipeline_hop"]
        assert hops["calls"] == n_micro + n_stages - 1
    # Only the stages before the last send, one microbatch a forward.
    sent = [r["collectives"]["pipeline_hop"]["bytes"]
            for r in ranks[:n_stages]]
    assert sent == [n_micro * 2 * d * 4] * (n_stages - 1) + [0]


def _expected_hop_bytes(n_stages, n_micro, stage, piece):
    """What ``stage`` sends on each tick of 1F1B: its forward output
    unless it is the last stage, its input's gradient unless it is the
    first, each only on a tick the schedule runs it."""
    out = []
    for t in range(n_micro + 2 * (n_stages - 1)):
        f = 0 <= t - stage < n_micro
        b = 0 <= t - 2 * (n_stages - 1) + stage < n_micro
        out.append(piece * (int(f and stage < n_stages - 1)
                            + int(b and stage > 0)))
    return out


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 4)],
                         ids=["p2_m4", "p4_m4"])
def test_hops_move_nothing_on_bubble_ticks(group, n_stages, n_micro):
    """One hop call a tick (M + 2P - 2 a step) on every rank, each sending
    exactly the schedule's pieces: zero bytes on a bubble tick."""
    d, batch = 8, 16
    params = _stacked(jax.random.PRNGKey(0), n_stages, d)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (batch, d)))
    ranks = group.run(cases.train_case, names=("pp",), sizes=(n_stages,),
                      params=_np(params), x=x, targets=x, n_micro=n_micro)
    piece = batch // n_micro * d * 4
    ticks = n_micro + 2 * n_stages - 2
    for s, rank in enumerate(ranks[:n_stages]):
        assert rank["collectives"]["pipeline_hop"]["calls"] == ticks
        assert rank["hop_bytes"] == _expected_hop_bytes(n_stages, n_micro,
                                                        s, piece)
    bubble = [t for t in range(ticks)
              if all(b == 0 for b in (r["hop_bytes"][t]
                                      for r in ranks[:n_stages]))]
    assert bubble == [ticks - 1]     # stage 0's last backward sends nothing


def _raises_like_jax(jax_call, port_call):
    with pytest.raises(ValueError) as jax_err:
        jax_call()
    with pytest.raises(ValueError) as port_err:
        port_call()
    assert str(port_err.value) == str(jax_err.value)


def test_ragged_microbatches_refused_like_jax():
    """JAX's ValueErrors word for word: a batch that does not split into
    the microbatches (both schedules), and a microbatch that does not
    split over the batch axes. They come before any collective, so a
    mesh layout serves."""
    params = _stacked(jax.random.PRNGKey(0), 2, 4)
    port_params = {k: torch.tensor(np.asarray(v)[:1])
                   for k, v in params.items()}
    jm = _jax_mesh(("pp",), (2,))
    layout = tmesh.Mesh((2,), ("pp",))
    x = jnp.zeros((10, 4))
    _raises_like_jax(
        lambda: pipeline_apply(_stage_mlp, params, jnp.zeros((7, 4)), jm, 4),
        lambda: tpipe.pipeline_apply(cases.stage_mlp, port_params,
                                     torch.zeros(7, 4), layout, 4))
    _raises_like_jax(
        lambda: pipeline_train(_stage_mlp, params, x, x, _mse, jm, 3),
        lambda: tpipe.pipeline_train(cases.stage_mlp, port_params,
                                     torch.zeros(10, 4), torch.zeros(10, 4),
                                     cases.mse, layout, 3))
    jdp = _jax_mesh(("dp", "pp"), (2, 2))
    dp_layout = tmesh.Mesh((2, 2), ("dp", "pp"))
    x = jnp.zeros((12, 4))
    # Batch 12 in 4 microbatches of 3 rows, which 2 dp pieces cannot split;
    # a port rank holds its 6 rows.
    _raises_like_jax(
        lambda: pipeline_train(_stage_mlp, params, x, x, _mse, jdp, 4,
                               batch_axes=("dp",)),
        lambda: tpipe.pipeline_train(cases.stage_mlp, port_params,
                                     torch.zeros(6, 4), torch.zeros(6, 4),
                                     cases.mse, dp_layout, 4,
                                     batch_axes=("dp",)))
