"""The port's pipeline-parallel train step (``train.make_pp_train_step``)
against the JAX package's, step for step, on JAX's own pp config (vocab
64, d_model 16, 4 layers, tokens (8, 9)): pp 4 at 4 microbatches and (dp
2, pp 2) at 2, one SPMD group of 4 gloo ranks; JAX runs its step on this
process's host devices. Also the layout helpers (``pp_stack_params``,
``pp_unstack_params``, ``init_pp_state`` from a key) and the step's
refusals.

Tolerances, the port's mesh-step ones: after each of three steps, loss
and grad norm within 1e-5 and each rank's blocks (stage leaves, replicated
leaves, moments) within 2e-5 of JAX's pp state; against JAX's sequential
one-device step within JAX's own 1e-4."""

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
from tpu_task_torch.ml.parallel import mesh as tmesh
from tpu_task_torch.ml.parallel.sharding import spec_leaves
from tpu_task_torch.ml.tree import leaves

import torch_pp_cases as cases
from test_torch_train_mesh import ATOL, PARAM_ATOL, _check_rank_blocks
from torch_spmd_util import SpmdGroup

PP_MODEL = dict(vocab_size=64, d_model=16, n_layers=4, n_heads=2, d_head=8,
                d_ff=32)
SEQ_ATOL = 1e-4
STEPS = 3
LEGS = {"pp4_m4": (("pp",), (4,), 4), "dp2_pp2_m2": (("dp", "pp"), (2, 2), 2)}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with SpmdGroup(4, tmp_path_factory.mktemp("spmd")) as g:
        yield g


def pp_tokens():
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 9), 0,
                                         64))


def jcfg():
    return jtf.TransformerConfig(dtype=jnp.float32, **PP_MODEL)


def port_pp_numpy(jstate):
    """JAX's pp state as the port's numpy pipeline ``TrainState``."""
    cfg = ttf.TransformerConfig(dtype=torch.float32, **PP_MODEL)
    return ttrain.state_to_numpy(ttrain.state_from_jax(
        jax.tree.map(np.asarray, jstate), cfg, device="cpu"))


def jax_pp_steps(names, sizes, n_micro, steps=STEPS):
    """JAX's pp step on the same mesh shape: the state and metrics after
    each step."""
    cfg = jcfg()
    jm = jmesh.make_mesh(int(np.prod(sizes)), axis_names=names,
                         axis_sizes=sizes)
    state = jtrain.init_pp_state(jax.random.PRNGKey(0), cfg, sizes[-1])
    state, _ = jtrain.shard_pp_state(state, jm)
    step = jtrain.make_pp_train_step(cfg, jm, n_micro, donate=False)(state)
    out = []
    for _ in range(steps):
        state, metrics = step(state, jnp.asarray(pp_tokens()))
        out.append((jax.device_get(state),
                    {k: float(v) for k, v in metrics.items()}))
    return out


@pytest.fixture(scope="module")
def sequential():
    """JAX's one-device step on the same params and tokens."""
    cfg = jcfg()
    state = jtrain.init_state(jax.random.PRNGKey(0), cfg)
    step = jtrain.make_train_step(cfg, donate=False)
    out = []
    for _ in range(STEPS):
        state, metrics = step(state, jnp.asarray(pp_tokens()))
        out.append((jax.device_get(state.params),
                    {k: float(v) for k, v in metrics.items()}))
    return out


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_pp_steps_match_jax(group, sequential, leg):
    names, sizes, n_micro = LEGS[leg]
    want = jax_pp_steps(names, sizes, n_micro)
    start = port_pp_numpy(jtrain.init_pp_state(jax.random.PRNGKey(0), jcfg(),
                                               sizes[-1]))
    ranks = group.run(cases.pp_steps, names=names, sizes=sizes,
                      model=PP_MODEL, state=start, tokens=pp_tokens(),
                      n_micro=n_micro)
    specs = spec_leaves(ttrain.pp_state_pspecs(cases.state_from_numpy(
        start)))
    for i, (jstate, jmetrics) in enumerate(want):
        seq_params, seq_metrics = sequential[i]
        for rank in ranks:
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(rank["metrics"][i][key],
                                           jmetrics[key], rtol=0, atol=ATOL,
                                           err_msg=key)
                np.testing.assert_allclose(rank["metrics"][i][key],
                                           seq_metrics[key], rtol=0,
                                           atol=SEQ_ATOL, err_msg=key)
        _check_rank_blocks([r["states"][i] for r in ranks],
                           [np.asarray(x) for x in jax.tree.leaves(jstate)],
                           specs, names, sizes, PARAM_ATOL)
        # The stages gathered back into layers: JAX's sequential step.
        whole = {name: np.concatenate([r["states"][i].params["stages"][name]
                                       for r in ranks[:sizes[-1]]])
                 for name in ranks[0]["states"][i].params["stages"]}
        params = ttrain.pp_unstack_params(
            dict(ranks[0]["states"][i].params, stages=whole))
        for got, exp in zip(jax.tree.leaves(params),
                            jax.tree.leaves(seq_params)):
            np.testing.assert_allclose(got, np.asarray(exp), rtol=0,
                                       atol=SEQ_ATOL)
    coll = ranks[0]["collectives"]
    assert coll["pipeline_hop"]["calls"] == STEPS * (n_micro
                                                     + 2 * sizes[-1] - 2)
    assert coll["pipeline_dx"]["calls"] == coll["pipeline_head"]["calls"] \
        == STEPS


def test_pp_stack_unstack_round_trips_like_jax():
    """Tensors and numpy both ways; the stacked tree is JAX's
    ``pp_stack_params`` leaf for leaf."""
    cfg = jtf.TransformerConfig(vocab_size=32, d_model=8, n_layers=4,
                                n_heads=2, d_head=4, d_ff=16,
                                dtype=jnp.float32)
    params = jtf.init(jax.random.PRNGKey(0), cfg)
    want = jtrain.pp_stack_params(params, 2)
    arrays = jax.tree.map(np.asarray, params)
    stacked = ttrain.pp_stack_params(arrays, 2)
    assert jax.tree.structure(stacked) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for got, exp in zip(jax.tree.leaves(stacked), jax.tree.leaves(want)):
        np.testing.assert_array_equal(got, np.asarray(exp))
    back = ttrain.pp_unstack_params(stacked)
    for got, exp in zip(jax.tree.leaves(back), jax.tree.leaves(arrays)):
        np.testing.assert_array_equal(got, exp)
    tensors = jax.tree.map(torch.tensor, arrays)
    round_trip = ttrain.pp_unstack_params(ttrain.pp_stack_params(tensors, 4))
    for got, exp in zip(leaves(round_trip), leaves(tensors)):
        assert torch.equal(got, exp)


def test_init_pp_state_from_a_key_is_jax_bit_for_bit():
    """From a JAX key: JAX's ``init_pp_state`` leaf for leaf, its moments
    zero; from a generator: the sequential init's params, stacked."""
    state = ttrain.init_pp_state(np.asarray(jax.random.PRNGKey(0)),
                                 ttf.TransformerConfig(dtype=torch.float32,
                                                       **PP_MODEL),
                                 2, device="cpu")
    want = jtrain.init_pp_state(jax.random.PRNGKey(0), jcfg(), 2)
    got = leaves(ttrain.state_to_numpy(state))
    assert len(got) == len(jax.tree.leaves(want))
    for a, b in zip(got, jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    cfg = ttf.TransformerConfig(dtype=torch.float32, **PP_MODEL)
    gen = ttrain.init_pp_state(torch.Generator().manual_seed(3), cfg, 4,
                               device="cpu")
    one = ttrain.init_state(torch.Generator().manual_seed(3), cfg,
                            device="cpu")
    for a, b in zip(leaves(ttrain.pp_unstack_params(gen.params)),
                    leaves(one.params)):
        assert torch.equal(a, b)


def test_pp_state_crosses_from_and_to_jax():
    """``state_from_jax`` of a stepped JAX pp state and back through
    ``state_to_numpy``: JAX's leaves, in JAX's order, bit for bit."""
    jm = jmesh.make_mesh(4, axis_names=("pp",), axis_sizes=(4,))
    state = jtrain.init_pp_state(jax.random.PRNGKey(0), jcfg(), 4)
    state, _ = jtrain.shard_pp_state(state, jm)
    state, _ = jtrain.make_pp_train_step(jcfg(), jm, 4, donate=False)(state)(
        state, jnp.asarray(pp_tokens()))
    back = port_pp_numpy(state)
    assert int(back.step) == 1 and int(back.opt_state["count"]) == 1
    restored = jax.tree.unflatten(jax.tree.structure(state), leaves(back))
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pp_state_pspecs_are_jax_leaf_for_leaf():
    jm = jmesh.make_mesh(4, axis_names=("dp", "pp"), axis_sizes=(2, 2))
    jstate = jtrain.init_pp_state(jax.random.PRNGKey(0), jcfg(), 2)
    want = jax.tree.leaves(jtrain.pp_state_pspecs(jstate, jm),
                           is_leaf=lambda x: isinstance(
                               x, jax.sharding.PartitionSpec))
    state = cases.state_from_numpy(port_pp_numpy(jstate))
    got = spec_leaves(ttrain.pp_state_pspecs(state))
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    blocks, _ = ttrain.shard_pp_state(state, tmesh.Mesh(
        (2, 2), ("dp", "pp"), rank=3))
    assert blocks.params["stages"]["wq"].shape == (1, 2, 16, 16)
    assert torch.equal(blocks.params["stages"]["wq"][0],
                       state.params["stages"]["wq"][1])
    assert blocks.params["embed"].shape == (64, 16)


def _raises_like_jax(jax_call, port_call):
    with pytest.raises(ValueError) as jax_err:
        jax_call()
    with pytest.raises(ValueError) as port_err:
        port_call()
    assert str(port_err.value) == str(jax_err.value)


def test_pp_step_refusals_match_jax():
    """JAX's ValueErrors word for word: layers that do not split into the
    stages, a MoE config; and a mesh without the axis."""
    jm = jmesh.make_mesh(4, axis_names=("pp",), axis_sizes=(4,))
    layout = tmesh.Mesh((4,), ("pp",))
    odd = dict(PP_MODEL, n_layers=3)
    _raises_like_jax(
        lambda: jtrain.make_pp_train_step(
            jtf.TransformerConfig(dtype=jnp.float32, **odd), jm, 4),
        lambda: ttrain.make_pp_train_step(
            ttf.TransformerConfig(dtype=torch.float32, **odd), layout, 4))
    moe = dict(PP_MODEL, moe_every=2, n_experts=4)
    _raises_like_jax(
        lambda: jtrain.make_pp_train_step(
            jtf.TransformerConfig(dtype=jnp.float32, **moe), jm, 4),
        lambda: ttrain.make_pp_train_step(
            ttf.TransformerConfig(dtype=torch.float32, **moe), layout, 4))
    params = jtf.init(jax.random.PRNGKey(0), jcfg())
    _raises_like_jax(
        lambda: jtrain.pp_stack_params(params, 3),
        lambda: ttrain.pp_stack_params(jax.tree.map(np.asarray, params), 3))
    with pytest.raises(ValueError, match="no 'pp' axis"):
        ttrain.make_pp_train_step(
            ttf.TransformerConfig(dtype=torch.float32, **PP_MODEL),
            tmesh.Mesh((4,), ("dp",)), 4)
