"""Checkpoints of a pipeline-parallel train state across SPMD ranks and
across packages, on the CPU: one group of 4 gloo ranks. A pipeline state
needs no format of its own: each rank saves its ``(1, layers_per_stage,
...)`` block of every stage leaf keyed by its global range under
``pp_state_pspecs`` (the replicated embedding and head once), so JAX's
``restore_checkpoint_sharded`` reads the port's save into its pp
``TrainState``, a one-process port state reads it whole, and JAX's save of
its pp state restores into the port's ranks. Values cross bit for
bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml import checkpoint as jckpt
from tpu_task.ml import train as jtrain
from tpu_task.ml.parallel import mesh as jmesh
from tpu_task_torch.ml import checkpoint as tckpt
from tpu_task_torch.ml import train as ttrain
from tpu_task_torch.ml.models import transformer as ttf
from tpu_task_torch.ml.parallel.sharding import spec_leaves
from tpu_task_torch.ml.tree import leaves

import torch_pp_cases as cases
from test_torch_pp_train import PP_MODEL, jcfg, port_pp_numpy, pp_tokens
from test_torch_train_mesh import _check_rank_blocks
from torch_spmd_util import SpmdGroup

MESHES = {"pp4": (("pp",), (4,)), "dp2_pp2": (("dp", "pp"), (2, 2))}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with SpmdGroup(4, tmp_path_factory.mktemp("spmd")) as g:
        yield g


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_port_pp_save_restores_into_jax_and_one_process(group, tmp_path,
                                                        mesh):
    """Two pipeline steps on the port's ranks, saved with the layout: every
    replicated block written once (rank 0), each stage's block by its
    stage's first rank; JAX's pp ``TrainState`` sharded on the same mesh
    shape and a one-process port template (each stage leaf assembled from
    the stages' blocks) restore it bit for bit."""
    names, sizes = MESHES[mesh]
    n_stages = sizes[-1]
    init = jtrain.init_pp_state(jax.random.PRNGKey(0), jcfg(), n_stages)
    ranks = group.run(cases.pp_steps, names=names, sizes=sizes,
                      model=PP_MODEL, state=port_pp_numpy(init),
                      tokens=pp_tokens(), n_micro=2, steps=2,
                      directory=str(tmp_path), step=2)
    files = sorted(tmp_path.glob("ckpt-2.shard-*.npz"))
    assert [p.name for p in files] == [f"ckpt-2.shard-{r}.npz"
                                       for r in range(4)]
    keys = [set(np.load(p).files) for p in files]
    assert "leaf_0|" in keys[0] and not any("leaf_0|" in k for k in keys[1:])
    if mesh == "dp2_pp2":           # the dp replicas of a stage write none
        assert not keys[2] and not keys[3] and keys[1]
    # The whole state: each stage leaf from its stages' blocks.
    blocks = [leaves(r["states"][-1]) for r in ranks[:n_stages]]
    specs = spec_leaves(ttrain.pp_state_pspecs(cases.state_from_numpy(
        port_pp_numpy(init))))
    whole = [np.concatenate([b[i] for b in blocks]) if spec
             else blocks[0][i] for i, spec in enumerate(specs)]
    # JAX reads the ranges its template's shards hold: its pp state on the
    # same mesh shape.
    jm = jmesh.make_mesh(4, axis_names=names, axis_sizes=sizes)
    template, _ = jtrain.shard_pp_state(init, jm)
    restored = jckpt.restore_checkpoint_sharded(tmp_path, template)
    assert int(restored.step) == 2
    for got, want in zip(jax.tree.leaves(restored), whole):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    cfg = ttf.TransformerConfig(dtype=torch.float32, **PP_MODEL)
    template = ttrain.init_pp_state(torch.Generator().manual_seed(1), cfg,
                                    n_stages, device="cpu")
    back = tckpt.restore_checkpoint_sharded(tmp_path, template)
    assert back.step == 2 and back.opt_state["count"] == 2
    for got, want in zip(leaves(back), whole):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_jax_pp_save_restores_into_port_ranks(group, tmp_path, mesh):
    """JAX's pp state after one step on its own pp mesh, saved by
    ``save_checkpoint_sharded``, restores into each port rank's blocks bit
    for bit."""
    names, sizes = MESHES[mesh]
    init = jtrain.init_pp_state(jax.random.PRNGKey(0), jcfg(), sizes[-1])
    jm = jmesh.make_mesh(4, axis_names=names, axis_sizes=sizes)
    state, _ = jtrain.shard_pp_state(init, jm)
    state, _ = jtrain.make_pp_train_step(jcfg(), jm, 2, donate=False)(state)(
        state, jnp.asarray(pp_tokens()))
    jckpt.save_checkpoint_sharded(tmp_path, 5, state)
    ranks = group.run(cases.pp_restore, names=names, sizes=sizes,
                      template=port_pp_numpy(init), directory=str(tmp_path))
    specs = spec_leaves(ttrain.pp_state_pspecs(cases.state_from_numpy(
        port_pp_numpy(init))))
    assert all(r.step == 1 for r in ranks)
    _check_rank_blocks(ranks, [np.asarray(x) for x in jax.tree.leaves(state)],
                       specs, names, sizes, 0.0)
