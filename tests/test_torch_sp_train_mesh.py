"""The port's sequence-parallel train step beside a batch axis, (dp 2, sp
2) and (fsdp 2, sp 2), held to JAX's ``make_sp_train_step`` values step
for step (JAX's own tests hold these meshes only to a finite loss); the
narrow k/v wire of a grouped-query config; a checkpoint of an sp-trained
state across the packages; and what the step refuses. One SPMD group of 4
gloo ranks; the tolerances of ``test_torch_sp_train.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml import checkpoint as jckpt
from tpu_task.ml import train as jtrain
from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.parallel import mesh as jmesh
from tpu_task_torch.ml import checkpoint as tckpt
from tpu_task_torch.ml import train as ttrain
from tpu_task_torch.ml.models import transformer as ttf
from tpu_task_torch.ml.parallel import mesh as tmesh
from tpu_task_torch.ml.parallel.sharding import PartitionSpec
from tpu_task_torch.ml.tree import leaves

import torch_sp_cases as cases
from test_torch_sp_train import SP_MODEL, run_sp, sp_tokens
from test_torch_train_mesh import _port_numpy
from torch_spmd_util import SpmdGroup

MESH_MODEL = dict(SP_MODEL, n_kv_heads=2)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with SpmdGroup(4, tmp_path_factory.mktemp("spmd")) as g:
        yield g


@pytest.mark.parametrize("names,mode", [
    (("dp", "sp"), "zigzag"),
    (("fsdp", "sp"), "zigzag"),
    (("fsdp", "sp"), "ulysses"),
], ids=["dp2_sp2_zigzag", "fsdp2_sp2_zigzag", "fsdp2_sp2_ulysses"])
def test_sp_steps_beside_a_batch_axis_match_jax(group, names, mode):
    """Rows over the batch axis, each row's sequence over sp; under fsdp
    each rank's param blocks against JAX's shard at its index."""
    ranks = run_sp(group, MESH_MODEL, names, (2, 2), mode,
                   sp_tokens(batch=4))
    assert {r["metrics"][0]["loss"] for r in ranks} == {
        ranks[0]["metrics"][0]["loss"]}


def test_narrow_kv_wire_moves_fewer_ring_bytes(group):
    """The port's ``test_sp_gqa_narrow_wire_reduces_collective_bytes``:
    with group factor 4 (one kv head of four) the zigzag step's ppermute
    bytes, k/v forward and k/v with dk/dv backward, all at kv-head
    width, are a quarter of the MHA step's."""
    moved = {}
    for kv in (None, 1):
        model = dict(SP_MODEL, n_layers=1, n_kv_heads=kv)
        jcfg = jtf.TransformerConfig(dtype=jnp.float32, **model)
        start = _port_numpy(jtrain.init_state(jax.random.PRNGKey(0), jcfg),
                            model)
        ranks = group.run(cases.sp_steps, names=("sp",), sizes=(4,),
                          model=model, state=start, tokens=sp_tokens(),
                          steps=1)
        moved[kv] = ranks[0]["collectives"]["ppermute"]["bytes"]
    assert moved[None] > 0 and moved[1] > 0
    assert moved[1] < 0.6 * moved[None]
    assert moved[1] * 4 == moved[None]


def test_sp_checkpoint_crosses_packages(group, tmp_path):
    """A state trained two steps on (dp 2, sp 2), saved with its layout:
    each replicated block written once (rank 0's file holds every key);
    JAX's ``restore_checkpoint_sharded`` and a one-process port state read
    it back bit for bit."""
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **MESH_MODEL)
    init = jtrain.init_state(jax.random.PRNGKey(0), jcfg)
    ranks = group.run(cases.sp_steps, names=("dp", "sp"), sizes=(2, 2),
                      model=MESH_MODEL, state=_port_numpy(init, MESH_MODEL),
                      tokens=sp_tokens(batch=4), directory=str(tmp_path),
                      step=2)
    saved = leaves(ranks[0]["states"][-1])
    files = sorted(tmp_path.glob("ckpt-2.shard-*.npz"))
    assert [p.name for p in files] == [f"ckpt-2.shard-{r}.npz"
                                       for r in range(4)]
    keys = [set(np.load(p).files) for p in files]
    assert len(keys[0]) == len(saved) and not any(keys[1:])
    restored = jckpt.restore_checkpoint_sharded(tmp_path, init)
    for got, want in zip(jax.tree.leaves(restored), saved):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    cfg = ttf.TransformerConfig(dtype=torch.float32, **MESH_MODEL)
    template = ttrain.init_state(torch.Generator().manual_seed(1), cfg,
                                 device="cpu")
    back = tckpt.restore_checkpoint_sharded(tmp_path, template)
    assert back.step == 2
    for got, want in zip(leaves(back), saved):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sp_step_refusals():
    """JAX's ValueError for an unknown mode, word for word; a MoE config
    names ROADMAP A14 (its router statistics span the whole sequence);
    no sp axis; and the pp step's refusals of a bad layer split and a MoE
    config, JAX's word for word."""
    layout = tmesh.Mesh((4,), ("sp",))
    cfg = ttf.TransformerConfig(dtype=torch.float32, **SP_MODEL)
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **SP_MODEL)
    jm = jmesh.make_mesh(4, axis_names=("sp",), axis_sizes=(4,))
    with pytest.raises(ValueError) as jax_err:
        jtrain.make_sp_train_step(jcfg, jm, context_parallel="ring")
    with pytest.raises(ValueError) as port_err:
        ttrain.make_sp_train_step(cfg, layout, context_parallel="ring")
    assert str(port_err.value) == str(jax_err.value)
    moe = ttf.TransformerConfig(dtype=torch.float32, moe_every=2,
                                n_experts=4, **SP_MODEL)
    with pytest.raises(NotImplementedError, match="A14"):
        ttrain.make_sp_train_step(moe, layout)
    with pytest.raises(ValueError, match="no 'sp' axis"):
        ttrain.make_sp_train_step(cfg, tmesh.Mesh((4,), ("dp",)))
    pp = tmesh.Mesh((4,), ("pp",))
    for bad in (dict(SP_MODEL, n_layers=3),
                dict(SP_MODEL, n_layers=4, moe_every=2, n_experts=4)):
        with pytest.raises(ValueError) as jax_err:
            jtrain.make_pp_train_step(
                jtf.TransformerConfig(dtype=jnp.float32, **bad),
                jmesh.make_mesh(4, axis_names=("pp",), axis_sizes=(4,)), 4)
        with pytest.raises(ValueError) as port_err:
            ttrain.make_pp_train_step(
                ttf.TransformerConfig(dtype=torch.float32, **bad), pp, 4)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="make_sp_train_step"):
        ttrain.make_train_step(cfg, mesh=layout,
                               activation_spec=PartitionSpec(None, "sp",
                                                             None))
