"""Checkpoints of a sharded train state across SPMD ranks and across
packages, on the CPU: one group of 4 gloo ranks serves every case. Each
rank saves its blocks keyed by their global index range with its layout
(``specs=``, ``mesh=``), the replicated ones once; restore reads the
ranges its blocks need from whichever files hold them, so a save restores
into another mesh, another rank count, one process, and JAX's
``make_mesh(8)`` template, and JAX's 8-device save into the port's ranks.
Values cross bit for bit."""

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
from tpu_task_torch.ml.parallel.sharding import (
    global_shape,
    shard_slices,
    spec_leaves,
)
from tpu_task_torch.ml.tree import leaves

import torch_train_mesh_cases as cases
from torch_spmd_util import SpmdGroup
from test_torch_train_mesh import TINY, _port_numpy, _tokens

SAVE = (("fsdp", "tp"), (2, 2))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with SpmdGroup(4, tmp_path_factory.mktemp("spmd")) as g:
        yield g


@pytest.fixture(scope="module")
def start():
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **TINY)
    return jcfg, jtrain.init_state(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def port_save(group, start, tmp_path_factory):
    """A 4-rank port save on (fsdp 2, tp 2) after one train step (moments
    non-zero): the directory and the whole arrays of the saved state."""
    jcfg, init = start
    directory = tmp_path_factory.mktemp("port-save")
    names, sizes = SAVE
    ranks = group.run(cases.save_blocks, names=names, sizes=sizes,
                      model=TINY, state=_port_numpy(init, TINY),
                      directory=str(directory), step=7, steps=1,
                      tokens=_tokens(seq=129))
    return directory, _whole(ranks, names, sizes)


def _specs(names, sizes):
    cfg = ttf.TransformerConfig(dtype=torch.float32, **TINY)
    state = ttrain.init_state(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    return spec_leaves(ttrain.state_pspecs(state, cfg,
                                           tmesh.Mesh(sizes, names)))


def _whole(ranks, names, sizes) -> list:
    """The whole arrays of a state from every rank's blocks."""
    layout = tmesh.Mesh(sizes, names)
    full = []
    for i, spec in enumerate(_specs(names, sizes)):
        block = leaves(ranks[0])[i]
        if np.ndim(block) == 0:
            full.append(np.asarray(block))
            continue
        shape = global_shape(np.shape(block), spec, layout)
        array = np.empty(shape, np.float32)
        for rank, state in enumerate(ranks):
            array[shard_slices(shape, spec, layout, rank)] = leaves(state)[i]
        full.append(array)
    return full


def _assert_blocks(ranks, full, names, sizes):
    layout = tmesh.Mesh(sizes, names)
    for rank, state in enumerate(ranks):
        for got, want, spec in zip(leaves(state), full,
                                   _specs(names, sizes)):
            if np.ndim(want) == 0:
                assert int(got) == int(want)
                continue
            np.testing.assert_array_equal(
                np.asarray(got), want[shard_slices(want.shape, spec, layout,
                                                   rank)])


def test_port_save_files(port_save):
    """One file a rank; each block written once: the replicated leaves
    (step, norms, count) by rank 0 alone, every sharded block by its
    rank, keyed by its global range."""
    directory, full = port_save
    files = sorted(p.name for p in directory.glob("ckpt-7.shard-*.npz"))
    assert files == [f"ckpt-7.shard-{r}.npz" for r in range(4)]
    keys = [set(np.load(directory / name).files) for name in files]
    assert "leaf_0|" in keys[0] and not any("leaf_0|" in k for k in keys[1:])
    assert "leaf_1|0:128,0:32" in keys[0]           # embed (tp, fsdp)
    assert "leaf_1|128:256,32:64" in keys[3]
    assert sum(len(k) for k in keys) == len(
        {key for k in keys for key in k})


def test_port_save_restores_into_jax_make_mesh_8(port_save, start):
    """JAX's ``restore_checkpoint_sharded`` into a template sharded over
    its (dp 2, fsdp 2, tp 2) mesh reads the port's ranges, bit for bit."""
    directory, full = port_save
    jcfg, init = start
    jm = jmesh.make_mesh(8)
    template, _ = jtrain.shard_state(init, jcfg, jm)
    restored = jckpt.restore_checkpoint_sharded(directory, template)
    for got, want in zip(jax.tree.leaves(restored), full):
        np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("names,sizes", [(("tp",), (2,)),
                                         (("dp", "fsdp"), (2, 2))])
def test_port_save_restores_into_other_meshes(group, port_save, start,
                                              names, sizes):
    """Another mesh and rank count: each block assembled from the pieces
    that cover it."""
    directory, full = port_save
    _, init = start
    ranks = group.run(cases.restore_blocks, names=names, sizes=sizes,
                      model=TINY, template=_port_numpy(init, TINY),
                      directory=str(directory))
    n = int(np.prod(sizes))
    assert ranks[n:] == [None] * (4 - n)
    _assert_blocks(ranks[:n], full, names, sizes)


def test_port_save_restores_into_one_process(port_save):
    directory, full = port_save
    cfg = ttf.TransformerConfig(dtype=torch.float32, **TINY)
    template = ttrain.init_state(torch.Generator().manual_seed(1), cfg,
                                 device="cpu")
    restored = tckpt.restore_checkpoint_sharded(directory, template)
    assert restored.step == 1
    for got, want in zip(leaves(restored), full):
        np.testing.assert_array_equal(np.asarray(got), want)


def test_jax_8_device_save_restores_into_port_ranks(group, start, tmp_path):
    """JAX's save of a state sharded over ``make_mesh(8)`` after one step
    restores into 4 port ranks on (fsdp 2, tp 2)."""
    jcfg, init = start
    jm = jmesh.make_mesh(8)
    state, _ = jtrain.shard_state(init, jcfg, jm)
    state, _ = jtrain.make_train_step(jcfg, mesh=jm, donate=False)(state)(
        state, jnp.asarray(_tokens(seq=129)))
    jckpt.save_checkpoint_sharded(tmp_path, 3, state)
    names, sizes = SAVE
    ranks = group.run(cases.restore_blocks, names=names, sizes=sizes,
                      model=TINY, template=_port_numpy(init, TINY),
                      directory=str(tmp_path))
    _assert_blocks(ranks, [np.asarray(x) for x in jax.tree.leaves(state)],
                   names, sizes)


def test_restore_falls_back_past_a_partial_newest_step(group, start,
                                                        tmp_path):
    """Step 2 lost rank 3's file (a preemption mid-upload): the ranks
    restore step 1, the last complete one."""
    _, init = start
    names, sizes = SAVE
    numpy_init = _port_numpy(init, TINY)
    first = group.run(cases.save_blocks, names=names, sizes=sizes,
                      model=TINY, state=numpy_init, directory=str(tmp_path),
                      step=1, steps=1, tokens=_tokens(seq=129))
    group.run(cases.save_blocks, names=names, sizes=sizes, model=TINY,
              state=numpy_init, directory=str(tmp_path), step=2, steps=2,
              tokens=_tokens(seq=129))
    (tmp_path / "ckpt-2.shard-3.npz").unlink()
    ranks = group.run(cases.restore_blocks, names=names, sizes=sizes,
                      model=TINY, template=numpy_init,
                      directory=str(tmp_path))
    _assert_blocks(ranks, _whole(first, names, sizes), names, sizes)
    assert all(leaves(r)[0] == 1 for r in ranks)


def test_async_saves_equal_sync_saves_on_disk(group, start, tmp_path):
    """Each rank's ``AsyncCheckpointer.save`` with the layout writes the
    files ``save_checkpoint_sharded`` writes: the same keys and bytes."""
    _, init = start
    names, sizes = SAVE
    for mode in ("sync", "async"):
        group.run(cases.save_blocks, names=names, sizes=sizes, model=TINY,
                  state=_port_numpy(init, TINY),
                  directory=str(tmp_path / mode), step=5, steps=1,
                  tokens=_tokens(), mode=mode)
    for rank in range(4):
        name = f"ckpt-5.shard-{rank}.npz"
        sync, asyn = (np.load(tmp_path / mode / name)
                      for mode in ("sync", "async"))
        assert sorted(sync.files) == sorted(asyn.files)
        for key in sync.files:
            np.testing.assert_array_equal(sync[key], asyn[key])
    for name in ("LATEST_SHARDED", "ckpt-5.meta"):
        assert ((tmp_path / "sync" / name).read_text()
                == (tmp_path / "async" / name).read_text())


def test_layout_needs_specs_and_mesh(tmp_path):
    cfg = ttf.TransformerConfig(dtype=torch.float32, **TINY)
    state = ttrain.init_state(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    with pytest.raises(ValueError, match="both specs= and mesh="):
        tckpt.save_checkpoint_sharded(tmp_path, 1, state,
                                      mesh=tmesh.Mesh((2,), ("tp",)))
