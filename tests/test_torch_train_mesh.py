"""The port's sharded train step (``train.make_train_step(cfg, mesh=...)``
over ``dp``, ``fsdp`` and ``tp``) against the JAX package's, at fp32 on
the CPU: one SPMD group of 8 gloo ranks (``tests/torch_spmd_util.py``)
serves every case, each rank holding its blocks of the state and its rows
of the batch, as a trainer's workers do.

Tolerances: after each of three steps, every rank's params and AdamW
moments within 2e-5 of JAX's mesh step's shard at the same index (the
port's single-device train tolerance: fp32 sums in another order, reaching
the weights scaled by lr), loss and grad norm within 1e-5; against JAX's
single-device step within JAX's own 2e-4 (``test_ml_parallel.py``). The
JAX steps run their default attention; the port's ranks run
``FlashAttention``, whose wrappers take the plain versions on the CPU."""

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
from tpu_task_torch.ml.parallel.sharding import (
    global_shape,
    shard_slices,
    spec_leaves,
)
from tpu_task_torch.ml.tree import leaves

import torch_train_mesh_cases as cases
from torch_spmd_util import SpmdGroup

ATOL = 1e-5
PARAM_ATOL = 2e-5
SINGLE_ATOL = 2e-4

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_head=16,
            d_ff=128, n_kv_heads=2)
MESHES = {"dp2_fsdp2_tp2": (("dp", "fsdp", "tp"), (2, 2, 2)),
          "fsdp2_tp2": (("fsdp", "tp"), (2, 2)),
          "dp2": (("dp",), (2,))}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with SpmdGroup(8, tmp_path_factory.mktemp("spmd")) as g:
        yield g


def _jcfg(**over):
    return jtf.TransformerConfig(dtype=jnp.float32, **{**TINY, **over})


def _tokens(batch=8, seq=17, seed=1):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                         (batch, seq), 0, TINY["vocab_size"]))


def _port_numpy(jstate, model):
    """JAX's state as the port's numpy ``TrainState``."""
    cfg = ttf.TransformerConfig(dtype=torch.float32, **model)
    return ttrain.state_to_numpy(ttrain.state_from_jax(
        jax.tree.map(np.asarray, jstate), cfg, device="cpu"))


def _layout(names, sizes):
    return tmesh.Mesh(sizes, names)


def _check_rank_blocks(blocks, full_leaves, specs, names, sizes, atol):
    """Each rank's blocks against the whole arrays' slices at its index."""
    layout = _layout(names, sizes)
    for rank, state in enumerate(blocks):
        for got, want, spec in zip(leaves(state), full_leaves, specs):
            want = np.asarray(want)
            if np.ndim(want) == 0:
                assert int(got) == int(want)
                continue
            index = shard_slices(want.shape, spec, layout, rank)
            np.testing.assert_allclose(np.asarray(got), want[index],
                                       rtol=0, atol=atol,
                                       err_msg=f"rank {rank} {spec}")


def _jax_steps(jcfg, names, sizes, tokens, steps=3, accum=1):
    """JAX's mesh step on the same mesh shape: the state after each step
    (with its shardings) and the metrics."""
    mesh = jmesh.make_mesh(int(np.prod(sizes)), axis_names=names,
                           axis_sizes=sizes)
    state, _ = jtrain.shard_state(jtrain.init_state(jax.random.PRNGKey(0),
                                                    jcfg), jcfg, mesh)
    step = jtrain.make_train_step(jcfg, mesh=mesh, donate=False,
                                  accum_steps=accum)(state)
    out = []
    for _ in range(steps):
        state, metrics = step(state, jnp.asarray(tokens))
        out.append((state, {k: float(v) for k, v in metrics.items()}))
    return out


@pytest.fixture(scope="module")
def single_device():
    """JAX's single-device step: three states and metrics."""
    jcfg = _jcfg()
    state = jtrain.init_state(jax.random.PRNGKey(0), jcfg)
    step = jtrain.make_train_step(jcfg, donate=False)
    out = []
    for _ in range(3):
        state, metrics = step(state, jnp.asarray(_tokens()))
        out.append((state, {k: float(v) for k, v in metrics.items()}))
    return out


def test_state_pspecs_match_jax():
    """The spec tree, leaf for leaf in JAX's order, on the default mesh
    and with same-shaped params of different layouts (wq and wo square)."""
    for model in (TINY, dict(vocab_size=64, d_model=32, n_layers=1,
                             n_heads=4, d_head=8, d_ff=64)):
        jcfg = jtf.TransformerConfig(dtype=jnp.float32, **model)
        cfg = ttf.TransformerConfig(dtype=torch.float32, **model)
        jstate = jtrain.init_state(jax.random.PRNGKey(0), jcfg)
        state = ttrain.state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                      device="cpu")
        for names, sizes in MESHES.values():
            jm = jmesh.make_mesh(int(np.prod(sizes)), axis_names=names,
                                 axis_sizes=sizes)
            want = jax.tree.leaves(jtrain.state_pspecs(jstate, jcfg, jm))
            specs = ttrain.state_pspecs(state, cfg, _layout(names, sizes))
            got = spec_leaves(specs)
            assert len(got) == len(want) == len(leaves(state))
            assert [tuple(g) for g in got] == [tuple(w) for w in want]
        layer = specs.opt_state["mu"]["layers"][0]
        if names == ("dp",):
            continue
        assert layer["wq"] == ("fsdp", "tp") and layer["wo"] == ("tp",
                                                                 "fsdp")


def test_shard_state_blocks_are_jax_shards(group):
    """Every rank's blocks after ``shard_state`` equal JAX's addressable
    shard of the same mesh position, bit for bit."""
    names, sizes = MESHES["dp2_fsdp2_tp2"]
    jcfg = _jcfg()
    jm = jmesh.make_mesh(8, axis_names=names, axis_sizes=sizes)
    jstate, jspecs = jtrain.shard_state(
        jtrain.init_state(jax.random.PRNGKey(0), jcfg), jcfg, jm)
    blocks = group.run(cases.shard_blocks, names=names, sizes=sizes,
                       model=TINY, state=_port_numpy(jstate, TINY))
    devices = list(jm.devices.flat)
    for rank, state in enumerate(blocks):
        for got, leaf in zip(leaves(state), jax.tree.leaves(jstate)):
            shard = next(s for s in leaf.addressable_shards
                         if s.device == devices[rank])
            np.testing.assert_array_equal(np.asarray(got),
                                          np.asarray(shard.data))


def test_batch_rows_follow_the_batch_axes(group):
    """``local_batch_slice`` divides by the batch axes' pieces, not the
    process count: the two tp ranks of each (dp, fsdp) position read the
    same rows, and every row is read by exactly one position."""
    rows = group.run(cases.batch_rows, names=("dp", "fsdp", "tp"),
                     sizes=(2, 2, 2))
    assert all(r["slice"] == 16 and r["pieces"] == 4 for r in rows)
    for rank in range(0, 8, 2):
        assert rows[rank]["rows"] == rows[rank + 1]["rows"]
        assert rows[rank]["coords"]["tp"] == 0
    seen = sorted(i for r in rows[::2] for i in r["rows"])
    assert seen == list(range(64))
    tp_only = group.run(cases.batch_rows, names=("tp",), sizes=(2,))
    assert tp_only[0]["rows"] == tp_only[1]["rows"] == list(range(64))
    assert tp_only[2:] == [None] * 6


@pytest.mark.parametrize("name,accum", [("dp2_fsdp2_tp2", 1),
                                        ("dp2_fsdp2_tp2", 2)])
def test_sharded_steps_match_jax(group, single_device, name, accum):
    """Three steps (each clips: the grad norm is above 1) on each rank's
    rows: loss and grad norm within 1e-5 and every rank's params and AdamW
    moments within 2e-5 of JAX's mesh step on the same mesh shape; within
    2e-4 of JAX's single-device step."""
    run_steps(group, single_device, name, accum)


def run_steps(group, single_device, name, accum):
    names, sizes = MESHES[name]
    jcfg = _jcfg()
    tokens = _tokens()
    jax_run = _jax_steps(jcfg, names, sizes, tokens, accum=accum)
    start = _port_numpy(jtrain.init_state(jax.random.PRNGKey(0), jcfg), TINY)
    ranks = group.run(cases.train_steps, names=names, sizes=sizes,
                      model=TINY, state=start, tokens=tokens, accum=accum)
    n = int(np.prod(sizes))
    assert ranks[n:] == [None] * (len(ranks) - n)
    cfg = ttf.TransformerConfig(dtype=torch.float32, **TINY)
    specs = spec_leaves(ttrain.state_pspecs(
        cases.state_from_numpy(start), cfg, _layout(names, sizes)))
    for i, ((jstate, jmetrics), (_, single)) in enumerate(
            zip(jax_run, single_device)):
        assert jmetrics["grad_norm"] > 1.0
        for rank in ranks[:n]:
            got = rank["metrics"][i]
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(got[key], jmetrics[key],
                                           rtol=0, atol=ATOL)
                np.testing.assert_allclose(got[key], single[key], rtol=0,
                                           atol=SINGLE_ATOL)
        full = [np.asarray(x) for x in jax.tree.leaves(jstate)]
        _check_rank_blocks([r["states"][i] for r in ranks[:n]], full, specs,
                           names, sizes, PARAM_ATOL)
        single_full = [np.asarray(x) for x in jax.tree.leaves(
            single_device[i][0])]
        _check_rank_blocks([r["states"][i] for r in ranks[:n]], single_full,
                           specs, names, sizes, SINGLE_ATOL)
    # The step's collectives: gathers, reductions and the reduce-scatters'
    # exchanges, nothing else.
    kinds = set(ranks[0]["collectives"])
    assert kinds <= {"all_gather", "all_reduce", "all_to_all"}
    assert "all_reduce" in kinds


def test_global_shape_inverts_the_cut():
    layout = _layout(("dp", "fsdp", "tp"), (2, 2, 2))
    for shape, spec in (((256, 64), ("tp", "fsdp")), ((64,), (None,)),
                        ((), ())):
        index = shard_slices(shape, spec, layout, 5)
        block = tuple(s.stop - s.start for s in index)
        assert global_shape(block, spec, layout) == shape
