"""The port's expert-parallel train step (``train.make_moe_train_step``)
against the JAX package's on the same mesh shapes, at fp32 on the CPU:
one SPMD group of 4 gloo ranks serves every case. Each rank routes its
own rows' tokens, exchanges them with the other ``ep`` ranks through the
differentiable all_to_all and runs its own experts, the JAX
``shard_map`` body for one rank; capacity drops follow JAX's formula and
order, so a case at ``capacity_factor`` 1.25 drops the same tokens.

Tolerances as ``test_torch_train_mesh.py``: every rank's params and AdamW
moments within 2e-5 of JAX's mesh step's shard after each of three steps,
loss and grad norm within 1e-5."""

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

import torch_train_mesh_cases as cases
from torch_spmd_util import SpmdGroup
from test_torch_train_mesh import (ATOL, PARAM_ATOL, TINY,
                                   _check_rank_blocks, _port_numpy)

MOE = dict(TINY, moe_every=2, n_experts=4)
MESHES = {"dp2_ep2": (("dp", "ep"), (2, 2)), "ep4": (("ep",), (4,)),
          "fsdp2_ep2": (("fsdp", "ep"), (2, 2)),
          "tp2_ep2": (("tp", "ep"), (2, 2))}
#: (mesh, top-k, capacity factor, accum_steps): ample capacity (4.0,
#: nothing dropped) and 1.25 (tokens dropped); at accum 2 each rank runs
#: its piece of each global microbatch, whose tokens share the capacity.
CASES = [("dp2_ep2", 1, 4.0, 1), ("dp2_ep2", 2, 1.25, 1),
         ("ep4", 1, 1.25, 1), ("ep4", 2, 4.0, 1), ("dp2_ep2", 1, 1.25, 2)]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with SpmdGroup(4, tmp_path_factory.mktemp("spmd")) as g:
        yield g


def _tokens():
    return np.asarray(jax.random.randint(jax.random.PRNGKey(10), (8, 17), 0,
                                         TINY["vocab_size"]))


@pytest.mark.parametrize("name,top_k,capacity,accum", CASES)
def test_moe_steps_match_jax(group, name, top_k, capacity, accum):
    """Three expert-parallel steps, top-1 and top-2, with ample capacity
    (nothing dropped) and at 1.25 (tokens dropped, the same ones), and
    two microbatches a step: every rank's blocks, loss and grad norm
    against JAX's ``make_moe_train_step`` on the same mesh shape."""
    run_case(group, name, top_k, capacity, accum)


def run_case(group, name, top_k, capacity, accum=1):
    names, sizes = MESHES[name]
    model = dict(MOE, moe_top_k=top_k, moe_capacity_factor=capacity)
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **model)
    tokens = _tokens()
    jm = jmesh.make_mesh(4, axis_names=names, axis_sizes=sizes)
    init = jtrain.init_state(jax.random.PRNGKey(0), jcfg)
    jstate, _ = jtrain.shard_state(init, jcfg, jm)
    jstep = jtrain.make_moe_train_step(jcfg, jm, donate=False,
                                       accum_steps=accum)(jstate)
    start = _port_numpy(init, model)
    ranks = group.run(cases.moe_steps, names=names, sizes=sizes,
                      model=model, state=start, tokens=tokens, accum=accum)
    if capacity >= MOE["n_experts"]:
        assert all(r["dropped"] == 0 for r in ranks)
    else:
        assert all(r["dropped"] > 0 for r in ranks)
    cfg = ttf.TransformerConfig(dtype=torch.float32, **model)
    specs = spec_leaves(ttrain.state_pspecs(cases.state_from_numpy(start),
                                            cfg, tmesh.Mesh(sizes, names)))
    for i in range(3):
        jstate, jmetrics = jstep(jstate, jnp.asarray(tokens))
        for rank in ranks:
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(rank["metrics"][i][key],
                                           float(jmetrics[key]), rtol=0,
                                           atol=ATOL)
        _check_rank_blocks([r["states"][i] for r in ranks],
                           [np.asarray(x) for x in jax.tree.leaves(jstate)],
                           specs, names, sizes, PARAM_ATOL)
    assert "all_to_all" in ranks[0]["collectives"]


def test_moe_step_refusals():
    """JAX's ValueErrors, word for word."""
    cfg = ttf.TransformerConfig(dtype=torch.float32, **MOE)
    with pytest.raises(ValueError, match="mesh has no 'ep' axis"):
        ttrain.make_moe_train_step(cfg, tmesh.Mesh((2, 2), ("dp", "tp")))
    dense = ttf.TransformerConfig(dtype=torch.float32, **TINY)
    with pytest.raises(ValueError, match="config has no MoE layers"):
        ttrain.make_moe_train_step(dense, tmesh.Mesh((4,), ("ep",)))
