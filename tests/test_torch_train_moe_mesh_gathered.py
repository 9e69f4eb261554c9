"""The port's expert-parallel train step on MoE meshes with ``fsdp`` or
``tp`` beside ``ep``, against JAX's ``make_moe_train_step`` on the same
mesh shapes (its ``shard_map`` specs gather the expert weights over
those axes; the port gathers them just before the layer, their gradients
reduce-scattered over ``fsdp`` and sliced over ``tp``). One SPMD group of
4 gloo ranks; the cases and tolerances of
``test_torch_train_moe_mesh.py``."""

import pytest

from torch_spmd_util import SpmdGroup
from test_torch_train_moe_mesh import run_case


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with SpmdGroup(4, tmp_path_factory.mktemp("spmd")) as g:
        yield g


@pytest.mark.parametrize("name,top_k,capacity", [("fsdp2_ep2", 2, 1.25),
                                                 ("tp2_ep2", 1, 1.25)])
def test_moe_steps_with_gathered_experts_match_jax(group, name, top_k,
                                                    capacity):
    run_case(group, name, top_k, capacity)
