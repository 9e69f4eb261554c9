"""The port's sharded train step on the smaller meshes, (fsdp 2, tp 2)
and (dp 2), against JAX's mesh and single-device steps: one SPMD group of
4 gloo ranks (the dp case on its first two). The cases and tolerances of
``test_torch_train_mesh.py``, which runs JAX's own (dp 2, fsdp 2, tp 2)
shape on 8."""

import pytest

from torch_spmd_util import SpmdGroup
from test_torch_train_mesh import run_steps, single_device  # noqa: F401


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with SpmdGroup(4, tmp_path_factory.mktemp("spmd")) as g:
        yield g


@pytest.mark.parametrize("name", ["fsdp2_tp2", "dp2"])
def test_sharded_steps_on_smaller_meshes_match_jax(group, single_device,
                                                   name):
    run_steps(group, single_device, name, 1)
