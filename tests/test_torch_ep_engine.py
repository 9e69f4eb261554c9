"""The port's serving engine with mixture-of-experts layers on a gang of
two CPU ranks (``ep`` 2) against the JAX package's engine on a two-device
``ep`` mesh and on one device.

Every fused step of the gang routes its tokens through the
expert-parallel dispatch (``moe.apply_sharded``: each rank places its
piece of the rows by capacity, one all_to_all over ``ep`` each way, its
own experts between), dropless at the per-rank row count, so the streams
are the dense dispatch's: ``tests/test_serving_moe.py``'s MOE config
gives greedy streams identical to one device, sampled
streams key-identical and JAX's mesh engine's ``stats()``, at K 4 over
int8 pools and at ``spec_k`` 2 with a dense draft (K 1: the ``tp`` 2 ×
``ep`` 2 file and the replica's); each rank holds half the experts,
exactly JAX's addressable shard. The one-device streams are the port's
engine's, which the other ``test_torch_*`` files hold to JAX's."""

import pytest

from tpu_task_torch.ml.parallel import gang
from torch_gang_cases import check_case, check_shard_bytes, engines, models
from torch_gang_util import cpu_gang

#: ``tests/test_serving_moe.py``'s MOE: 4 experts on every second layer.
MOE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
           d_ff=64, n_kv_heads=2, moe_every=2, n_experts=4)
DRAFT = dict(vocab_size=64, d_model=16, n_layers=1, n_heads=2, d_head=8,
             d_ff=32, n_kv_heads=2)
TARGETS = {"MOE": models(MOE, 0)}
DRAFT_MODELS = models(DRAFT, 7)

CASES = {
    "MOE-k4_int8": ("MOE", {"micro_k": 4, "kv_dtype": "int8"}, False),
    "MOE-spec_k2": ("MOE", {"spec_k": 2}, False),
}


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    with cpu_gang(tmp_path_factory.mktemp("gang"), 1, 2) as mesh:
        yield mesh


@pytest.mark.parametrize("case", sorted(CASES))
def test_gang_streams_and_stats_equal_jax(mesh, case):
    name, over, jax_single = CASES[case]
    calls = mesh.collectives.get("all_to_all", [0, 0.0])[0]
    single, on_mesh, port = engines(mesh, TARGETS[name], over,
                                    draft=DRAFT_MODELS,
                                    jax_single=jax_single)
    stats = check_case(single, on_mesh, port, sampled=not over.get("spec_k"))
    assert (stats["tp"], stats["ep"]) == (1, 2)
    assert gang.collective_stats(mesh)["all_to_all"]["calls"] > calls
    if over.get("spec_k"):
        assert stats["spec"]["rounds"] > 0
    check_shard_bytes(mesh.gang, [(port.params, on_mesh.params),
                                  (port.pools, on_mesh.pools)], on_mesh)
    w_in = port.params["layers"][1]["w_in"]
    assert w_in.shape[0] * 2 == port.cfg.n_experts
