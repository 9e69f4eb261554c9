"""The port's serving engine with mixture-of-experts layers on a gang of
four CPU ranks (``tp`` 2 × ``ep`` 2) against the JAX package's engine on a
(2, 2) mesh and on one device: attention heads, the dense FFN and the
experts' hidden dim over ``tp`` (one all-reduce completes each), experts
over ``ep`` (the all_to_all dispatch inside each tp group). Greedy
streams identical to one device, sampled streams key-identical,
``stats()`` equal to JAX's mesh engine's over int8 pools (the port's
one-device engine stands for JAX's, which the other files hold it to);
each rank holds exactly JAX's addressable shard (a quarter of every
expert table)."""

import pytest

from torch_gang_cases import check_case, check_shard_bytes, engines, models
from torch_gang_util import cpu_gang

MOE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
           d_ff=64, n_kv_heads=2, moe_every=2, n_experts=4)
TARGET = models(MOE, 0)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    with cpu_gang(tmp_path_factory.mktemp("gang"), 2, 2) as mesh:
        yield mesh


def test_gang_streams_and_stats_equal_jax(mesh):
    single, on_mesh, port = engines(mesh, TARGET, {"kv_dtype": "int8"},
                                    jax_single=False)
    stats = check_case(single, on_mesh, port)
    assert (stats["tp"], stats["ep"]) == (2, 2)
    check_shard_bytes(mesh.gang, [(port.params, on_mesh.params),
                                  (port.pools, on_mesh.pools)], on_mesh)
    w_in = port.params["layers"][1]["w_in"]
    assert tuple(w_in.shape) == (2, 32, 32)
