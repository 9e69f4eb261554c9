"""The port's serving engine on a gang of four CPU ranks (``tp`` 4)
against the JAX package's engine on a four-device mesh and one device's
(the port's, which the other ``test_torch_*`` files hold to JAX's):
``tests/test_serving.py``'s TP8 geometry (every kv head its own query
group) with two kv heads a rank. Greedy streams identical to one device,
sampled streams key-identical, ``stats()`` equal to JAX's mesh engine's,
over int8 pools; each rank holds exactly the bytes of
JAX's addressable shard, and every rank ran the paged attention the same
number of times."""

import pytest

from tpu_task_torch.ml.ops import paged_attention as tpa
from torch_gang_cases import check_case, check_shard_bytes, engines, models
from torch_gang_util import cpu_gang

TP = 4
TP8 = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=8, d_head=8,
           d_ff=64, n_kv_heads=8)
TARGET = models(TP8, 0)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    with cpu_gang(tmp_path_factory.mktemp("gang"), TP) as mesh:
        yield mesh


def test_gang_streams_and_stats_equal_jax(mesh):
    mesh.gang.query(tpa.reset_launch_counts)
    single, on_mesh, port = engines(mesh, TARGET, {"kv_dtype": "int8"},
                                    jax_single=False)
    stats = check_case(single, on_mesh, port)
    assert (stats["tp"], stats["ep"]) == (TP, 1)
    # Every follower ran the plain paged attention as often as the others
    # (rank 0 also ran the one-device engine).
    counts = [c["paged_reference_attention"]
              for c in mesh.gang.query(tpa.launch_counts)]
    assert counts[1] > 0 and set(counts[1:]) == {counts[1]}
    assert counts[0] > counts[1]
    check_shard_bytes(mesh.gang, [(port.params, on_mesh.params),
                                  (port.pools, on_mesh.pools)], on_mesh)
