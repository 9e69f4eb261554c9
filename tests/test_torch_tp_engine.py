"""The port's serving engine on a gang of two CPU ranks (``tp`` 2) against
the JAX package's engine on a two-device mesh and on one device.

One gang serves every case of the module: each builds a port engine over
the gang's mesh (every rank holding its block of the weights and pools,
every fused step a gang program) beside JAX's mesh engine and JAX's
single-device engine (``decode_impl="xla"``) from the same weights, and
sends all three the same wave. The contract is JAX's
(``tests/test_serving.py``, ``tests/test_serving_moe.py``): greedy streams
identical to one device, sampled streams key-identical, ``stats()`` equal
— here at K 1 with the prefix cache sharing blocks and a pool tight
enough to preempt, at K 4 over int4 pools with bucketed prefill, and at
``spec_k`` 2 over fp8 pools with a sharded draft (int8 pools: the ``tp``
4 and ``ep`` files). A case with no JAX single-device engine of its own
compares the port's, which the other ``test_torch_*`` files hold to
JAX's. A gang's ``export_inflight`` records resume in a single-device
engine of either package; prefill logits equal JAX's within the tolerance
of ``test_engine_tp8_prefill_logits_match_to_tolerance``; each rank holds
exactly the bytes of JAX's addressable shards. Sampled requests ride the
K 1 case (each further program JAX compiles costs seconds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.parallel.sharding import tree_nbytes
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.ml.serving.model import paged_prefill
from torch_gang_cases import (
    BASE,
    check_case,
    check_shard_bytes,
    engines,
    models,
)
from torch_gang_util import cpu_gang, wave
from torch_port_util import CPU, share_jax_programs

TP = 2
#: ``tests/test_serving.py``'s TP8: every kv head its own query group.
TP8 = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=8, d_head=8,
           d_ff=64, n_kv_heads=8)
#: A draft the tp 2 gang can shard (two kv heads).
DRAFT = dict(vocab_size=64, d_model=16, n_layers=1, n_heads=2, d_head=8,
             d_ff=32, n_kv_heads=2)

CASES = {
    "k1_tight_pool": {"n_blocks": 10},
    "k4_int4_bucketed": {"micro_k": 4, "kv_dtype": "int4",
                         "prefill": "bucketed", "prefix_cache": False},
    "spec_k2_fp8": {"spec_k": 2, "kv_dtype": "fp8"},
}

#: The cases also run through JAX's single-device engine.
JAX_SINGLE = ("k1_tight_pool",)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    with cpu_gang(tmp_path_factory.mktemp("gang"), TP) as mesh:
        yield mesh


TARGET = models(TP8, 0)
DRAFT_MODELS = models(DRAFT, 7)


def _engines(mesh, over, jax_single=True):
    return engines(mesh, TARGET, over, draft=DRAFT_MODELS,
                   jax_single=jax_single)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gang_streams_and_stats_equal_jax(mesh, case):
    stats = check_case(*_engines(mesh, CASES[case],
                                 jax_single=case in JAX_SINGLE),
                       sampled=case == "k1_tight_pool")
    assert stats["tp"] == TP
    if case == "k1_tight_pool":
        assert stats["recompute_preemptions"] > 0
    if case.startswith("spec"):
        assert stats["spec"]["rounds"] > 0


def test_gang_export_resumes_in_either_package(mesh):
    over = CASES["k1_tight_pool"]
    jax_single, _, port = _engines(mesh, over)
    want = wave(jax_single)
    rids = wave(port, steps=4)
    records = port.export_inflight()
    assert records and all(r["tokens"] for r in records[:1])
    by_rid = dict(zip(rids, want))
    (jcfg, jparams), (cfg, params) = TARGET
    for resumed in (
            ServingEngine(params, cfg, ServingConfig(**{**BASE, **over}),
                          rng=R.PRNGKey(0), device=CPU),
            share_jax_programs(JaxServingEngine(
                jparams, jcfg,
                JaxServingConfig(**{**BASE, **over}, decode_impl="xla"),
                rng=jax.random.PRNGKey(0)))):
        mapping = resumed.resume_inflight(records)
        got = resumed.drain()
        for record in records:
            assert got[mapping[record["rid"]]] == by_rid[record["rid"]]


def test_gang_prefill_logits_within_jax_tolerance(mesh):
    _, _, port = _engines(mesh, {})
    prompt = np.random.default_rng(2).integers(0, 64, size=6)
    table = np.zeros((BASE["max_len"] // BASE["block_size"],), np.int32)
    table[:2] = port.allocator.alloc(2)
    padded = np.zeros((1, 8), np.int32)
    padded[0, :6] = prompt
    ours = paged_prefill(port.params, port.cfg,
                         torch.as_tensor(padded, dtype=torch.int64), 6,
                         torch.as_tensor(table), port.pools,
                         mesh=port.mesh).numpy()
    (jcfg, jparams), _ = TARGET
    single = share_jax_programs(JaxServingEngine(
        jparams, jcfg, JaxServingConfig(**BASE), rng=jax.random.PRNGKey(0)))
    jtable = np.zeros_like(table)
    jtable[:2] = single.allocator.alloc(2)
    want, _ = single._prefill_fn(single.params, jnp.asarray(padded),
                                 jnp.int32(6), jnp.asarray(jtable),
                                 single.pools)
    np.testing.assert_allclose(ours, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_each_rank_holds_jax_shard_bytes(mesh):
    _, jax_mesh, port = _engines(mesh, CASES["spec_k2_fp8"])
    check_shard_bytes(mesh.gang, [
        (port.params, jax_mesh.params), (port.pools, jax_mesh.pools),
        (port.draft_params, jax_mesh.draft_params),
        (port._draft_pools, jax_mesh._draft_pools)], jax_mesh)
    per_rank = mesh.gang.query(tree_nbytes, port.params)
    assert max(per_rank) < tree_nbytes(TARGET[1][1])
