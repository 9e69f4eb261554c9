"""The paged kernels per kv-head shard on a gang of two CPU ranks, and the
gang's collectives, against the JAX package's shard_map programs.

Each rank of a ``tp`` 2 gang runs ``paged_attention(mesh=)`` on its own
kv-head block (its query heads, its pools and scales, each a tensor of
its own): on the CPU the wrappers take the plain version, which must equal
the unsharded plain version cut to the rank's heads BIT FOR BIT (no
reduction crosses ranks), and the ranks' blocks side by side must equal
JAX's ``paged_attention(..., mesh=)`` (``_tp_kernel`` over the Pallas
kernel in interpret mode) within the 2e-5 ATOL of
``tests/test_paged_attention.py``, over fp32 pools and int8, int4 and fp8
codes with their scales. ``gqa_cached_attention_tp`` equals JAX's. The
collectives give each rank what their contracts say."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_task.ml.ops import attention as jatt
from tpu_task.ml.ops import paged_attention as jpa
from torch_gang_util import (
    cpu_gang,
    paged_inputs,
    rank_collectives,
    rank_gqa_tp,
    rank_paged_attention,
    rank_strided_shard_refused,
)

ATOL = 2e-5
TP = 2

#: kv_dtype -> the JAX code dtype its raw bytes view as.
CODES = {None: None, "int8": jnp.int8, "int4": jnp.uint8,
         "fp8": jnp.float8_e4m3fn}


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    with cpu_gang(tmp_path_factory.mktemp("gang"), TP) as mesh:
        yield mesh


def _jax_mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:TP]), ("tp",))


@functools.lru_cache(maxsize=None)
def _jax_paged(kv_dtype, seed):
    """JAX's tp-sharded paged attention (interpret mode) of the seeded
    inputs: one program a storage type, shared by the impls."""
    return np.asarray(jpa.paged_attention(
        *_jax_inputs(kv_dtype, seed), impl="interpret", mesh=_jax_mesh()))


def _jax_inputs(kv_dtype, seed):
    q, kp, vp, tables, pos, scales = paged_inputs(seed, kv_dtype)
    if kv_dtype is not None:
        kp, vp = (jax.lax.bitcast_convert_type(jnp.asarray(a),
                                               CODES[kv_dtype])
                  if kv_dtype == "fp8" else
                  jnp.asarray(a.view(np.int8) if kv_dtype == "int8" else a)
                  for a in (kp, vp))
        scales = tuple(jnp.asarray(s) for s in scales)
    return (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(pos)) + (scales or ())


@pytest.mark.parametrize("impl", ["reference", "cuda", "pipelined"])
@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4", "fp8"])
def test_paged_attention_per_shard(mesh, kv_dtype, impl):
    seed = 7 + len(str(kv_dtype))
    per_rank = mesh.gang.query(rank_paged_attention, seed, kv_dtype, impl,
                               mesh)
    for got, ref in per_rank:
        np.testing.assert_array_equal(got, ref)
    ours = np.concatenate([got for got, _ in per_rank], axis=2)
    np.testing.assert_allclose(ours, _jax_paged(kv_dtype, seed), atol=ATOL,
                               rtol=0)


def test_strided_shard_is_refused(mesh):
    errors = mesh.gang.query(rank_strided_shard_refused, mesh)
    assert all("its own contiguous tensor" in e for e in errors)


def test_gqa_cached_attention_tp_is_jax(mesh):
    per_rank = mesh.gang.query(rank_gqa_tp, 3, mesh)
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 5, 8, 16)).astype(np.float32)
    k = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    v = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    positions = rng.integers(0, 12, size=(2, 5))
    want = jatt.gqa_cached_attention_tp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(positions), _jax_mesh())
    for got in per_rank:
        np.testing.assert_array_equal(got, per_rank[0])
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def test_collectives_give_their_contracts(mesh):
    out = mesh.gang.query(rank_collectives, mesh)
    x = [np.arange(4, dtype=np.float32) + 10 * r for r in range(TP)]
    for r, got in enumerate(out):
        assert got["coords"] == {"tp": r, "ep": 0}
        np.testing.assert_array_equal(got["sum"], x[0] + x[1])
        np.testing.assert_array_equal(got["max"], x[1])
        np.testing.assert_array_equal(got["gather"],
                                      np.concatenate(x)[None])
        # Row j of rank r's result is row r of rank j's input.
        np.testing.assert_array_equal(
            got["a2a"], np.stack([np.full(3, 10.0 * j + r)
                                  for j in range(TP)]))
    counts = mesh.collectives
    assert counts["all_reduce"][0] >= 2 and counts["all_to_all"][0] >= 1
