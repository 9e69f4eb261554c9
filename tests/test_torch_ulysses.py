"""The port's Ulysses attention (``tpu_task_torch.ml.parallel.ulysses``)
against the JAX package's, on the CPU: one SPMD group of 4 gloo ranks,
each holding its contiguous chunk of the sequence. JAX runs its own
function on the host devices of this process; the port's ranks run
``dot_product_attention`` at full length after the reshard (its plain
route at these lengths, as JAX's on the CPU). Inputs come from a numpy
seed; JAX's tolerances: the output within 2e-5, the gradients of ``(o **
2).sum()`` within 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.parallel import mesh as jmesh
from tpu_task.ml.parallel import ulysses as julysses
from tpu_task_torch.ml.parallel import mesh as tmesh
from tpu_task_torch.ml.parallel import ulysses as tulysses

import torch_sp_cases as cases
from test_torch_ring_attention import check, jax_run, qkv
from torch_spmd_util import SpmdGroup


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with SpmdGroup(4, tmp_path_factory.mktemp("spmd")) as g:
        yield g


def run(group, sp, q, k, v, causal=True):
    jm = jmesh.make_mesh(sp, axis_names=("sp",), axis_sizes=(sp,))
    want = jax_run(lambda *a: julysses.ulysses_attention(*a, jm,
                                                         causal=causal),
                   q, k, v)
    ranks = group.run(cases.attention, names=("sp",), sizes=(sp,),
                      kind="ulysses", q=q, k=k, v=v, causal=causal,
                      grads=True)
    assert ranks[sp:] == [None] * (4 - sp)
    check(ranks[:sp], want)
    return ranks[:sp]


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_jax(group, causal):
    ranks = run(group, 4, *qkv(5), causal=causal)
    # q, k and v share one reshard in, the output one back; each has its
    # gradient's reverse exchange.
    assert ranks[0]["collectives"]["all_to_all"]["calls"] == 4


def test_ulysses_narrow_kv_crosses_narrow(group):
    """kv 2 over sp 2: the reshard moves the narrow heads and dk/dv come
    back at their width."""
    q, k, v = qkv(6, kv=2)
    narrow = run(group, 2, q, k, v)
    assert narrow[0]["dk"].shape == (2, 16, 2, 16)
    wide = run(group, 2, q, np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2))
    moved = [r[0]["collectives"]["all_to_all"]["bytes"]
             for r in (narrow, wide)]
    # Each way: q + 2 kv heads in and q heads out, against q + 2 q and q.
    assert moved[0] * 4 == moved[1] * 3


def test_ulysses_widens_kv_heads_the_axis_does_not_divide(group):
    """kv 2 over sp 4: widened before the shard, exact."""
    run(group, 4, *qkv(7, kv=2))


def test_ulysses_refuses_indivisible_heads():
    q = np.zeros((1, 16, 6, 8), np.float32)
    jm = jmesh.make_mesh(4, axis_names=("sp",), axis_sizes=(4,))
    with pytest.raises(ValueError, match="heads") as jax_err:
        julysses.ulysses_attention(jnp.asarray(q), jnp.asarray(q),
                                   jnp.asarray(q), jm)
    chunk = torch.zeros((1, 4, 6, 8))
    with pytest.raises(ValueError, match="heads") as port_err:
        tulysses.ulysses_attention(chunk, chunk, chunk,
                                   tmesh.Mesh((4,), ("sp",)))
    assert str(port_err.value) == str(jax_err.value)


def test_sequence_cut_refuses_what_jax_refuses():
    """The port cuts the sequence where the step takes its window; the
    cut raises JAX's ``ulysses_attention`` ValueError."""
    q = np.zeros((1, 18, 4, 8), np.float32)
    jm = jmesh.make_mesh(4, axis_names=("sp",), axis_sizes=(4,))
    with pytest.raises(ValueError) as jax_err:
        julysses.ulysses_attention(jnp.asarray(q), jnp.asarray(q),
                                   jnp.asarray(q), jm)
    with pytest.raises(ValueError) as port_err:
        tmesh.sequence_piece(18, tmesh.Mesh((4,), ("sp",)))
    assert str(port_err.value) == str(jax_err.value)
    assert tmesh.sequence_piece(16, tmesh.Mesh((4,), ("sp",), rank=3)) == (
        3, 4, 12)
