"""The port's ring attentions (``tpu_task_torch.ml.parallel.ring_attention``)
against the JAX package's, on the CPU: one SPMD group of 4 gloo ranks
(``tests/torch_spmd_util.py``), each holding its contiguous chunk of the
sequence, as JAX's ``activation_spec`` lays it out. JAX runs its own
functions on the host devices of this process with its plain (``"xla"``)
blocks; the port's ranks run the flash wrappers, which take the plain
versions on the CPU. Inputs come from a numpy seed.

Tolerances are JAX's own (``tests/test_ml_parallel.py``): the output
within 2e-5, the gradients of ``(o ** 2).sum()`` within 1e-4 (fp32 sums
in another order, folded across blocks in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.parallel import mesh as jmesh
from tpu_task.ml.parallel import ring_attention as jring
from tpu_task_torch.ml.parallel import ring_attention as tring

import torch_sp_cases as cases
from torch_spmd_util import SpmdGroup

FWD_ATOL, GRAD_ATOL = 2e-5, 1e-4


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with SpmdGroup(4, tmp_path_factory.mktemp("spmd")) as g:
        yield g


def qkv(seed, b=2, s=32, h=4, kv=None, d=16):
    rng = np.random.default_rng(seed)
    shapes = [(b, s, h, d)] + [(b, s, kv or h, d)] * 2
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in shapes]


def jax_run(fn, q, k, v):
    """JAX's output and the gradients of ``(o ** 2).sum()``, under one
    ``jit`` (eager shard_map is ten times slower on the CPU)."""
    def both(*args):
        grads = jax.grad(lambda *a: (fn(*a) ** 2).sum(),
                         argnums=(0, 1, 2))(*args)
        return fn(*args), grads

    out, grads = jax.jit(both)(*[jnp.asarray(x) for x in (q, k, v)])
    return np.asarray(out), [np.asarray(g) for g in grads]


def check(ranks, want, grads=True):
    """The ranks' chunks, concatenated in rank order, against JAX."""
    out, jgrads = want
    got = np.concatenate([r["o"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, out, rtol=0, atol=FWD_ATOL)
    if grads:
        for name, jg in zip(("dq", "dk", "dv"), jgrads):
            g = np.concatenate([r[name] for r in ranks], axis=1)
            assert g.shape == jg.shape
            np.testing.assert_allclose(g, jg, rtol=0, atol=GRAD_ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_uniform_ring_matches_jax(group, causal):
    q, k, v = qkv(1)
    jm = jmesh.make_mesh(4, axis_names=("sp",), axis_sizes=(4,))
    want = jax_run(lambda *a: jring.ring_attention(*a, jm, causal=causal),
                   q, k, v)
    ranks = group.run(cases.attention, names=("sp",), sizes=(4,),
                      kind="ring", q=q, k=k, v=v, causal=causal, grads=True)
    check(ranks, want)
    # A hop a ring step each way, none past the last block; the
    # accumulators' hop home.
    assert ranks[0]["collectives"]["ppermute"]["calls"] == 3 + 2 * 3 + 1


@pytest.mark.parametrize("devices", [1, 2, 4])
def test_zigzag_permute_matches_jax(devices):
    x = np.arange(2 * 32 * 3, dtype=np.float32).reshape(2, 32, 3)
    for fn in ("zigzag_permute", "zigzag_unpermute"):
        want = np.asarray(getattr(jring, fn)(jnp.asarray(x), devices))
        got = getattr(tring, fn)(torch.tensor(x), devices)
        np.testing.assert_array_equal(got.numpy(), want)
    z = tring.zigzag_permute(torch.tensor(x), devices)
    np.testing.assert_array_equal(
        tring.zigzag_unpermute(z, devices).numpy(), x)
    on_axis = np.moveaxis(x, 1, 2)
    np.testing.assert_array_equal(
        tring.zigzag_permute(torch.tensor(on_axis), devices, axis=2).numpy(),
        np.asarray(jring.zigzag_permute(jnp.asarray(on_axis), devices,
                                        axis=2)))


def test_zigzag_permute_refuses_what_jax_refuses():
    x = np.zeros((1, 12, 2), np.float32)
    with pytest.raises(ValueError, match="not divisible by 2P=8") as jax_err:
        jring.zigzag_permute(jnp.asarray(x), 4)
    with pytest.raises(ValueError) as port_err:
        tring.zigzag_permute(torch.tensor(x), 4)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="not divisible by 2P=8"):
        tring.zigzag_unpermute(torch.tensor(x), 4)


@pytest.mark.parametrize("sp", [4, 2])
def test_zigzag_ring_matches_jax(group, sp):
    """Forward and gradients at sp 4 and sp 2 (the first two ranks)."""
    q, k, v = qkv(2)
    jm = jmesh.make_mesh(sp, axis_names=("sp",), axis_sizes=(sp,))
    want = jax_run(lambda *a: jring.zigzag_ring_attention(*a, jm), q, k, v)
    ranks = group.run(cases.attention, names=("sp",), sizes=(sp,),
                      kind="zigzag", q=q, k=k, v=v, grads=True)
    assert ranks[sp:] == [None] * (4 - sp)
    check(ranks[:sp], want)
    calls = ranks[0]["collectives"]
    # k/v a ring step, the accumulators a step and home; q/k/v into the
    # stripes and the output back, each with its gradient's exchange.
    assert calls["ppermute"]["calls"] == 3 * (sp - 1) + 1
    assert calls["all_to_all"]["calls"] == 4


def test_zigzag_ring_narrow_kv_matches_jax(group):
    """kv 2 of 4 heads: the ring moves them narrow and dk/dv come back at
    the narrow width."""
    q, k, v = qkv(3, kv=2)
    jm = jmesh.make_mesh(4, axis_names=("sp",), axis_sizes=(4,))
    want = jax_run(lambda *a: jring.zigzag_ring_attention(*a, jm), q, k, v)
    ranks = group.run(cases.attention, names=("sp",), sizes=(4,),
                      kind="zigzag", q=q, k=k, v=v, grads=True)
    assert ranks[0]["dk"].shape == (2, 8, 2, 16)
    check(ranks, want)


def test_zigzag_ring_on_one_rank_is_causal_attention(group):
    """An axis of one: the diagonal's two blocks alone (JAX's
    ``test_zigzag_single_device_degenerates_to_causal``)."""
    q, k, v = qkv(4, b=1, s=16, h=2, d=8)
    jm = jmesh.make_mesh(1, axis_names=("sp",), axis_sizes=(1,))
    want = jax_run(lambda *a: jring.zigzag_ring_attention(*a, jm), q, k, v)
    ranks = group.run(cases.attention, names=("sp",), sizes=(1,),
                      kind="zigzag", q=q, k=k, v=v, grads=True)
    check(ranks[:1], want)
    assert ranks[0]["collectives"] == {}
