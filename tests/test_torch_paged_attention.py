"""The port's paged attention (``tpu_task_torch.ml.ops.paged_attention``)
against the JAX package's, at fp32 on the CPU.

The port's plain version is held to both JAX functions — the Pallas
kernel run in interpret mode and the XLA gather reference — over
fragmented block tables, a shared first block, mid-block positions,
GQA groups 1, 2 and 4, and widths 1 and 3, comparing valid rows only
where rows are invalid (as ``tests/test_paged_attention.py`` does).
ATOL is that suite's accumulation-order pin. On a CPU tensor the kernel's
wrapper takes the plain version and counts it there; the kernel itself
only runs on the card (``test_torch_cuda_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.ops import paged_attention as jpa
from tpu_task_torch.ml.ops import paged_attention as tpa

ATOL = 2e-5


def _case(rng, slots=4, w=1, h=4, kv=2, d=16, n_blocks=32, bs=8,
          max_blocks=5):
    """A fragmented paged layout: blocks in scrambled order, two slots
    sharing their first block, scratch-sentinel tails, per-row depths that
    stop mid-block, and a fresh slot at position 0."""
    q = rng.normal(size=(slots, w, h, d)).astype(np.float32)
    kp = rng.normal(size=(n_blocks, bs, kv, d)).astype(np.float32)
    vp = rng.normal(size=(n_blocks, bs, kv, d)).astype(np.float32)
    tables = np.zeros((slots, max_blocks), np.int32)
    perm = rng.permutation(np.arange(1, n_blocks))
    pos = np.zeros((slots, w), np.int32)
    used = 0
    for s in range(slots):
        depth = int(rng.integers(1, max_blocks * bs - w))
        n_full = (depth + w - 1) // bs + 1
        tables[s, :n_full] = perm[used:used + n_full]
        used += n_full
        pos[s] = depth + np.arange(w)
    tables[1, 0] = tables[0, 0]
    pos[-1, :] = np.arange(w)
    return q, kp, vp, tables, pos


def _port(fn, q, kp, vp, tables, pos):
    return fn(torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
              torch.tensor(tables), torch.tensor(pos)).numpy()


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("w", [1, 3])
def test_plain_matches_jax_kernel_and_reference(group, w):
    rng = np.random.default_rng(10 * group + w)
    q, kp, vp, tables, pos = _case(rng, w=w, h=2 * group, kv=2)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, pos)]
    got = _port(tpa.paged_reference_attention, q, kp, vp, tables, pos)
    np.testing.assert_allclose(
        got, np.asarray(jpa.paged_decode_attention(*jargs, interpret=True)),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jpa.paged_reference_attention(*jargs)),
        atol=ATOL, rtol=0)


def test_invalid_rows_compare_on_valid_rows_only():
    """The spec-shaped width with invalid tail positions zeroed: outputs
    for them are garbage the host discards; valid rows must agree."""
    rng = np.random.default_rng(7)
    q, kp, vp, tables, pos = _case(rng, w=4)
    valid = np.ones_like(pos, bool)
    valid[0, 2:] = False
    valid[2, 1:] = False
    pos = np.where(valid, pos, 0).astype(np.int32)
    got = _port(tpa.paged_reference_attention, q, kp, vp, tables, pos)
    ref = jpa.paged_decode_attention(
        *[jnp.asarray(a) for a in (q, kp, vp, tables, pos)], interpret=True)
    np.testing.assert_allclose(got[valid], np.asarray(ref)[valid],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["cuda", "reference"])
def test_dispatch_on_cpu_runs_the_plain_version(impl):
    """On CPU tensors both impls compute the plain version and count it
    there: the kernel's counter never moves off the card."""
    rng = np.random.default_rng(3)
    q, kp, vp, tables, pos = _case(rng, w=1)
    tpa.reset_launch_counts()
    got = tpa.paged_attention(
        torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
        torch.tensor(tables), torch.tensor(pos[:, 0]), impl=impl).numpy()
    assert tpa.paged_decode_attention.launches == 0
    assert tpa.paged_reference_attention.launches == 1
    np.testing.assert_array_equal(
        got, _port(tpa.paged_reference_attention, q, kp, vp, tables, pos))
    with pytest.raises(ValueError, match="unknown"):
        tpa.paged_attention(torch.tensor(q), torch.tensor(kp),
                            torch.tensor(vp), torch.tensor(tables),
                            torch.tensor(pos), impl="pallas")
