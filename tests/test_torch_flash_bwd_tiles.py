"""The wgmma backward kernels' tile schedules (``flash_bwd_tiles`` in
``tpu_task_torch.ml.ops.attention``), on the CPU.

The dq kernel walks, for each 128-row q tile, the forward's kv tiles up to
the last one the tile's last row sees. The dk/dv kernel walks, for each
128-row kv tile, the 64-row q tiles from the one holding the first row
that sees the tile's first key, and masks only the tiles that cross the
diagonal, sq or sk. Here the walked tiles of each schedule, each masked
only where the schedule says, must cover exactly the (query, key) pairs
of a brute-force mask: no visible pair left out, no hidden pair let in by
an unmasked tile, no tile walked that holds nothing visible. Then a
plain-torch walk of both schedules at fp32, in the kernels' exp2 domain
(rows past sq and keys past sk zero, their lse and delta 0), is held to
JAX's Pallas backward in interpret mode within its 5e-5 pin."""

import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_task.ml.ops import attention as ja
from tpu_task_torch.ml.ops import attention as ta

ROOT = Path(__file__).resolve().parents[1]
BWD_ATOL = 5e-5


def _chip_smoke_flash_cases():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return [(sq, sk, causal, q_offset)
            for _, _, sq, sk, _, causal, q_offset in module.FLASH_CASES]


#: (sq, sk, causal, q_offset): chip_smoke.py's FLASH_CASES, the CPU flash
#: file's CASES and the edges of the 64-row q stage and the 128-row kv
#: tile: sq 1, 63, 64, 65, 127, 193, sk 1, 129, 130, offsets that leave
#: 64 or 65 rows or whole tiles seeing nothing, and non-causal pairs.
GEOMETRIES = sorted(set(_chip_smoke_flash_cases() + [
    (128, 128, True, None), (64, 128, True, None), (64, 128, True, 0),
    (128, 64, True, -32), (64, 128, False, None), (128, 128, False, 5),
    (1, 1, True, None), (63, 63, True, None), (64, 64, True, None),
    (65, 65, True, None), (65, 300, True, None), (127, 130, True, None),
    (193, 193, True, None), (193, 129, True, None), (256, 256, True, -64),
    (256, 256, True, -65), (256, 256, True, -200), (300, 1, True, None),
    (1, 129, False, None), (65, 130, False, None)]), key=str)

#: (dk/dv q stage, dk/dv kv tile, dq q tile, dq kv stage): the kernels'
#: own, and a smaller set so that short lengths walk several tiles.
BLOCKS = [(ta.BWD_BLOCK_Q, ta.BWD_BLOCK_K, ta.FWD_BLOCK_Q, ta.FWD_BLOCK_K),
          (16, 32, 32, 32)]


def _offset(sq, sk, q_offset):
    return sk - sq if q_offset is None else q_offset


def _visible(sq, sk, causal, q_offset):
    """(sq, sk): query row i sees key j."""
    if not causal:
        return np.ones((sq, sk), bool)
    return (q_offset + np.arange(sq))[:, None] >= np.arange(sk)[None, :]


def _check_covers(sq, sk, causal, q_offset, blocks):
    block_q, block_k, dq_block_q, dq_block_k = blocks
    vis = _visible(sq, sk, causal, q_offset)
    tiles = ta.flash_bwd_tiles(sq, sk, causal, q_offset, *blocks)

    # dq: q tiles by kv stages, as the forward.
    assert [t.q0 for t in tiles.dq] == list(range(0, sq, dq_block_q))
    width = max([t.n for t in tiles.dq] + [0]) * dq_block_k
    padded = np.zeros((sq, max(width, sk)), bool)
    padded[:, :sk] = vis
    covered = np.zeros_like(padded)
    for q0, n, unmasked in tiles.dq:
        assert 0 <= unmasked <= n
        rows = slice(q0, min(q0 + dq_block_q, sq))
        for t in range(n):
            cols = slice(t * dq_block_k, (t + 1) * dq_block_k)
            assert padded[rows, cols].any(), "a walked kv tile sees nothing"
            covered[rows, cols] = (True if t < unmasked
                                   else padded[rows, cols])
    np.testing.assert_array_equal(covered, padded)

    # dk/dv: kv tiles by q stages, keys on the rows.
    n_q = -(-sq // block_q)
    assert [t.k0 for t in tiles.dkv] == list(range(0, sk, block_k))
    padded = np.zeros((sk, n_q * block_q), bool)
    padded[:, :sq] = vis.T
    covered = np.zeros_like(padded)
    for k0, begin, end, lo, hi in tiles.dkv:
        assert 0 <= begin <= end <= n_q and 0 <= lo and 0 <= hi
        keys = slice(k0, min(k0 + block_k, sk))
        for t in range(begin, end):
            cols = slice(t * block_q, (t + 1) * block_q)
            assert padded[keys, cols].any(), "a walked q tile sees nothing"
            covered[keys, cols] = (True if lo <= t < hi
                                   else padded[keys, cols])
    np.testing.assert_array_equal(covered, padded)


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("sq,sk,causal,q_offset", GEOMETRIES)
def test_schedules_cover_exactly_the_visible_pairs(sq, sk, causal, q_offset,
                                                   blocks):
    _check_covers(sq, sk, causal, _offset(sq, sk, q_offset), blocks)


@settings(max_examples=150, deadline=None)
@given(sq=st.integers(1, 600), sk=st.integers(1, 600),
       q_offset=st.integers(-700, 700), causal=st.booleans(),
       blocks=st.sampled_from(BLOCKS))
def test_schedule_sweep_covers_exactly_the_visible_pairs(sq, sk, q_offset,
                                                         causal, blocks):
    _check_covers(sq, sk, causal, q_offset, blocks)


@pytest.mark.parametrize("s,q_offset,walks", [
    (1024, 0, [(2 * i, 16, 2 * i + 2, 16) for i in range(8)]),
    (256, -64, [(1, 4, 3, 4), (3, 4, 5, 4)]),
    (256, -200, [(3, 4, 6, 4), (0, 0, 0, 0)]),
    (193, 0, [(0, 4, 2, 3), (2, 4, 4, 0)])])
def test_dkv_schedule_worked_cases(s, q_offset, walks):
    """(begin, end, lo, hi) of each kv tile. Causal self-attention at the
    flagship length: kv tile i walks q tiles 2i to 15, masking only the
    two on its diagonal (72 of 128 tile steps a (batch, head)); at -64 the
    first q tile sees nothing; at -200 the second kv tile's walk is empty;
    at s 193 the ragged sk masks every tile of the last kv tile, and the
    ragged sq the last q tile of both."""
    tiles = ta.flash_bwd_tiles(s, s, True, q_offset).dkv
    assert [tuple(t[1:]) for t in tiles] == walks
    if s == 1024:
        assert sum(t.end - t.begin for t in tiles) == 72


def test_tile_constants_match_the_kernel_source():
    text = (ROOT / "tpu_task_torch/csrc/flash_attention.cu").read_text()
    found = dict(re.findall(r"constexpr int (kBwdBlock[QK]) = (\d+);", text))
    assert found == {"kBwdBlockQ": str(ta.BWD_BLOCK_Q),
                     "kBwdBlockK": str(ta.BWD_BLOCK_K)}


def _pad_rows(x, rows):
    """x (b, s, h, d) with zero rows appended up to `rows`, as a TMA box
    past s fills them."""
    pad = torch.zeros((x.shape[0], rows - x.shape[1], *x.shape[2:]))
    return torch.cat([x, pad], 1).transpose(1, 2)           # (b, h, r, d)


def _tiled_backward(q, k, v, do, lse, delta, causal, q_offset, blocks):
    """Both kernels' walks in plain torch at fp32: the schedules of
    ``flash_bwd_tiles``, rows past sq and keys past sk zero with lse and
    delta 0 (lse 0 too for a row that sees no key), each weight
    exp2(s scale log2(e) - lse log2(e)), the mask only on the tiles the
    schedules mask, dq scaled by scale and dk too."""
    block_q, block_k, dq_block_q, dq_block_k = blocks
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    scale_log2 = scale * math.log2(math.e)
    tiles = ta.flash_bwd_tiles(sq, sk, causal, q_offset, *blocks)
    lq = sq + 2 * max(block_q, dq_block_q)
    lk = sk + 2 * max(block_k, dq_block_k)
    qp, dop = _pad_rows(q, lq), _pad_rows(do, lq)
    kp, vp = _pad_rows(k, lk), _pad_rows(v, lk)
    lse2 = torch.zeros((b, h, lq))
    lse2[..., :sq] = torch.where(lse <= ta.NEG_INF / 2,
                                 torch.zeros_like(lse),
                                 lse) * math.log2(math.e)
    dl = torch.zeros((b, h, lq))
    dl[..., :sq] = delta

    def keep(rows, cols):
        ok = (rows[:, None] < sq) & (cols[None, :] < sk)
        if causal:
            ok = ok & (q_offset + rows[:, None] >= cols[None, :])
        return ok

    dq = torch.zeros_like(q)
    for q0, n, unmasked in tiles.dq:
        rows = torch.arange(q0, q0 + dq_block_q)
        acc = torch.zeros((b, h, dq_block_q, d))
        for t in range(n):
            cols = torch.arange(t * dq_block_k, (t + 1) * dq_block_k)
            s = qp[:, :, rows] @ kp[:, :, cols].transpose(-1, -2)
            p = torch.exp2(s * scale_log2 - lse2[:, :, rows, None])
            if t >= unmasked:
                p = torch.where(keep(rows, cols), p, torch.zeros_like(p))
            dp = dop[:, :, rows] @ vp[:, :, cols].transpose(-1, -2)
            ds = p * (dp - dl[:, :, rows, None])
            acc = acc + ds @ kp[:, :, cols]
        valid = min(dq_block_q, sq - q0)
        dq[:, q0:q0 + valid] = (acc * scale)[:, :, :valid].transpose(1, 2)

    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0, begin, end, lo, hi in tiles.dkv:
        keys = torch.arange(k0, k0 + block_k)
        dk_acc = torch.zeros((b, h, block_k, d))
        dv_acc = torch.zeros((b, h, block_k, d))
        for t in range(begin, end):
            cols = torch.arange(t * block_q, (t + 1) * block_q)
            st_ = kp[:, :, keys] @ qp[:, :, cols].transpose(-1, -2)
            p = torch.exp2(st_ * scale_log2 - lse2[:, :, None, cols])
            if not lo <= t < hi:
                p = torch.where(keep(cols, keys).T, p, torch.zeros_like(p))
            dpt = vp[:, :, keys] @ dop[:, :, cols].transpose(-1, -2)
            ds = p * (dpt - dl[:, :, None, cols])
            dv_acc = dv_acc + p @ dop[:, :, cols]
            dk_acc = dk_acc + ds @ qp[:, :, cols]
        valid = min(block_k, sk - k0)
        dk[:, k0:k0 + valid] = (dk_acc * scale)[:, :, :valid].transpose(1, 2)
        dv[:, k0:k0 + valid] = dv_acc[:, :, :valid].transpose(1, 2)
    return dq, dk, dv


#: The CPU flash file's CASES, then the 64-row q stage's edges (sq 65 and
#: 193, q_offset -64), sq 129 and 200 and q_offset -130.
WALK_CASES = [(True, 128, 128, None), (True, 64, 128, None),
              (True, 64, 128, 0), (True, 128, 64, -32),
              (False, 64, 128, None), (False, 128, 128, 5),
              (True, 65, 65, None), (True, 193, 193, None),
              (True, 256, 256, -64), (True, 129, 129, None),
              (True, 200, 328, None), (False, 200, 328, None),
              (True, 256, 256, -130)]


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("causal,sq,sk,q_offset", WALK_CASES)
def test_tiled_walk_matches_jax_kernels(causal, sq, sk, q_offset, blocks):
    rng = np.random.default_rng(11)
    q, k, v, do = (rng.normal(size=(2, n, 2, 32)).astype(np.float32)
                   for n in (sq, sk, sk, sq))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = ja.flash_attention(jq, jk, jv, causal, q_offset=q_offset,
                                interpret=True, return_lse=True)
    ref = ja.flash_attention_bwd(jq, jk, jv, o, lse, jdo, causal,
                                 q_offset=q_offset, interpret=True)
    delta = (np.asarray(do) * np.asarray(o)).sum(-1).transpose(0, 2, 1)
    got = _tiled_backward(*map(torch.tensor, (q, k, v, do)),
                          torch.tensor(np.asarray(lse)),
                          torch.tensor(np.ascontiguousarray(delta)), causal,
                          _offset(sq, sk, q_offset), blocks)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=BWD_ATOL)
    hidden = max(0, -_offset(sq, sk, q_offset)) if causal else 0
    if hidden:                        # rows that see no key: exactly 0
        assert (got[0][:, :hidden] == 0).all()
