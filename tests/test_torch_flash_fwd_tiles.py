"""The wgmma forward kernel's tile schedule (``flash_fwd_tiles`` in
``tpu_task_torch.ml.ops.attention``), on the CPU.

The kernel walks, for each 128-row q tile, the kv tiles up to the last one
the tile's last row sees, and masks only the tiles that cross the diagonal
or the ragged edge sk. Here the walked tiles, each masked only where the
schedule says, must cover exactly the (query, key) pairs of a brute-force
mask: no visible pair left out, no hidden pair let in by an unmasked tile,
no tile walked that holds nothing visible. Then a plain-torch walk of the
same schedule at fp32, with the kernel's statistics (the running max on
raw scores, weights in the exp2 domain), is held to JAX's Pallas forward
in interpret mode within its 2e-5 pin."""

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
FWD_ATOL = 2e-5


def _chip_smoke_flash_cases():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return [(sq, sk, causal, q_offset)
            for _, _, sq, sk, _, causal, q_offset in module.FLASH_CASES]


#: (sq, sk, causal, q_offset): chip_smoke.py's FLASH_CASES, the CPU flash
#: file's CASES (tests/test_torch_flash_attention.py) and the 128-row tile
#: edges: sq 1, 127, 129, 200, 257, sk < sq, whole tiles of rows that see
#: nothing (-96, -130), and non-causal pairs.
GEOMETRIES = sorted(set(_chip_smoke_flash_cases() + [
    (128, 128, True, None), (64, 128, True, None), (64, 128, True, 0),
    (128, 64, True, -32), (64, 128, False, None), (128, 128, False, 5),
    (1, 1, True, None), (1, 300, True, None), (127, 127, True, None),
    (129, 129, True, None), (200, 328, True, None), (257, 300, True, None),
    (257, 129, True, None), (300, 200, False, None), (256, 256, True, -96),
    (256, 256, True, -130), (384, 384, True, None), (1, 1, False, None),
    (129, 1, False, None)]), key=str)

#: The kernel's tiles (d 64 and d 128 take the same 128 x 128), and a
#: smaller pair so that short lengths walk several tiles.
BLOCKS = [(ta.FWD_BLOCK_Q, ta.FWD_BLOCK_K), (32, 32)]


def _offset(sq, sk, q_offset):
    return sk - sq if q_offset is None else q_offset


def _visible(sq, sk, causal, q_offset):
    if not causal:
        return np.ones((sq, sk), bool)
    return (q_offset + np.arange(sq))[:, None] >= np.arange(sk)[None, :]


def _check_covers(sq, sk, causal, q_offset, block_q, block_k):
    vis = _visible(sq, sk, causal, q_offset)
    tiles = ta.flash_fwd_tiles(sq, sk, causal, q_offset, block_q, block_k)
    assert [t.q0 for t in tiles] == list(range(0, sq, block_q))
    width = max([t.n for t in tiles] + [0]) * block_k
    padded = np.zeros((sq, max(width, sk)), bool)
    padded[:, :sk] = vis
    covered = np.zeros_like(padded)
    for q0, n, unmasked in tiles:
        assert 0 <= unmasked <= n
        rows = slice(q0, min(q0 + block_q, sq))
        for t in range(n):
            cols = slice(t * block_k, (t + 1) * block_k)
            assert padded[rows, cols].any(), "a walked tile sees nothing"
            covered[rows, cols] = (True if t < unmasked
                                   else padded[rows, cols])
    np.testing.assert_array_equal(covered, padded)


@pytest.mark.parametrize("block_q,block_k", BLOCKS)
@pytest.mark.parametrize("sq,sk,causal,q_offset", GEOMETRIES)
def test_schedule_covers_exactly_the_visible_pairs(sq, sk, causal, q_offset,
                                                   block_q, block_k):
    _check_covers(sq, sk, causal, _offset(sq, sk, q_offset), block_q,
                  block_k)


@settings(max_examples=150, deadline=None)
@given(sq=st.integers(1, 600), sk=st.integers(1, 600),
       q_offset=st.integers(-700, 700), causal=st.booleans(),
       blocks=st.sampled_from(BLOCKS))
def test_schedule_sweep_covers_exactly_the_visible_pairs(sq, sk, q_offset,
                                                         causal, blocks):
    _check_covers(sq, sk, causal, q_offset, *blocks)


@pytest.mark.parametrize("q_offset,n,unmasked", [
    (0, [1, 2, 3, 4, 5, 6, 7, 8], [0, 1, 2, 3, 4, 5, 6, 7]),
    (-130, [0, 1], [0, 0]), (-96, [1, 2], [0, 0])])
def test_schedule_worked_cases(q_offset, n, unmasked):
    """Causal self-attention at the flagship length walks 1 to 8 tiles,
    masking only the diagonal one; at -130 the first q tile sees no key,
    and at -96 no tile of the walk is seen whole by its first row."""
    s = 1024 if q_offset == 0 else 256
    tiles = ta.flash_fwd_tiles(s, s, True, q_offset)
    assert [t.n for t in tiles] == n
    assert [t.unmasked for t in tiles] == unmasked


def test_tile_constants_match_the_kernel_source():
    text = (ROOT / "tpu_task_torch/csrc/flash_attention.cu").read_text()
    found = dict(re.findall(r"constexpr int (kFwdBlock[QK]) = (\d+);", text))
    assert found == {"kFwdBlockQ": str(ta.FWD_BLOCK_Q),
                     "kFwdBlockK": str(ta.FWD_BLOCK_K)}


def _tiled_forward(q, k, v, causal, q_offset, block_q, block_k):
    """The kernel's walk in plain torch at fp32: per (batch, head) and q
    tile, the kv tiles of the schedule (rows past sk zero, as the TMA fills
    them), the mask only on the tiles the schedule masks (-inf), the
    running max on the raw scores, each weight exp2(s scale log2(e) -
    shift), and lse = m scale + log(l)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    scale_log2 = scale * math.log2(math.e)
    tiles = ta.flash_fwd_tiles(sq, sk, causal, q_offset, block_q, block_k)
    width = max([t.n for t in tiles] + [1]) * block_k
    pad = torch.zeros((b, max(0, width - sk), h, d), dtype=k.dtype)
    kp, vp = torch.cat([k, pad], 1), torch.cat([v, pad], 1)
    o = torch.zeros_like(q)
    lse = torch.zeros((b, h, sq))
    for q0, n, unmasked in tiles:
        rows = torch.arange(q0, min(q0 + block_q, sq))
        qt = q[:, rows].transpose(1, 2)                     # (b, h, r, d)
        m = torch.full((b, h, len(rows)), -math.inf)
        l = torch.zeros((b, h, len(rows)))
        acc = torch.zeros((b, h, len(rows), d))
        for t in range(n):
            cols = torch.arange(t * block_k, (t + 1) * block_k)
            kt, vt = kp[:, cols].transpose(1, 2), vp[:, cols].transpose(1, 2)
            s = qt @ kt.transpose(-1, -2)
            if t >= unmasked:
                keep = cols[None, :] < sk
                if causal:
                    keep = keep & (q_offset + rows[:, None] >= cols[None, :])
                s = s.masked_fill(~keep, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            shift = torch.where(m_new == -math.inf, torch.zeros_like(m_new),
                                m_new * scale_log2)
            corr = torch.exp2(m * scale_log2 - shift)
            p = torch.exp2(s * scale_log2 - shift[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vt
            m = m_new
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        o[:, rows] = (acc / l_safe[..., None]).transpose(1, 2)
        lse[:, :, rows] = torch.where(l == 0, torch.full_like(l, ta.NEG_INF),
                                      m * scale + torch.log(l_safe))
    return o, lse


#: The CPU flash file's CASES, then sq 129 and 200 and q_offset -130.
WALK_CASES = [(True, 128, 128, None), (True, 64, 128, None),
              (True, 64, 128, 0), (True, 128, 64, -32),
              (False, 64, 128, None), (False, 128, 128, 5),
              (True, 129, 129, None), (True, 200, 328, None),
              (False, 200, 328, None), (True, 256, 256, -130)]


@pytest.mark.parametrize("block_q,block_k", BLOCKS)
@pytest.mark.parametrize("causal,sq,sk,q_offset", WALK_CASES)
def test_tiled_walk_matches_jax_kernel(causal, sq, sk, q_offset, block_q,
                                       block_k):
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, n, 2, 32)).astype(np.float32)
               for n in (sq, sk, sk))
    ref_o, ref_lse = ja.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
        q_offset=q_offset, interpret=True, return_lse=True)
    o, lse = _tiled_forward(torch.tensor(q), torch.tensor(k),
                            torch.tensor(v), causal,
                            _offset(sq, sk, q_offset), block_q, block_k)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=0,
                               atol=FWD_ATOL)
    hidden = max(0, -_offset(sq, sk, q_offset)) if causal else 0
    if hidden:                        # rows that see no key: JAX's values
        assert (o[:, :hidden] == 0).all()
        assert (lse[:, :, :hidden] == ta.NEG_INF).all()
