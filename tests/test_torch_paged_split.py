"""The tile kernel's split-KV plan and the plain versions of its two
kernels (``paged_split_partials``, ``combine_partials``) against the JAX
package's paged attention, at fp32 on the CPU.

``csrc/paged_decode.cu`` cuts each row's KV walk over several CTAs, each
writing a partial softmax state (m, l, acc), and a combine kernel merges
them. Merging the plain partial states of any split count must give the
unsplit function: JAX's Pallas kernel in interpret mode and the port's
gather reference, within ATOL, the accumulation-order pin of
``tests/test_paged_attention.py`` (the same values summed in another
order). Tables are fragmented and ``MAX_BLOCKS`` is not a whole number of
tiles, so the last split is ragged; rows end before the last split, one is
fresh at position 0, and widths 1 and 3 mix positions inside a split. The
kernels themselves run only on the card (``test_torch_cuda_kernels.py``)."""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.ops import paged_attention as jpa
from tpu_task.ml.serving import cache as jc
from tpu_task_torch.ml.ops import paged_attention as tpa
from tpu_task_torch.ml.serving import cache as tc

ATOL = 2e-5
#: Block 8 makes 8-block tiles; 30 blocks are 4 tiles, the last of 6.
BS, MAX_BLOCKS = 8, 30
TILES = tpa.n_tiles(MAX_BLOCKS, BS)
SPLITS = [1, 2, 3, TILES]

#: (kv_dtype, JAX code dtype, port code dtype)
CODES = {"int8": (jnp.int8, torch.int8),
         "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
         "int4": (jnp.uint8, torch.uint8)}
#: (kv_dtype, group, w): the model dtype at every group, each quantized
#: storage type at group 2.
CASES = [(None, g, w) for g in (1, 2, 4) for w in (1, 3)] + \
        [(kv, 2, w) for kv in CODES for w in (1, 3)]


def _case(rng, w, h, kv=2, d=16, slots=5):
    """Fragmented tables with two rows sharing their first block; row 0
    reaches into the ragged last tile, row 1 ends mid-table, row 2 inside
    the first tile (before every later split), row 4 is fresh at position
    0. Pool values take a different scale per block."""
    n_blocks = 1 + slots * MAX_BLOCKS
    q = rng.normal(size=(slots, w, h, d)).astype(np.float32)
    spread = rng.uniform(0.5, 2.0, (n_blocks, 1, kv, 1))
    kp = (rng.normal(size=(n_blocks, BS, kv, d)) * spread).astype(np.float32)
    vp = (rng.normal(size=(n_blocks, BS, kv, d)) * spread).astype(np.float32)
    depths = [MAX_BLOCKS * BS - w, int(rng.integers(130, 200)),
              int(rng.integers(1, 60)), int(rng.integers(60, 230)), 0]
    tables = np.zeros((slots, MAX_BLOCKS), np.int32)
    pos = np.zeros((slots, w), np.int32)
    perm = rng.permutation(np.arange(1, n_blocks))
    used = 0
    for s, depth in enumerate(depths):
        n = min((depth + w - 1) // BS + 1, MAX_BLOCKS)
        tables[s, :n] = perm[used:used + n]
        used += n
        pos[s] = depth + np.arange(w)
    tables[1, 0] = tables[0, 0]
    return q, kp, vp, tables, pos


@functools.lru_cache(maxsize=None)
def _inputs(kv_dtype, group, w):
    """(port args, JAX's interpret-mode kernel output) of one case."""
    rng = np.random.default_rng(100 * group + 10 * w + len(kv_dtype or ""))
    q, kp, vp, tables, pos = _case(rng, w=w, h=2 * group)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, pos)]
    targs = [torch.tensor(a) for a in (q, kp, vp, tables, pos)]
    if kv_dtype:
        jdt, tdt = CODES[kv_dtype]
        (jk, jks), (jv, jvs) = (jc.quantize_blocks(a, jdt)
                                for a in jargs[1:3])
        jargs = [jargs[0], jk, jv, *jargs[3:], jks, jvs]

        def port(codes):
            return torch.tensor(np.asarray(codes).view(np.uint8)).view(tdt)

        targs = [targs[0], port(jk), port(jv), *targs[3:],
                 torch.tensor(np.asarray(jks)), torch.tensor(np.asarray(jvs))]
    want = np.asarray(jpa.paged_decode_attention(*jargs, interpret=True))
    return targs, want


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("kv_dtype,group,w", CASES)
def test_merged_splits_match_jax_and_plain(kv_dtype, group, w, splits):
    if kv_dtype == "fp8" and not (jc.fp8_supported() and tc.fp8_supported()):
        pytest.skip("float8_e4m3fn is not supported by both packages here")
    args, want = _inputs(kv_dtype, group, w)
    partials = tpa.paged_split_partials(*args, splits=splits)
    rows, _, h, d = args[0].shape
    assert partials.shape == (rows, w, h, splits, 2 + d)
    assert partials.dtype == torch.float32
    got = tpa.combine_partials(partials).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        got, tpa.paged_reference_attention(*args).numpy(), atol=ATOL, rtol=0)
    # Row 2 ends inside the first tile: every later split is empty for it.
    for s, (lo, _) in enumerate(tpa.split_ranges(MAX_BLOCKS, BS, splits)):
        if lo * BS > int(args[4][2].max()):
            assert (partials[2, :, :, s, 0] == tpa.NEG_INF).all()
            assert (partials[2, :, :, s, 1:] == 0).all()
    # The fresh row sees slot 0 only.
    assert (partials[4, :, :, 1:, 0] == tpa.NEG_INF).all()


def test_split_states_are_the_online_softmax():
    """Each split's (m, l, acc) is its slice's max score, its sum of
    e^(s - m) and its unnormalised p.v: a split over all the slots is the
    dense softmax's numerator and denominator."""
    args, _ = _inputs(None, 2, 1)
    q, kp, vp, tables, pos = args
    (m, l, acc) = (lambda p: (p[..., 0], p[..., 1], p[..., 2:]))(
        tpa.paged_split_partials(*args, splits=1)[:, :, :, 0])
    k_view = tc.gather_kv(tc.flat_pool(kp), tables, BS)
    v_view = tc.gather_kv(tc.flat_pool(vp), tables, BS)
    kv = kp.shape[2]
    scores = torch.einsum("bwhd,blhd->bwhl", q,
                          k_view.repeat_interleave(q.shape[2] // kv, 2))
    scores = scores / q.shape[-1] ** 0.5
    seen = torch.arange(k_view.shape[1]) <= pos[:, :, None, None]
    scores = torch.where(seen, scores, torch.full_like(scores, tpa.NEG_INF))
    torch.testing.assert_close(m, scores.amax(-1), atol=ATOL, rtol=0)
    p = torch.where(seen, torch.exp(scores - m[..., None]), 0.0)
    torch.testing.assert_close(l, p.sum(-1), atol=ATOL, rtol=1e-6)
    torch.testing.assert_close(
        acc, torch.einsum("bwhl,blhd->bwhd", p,
                          v_view.repeat_interleave(q.shape[2] // kv, 2)),
        atol=1e-4, rtol=1e-5)


def test_combine_of_empty_splits_is_exactly_zero():
    """A query no split shows a slot merges to exactly 0, never NaN, and an
    empty split beside a full one changes nothing."""
    d = 16
    empty = torch.zeros((3, 2, 4, d + 2))
    empty[..., 0] = tpa.NEG_INF
    out = tpa.combine_partials(empty)
    assert torch.equal(out, torch.zeros((3, 2, d)))
    full = torch.randn((3, 2, 1, d + 2))
    full[..., 1] = full[..., 1].abs() + 0.5
    mixed = torch.cat([empty[:, :, :2], full, empty[:, :, 2:]], dim=2)
    torch.testing.assert_close(tpa.combine_partials(mixed),
                               tpa.combine_partials(full), atol=0, rtol=0)
    assert tpa.combine_partials(empty, torch.bfloat16).dtype == \
        torch.bfloat16
    # A whole batch of positions before slot 0 sees nothing at all.
    args, _ = _inputs(None, 2, 3)
    none = torch.full_like(args[4], -1)
    for splits in SPLITS:
        merged = tpa.combine_partials(
            tpa.paged_split_partials(*args[:4], none, splits=splits))
        assert torch.equal(merged, torch.zeros_like(merged))


#: Worked cases of the plan at the flagship decode and chunk shapes (kv 2,
#: block 16, tables 72 wide = 18 tiles) on an H100's 132 SMs at 2 CTAs an SM.
@pytest.mark.parametrize("rows,splits", [(16, 9), (1, 18), (32, 5),
                                         (144, 1), (132, 1), (0, 1)])
def test_split_plan_worked_cases(rows, splits):
    assert tpa.split_plan(rows, 2, 72, 16, 132, 2) == splits


@pytest.mark.parametrize("bs", [4, 8, 16, 32, 64, 128])
def test_split_plan_properties(bs):
    """Over a grid of shapes: at least one split, no more than the table's
    tiles, each a whole number of tiles (the last may be ragged) and, taken
    together, covering the table once with no empty split; a grid short of
    one resident wave is split, one that fills it is not."""
    tile = tpa.tile_blocks_for(bs)
    for rows, kv, max_blocks, n_sms, ctas in itertools.product(
            (1, 2, 5, 16, 33, 144, 600), (1, 2, 8), (1, 3, 5, 18, 72, 129),
            (1, 132), (1, 2, 3)):
        tiles = tpa.n_tiles(max_blocks, bs)
        splits = tpa.split_plan(rows, kv, max_blocks, bs, n_sms, ctas)
        assert 1 <= splits <= tiles
        ranges = tpa.split_ranges(max_blocks, bs, splits)
        assert ranges[0][0] == 0 and ranges[-1][1] == max_blocks
        for (lo, hi), (nxt, _) in zip(ranges, ranges[1:]):
            assert hi == nxt and lo < hi and (hi - lo) % tile == 0
        assert ranges[-1][0] < ranges[-1][1]
        short = rows * kv < n_sms * ctas
        assert (splits > 1) == (short and tiles > 1)


@pytest.mark.parametrize("max_blocks", [1, 7, 18, 30, 72])
def test_forced_split_ranges_cover_the_table_once(max_blocks):
    """Any forced count 1 .. tiles: tile-aligned starts, contiguous, the
    table covered once; counts past what ceil(tiles / splits) needs leave
    empty splits at the end, which the kernel fills with the empty
    state."""
    for bs in (4, 8, 16, 64):
        tile = tpa.tile_blocks_for(bs)
        for splits in range(1, tpa.n_tiles(max_blocks, bs) + 1):
            ranges = tpa.split_ranges(max_blocks, bs, splits)
            assert len(ranges) == splits and ranges[0][0] == 0
            assert all(lo % tile == 0 or lo == max_blocks
                       for lo, _ in ranges)
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            assert ranges[-1][1] == max_blocks


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_wrapper_on_cpu_runs_the_plain_version(kv_dtype):
    """On CPU tensors the wrapper computes the plain version and counts it
    there; neither the kernel's nor the combine's counter moves."""
    args, _ = _inputs(kv_dtype, 2, 1)
    tpa.reset_launch_counts()
    got = tpa.paged_decode_attention(*args)
    assert tpa.paged_decode_attention.launches == 0
    assert tpa.paged_decode_attention.combine_launches == 0
    assert tpa.paged_reference_attention.launches == 1
    assert torch.equal(got, tpa.paged_reference_attention(*args))


def test_forced_splits_are_checked_before_any_launch():
    """A forced split count outside 1 .. tiles, for either kernel, or
    split-state scratch of the wrong shape, raises before a library is
    built or loaded."""
    args, _ = _inputs(None, 2, 1)
    out = torch.empty_like(args[0])
    for pipelined in (False, True):
        for bad in (0, TILES + 1):
            with pytest.raises(ValueError, match="splits must be"):
                tpa._launch(*args, out, pipelined=pipelined, splits=bad)
        with pytest.raises(ValueError, match="partials must be"):
            tpa._launch(*args, out, pipelined=pipelined, splits=2,
                        partials=torch.empty(1))
