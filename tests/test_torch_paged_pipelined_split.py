"""The pipelined paged-decode kernel's split-KV walk
(``csrc/paged_decode_pipelined.cu``) on the CPU: its split arithmetic, its
plain versions against the JAX package, and its wrapper's checks.

The pipelined kernel cuts each row's walk into splits of whole 64-token
stages, as the tile kernel cuts it into 64-token tiles, and merges the
splits' partial softmax states with the same combine kernel. A stage is a
tile at every block size, so ``split_plan``, ``split_blocks``,
``split_ranges`` and the plain ``paged_split_partials`` serve both kernels.
The merged plain split states at stage-aligned split counts are held to
JAX's ``paged_decode_attention(..., interpret=True)`` and JAX's
``paged_reference_attention`` within ATOL, the accumulation-order pin of
``tests/test_paged_attention.py``: JAX's own pipelined kernel does not run
under this jax version (``pltpu.TPUMemorySpace`` is gone), so the function
both kernels compute is held to these. Block 16 and d 16 are the flagship's
block size and the smallest head dim of the kernel's tensor-core path;
tables of 14 blocks are 4 stages, the last ragged. The kernel itself runs
only on the card (``test_torch_cuda_kernels.py``)."""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.ops import paged_attention as jpa
from tpu_task.ml.serving import cache as jc
from tpu_task_torch.ml.ops import _build
from tpu_task_torch.ml.ops import paged_attention as tpa
from tpu_task_torch.ml.serving import cache as tc

ATOL = 2e-5
BS, MAX_BLOCKS, D = 16, 14, 16
STAGES = tpa.n_tiles(MAX_BLOCKS, BS)
SPLITS = [1, 2, 3, STAGES]
CSRC = Path(tpa.__file__).resolve().parents[2] / "csrc"

#: (JAX code dtype, port code dtype) of each quantized storage type.
CODES = {"int8": (jnp.int8, torch.int8),
         "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
         "int4": (jnp.uint8, torch.uint8)}


def test_stage_count_is_four_with_a_ragged_last_stage():
    assert STAGES == 4 and MAX_BLOCKS % tpa.stage_blocks_for(BS) != 0


@pytest.mark.parametrize("bs", [4, 8, 16, 32, 64, 128])
def test_stage_blocks_equal_tile_blocks(bs):
    """One split arithmetic serves both kernels only while a stage of the
    pipelined kernel is a tile of the tile kernel."""
    assert tpa.stage_blocks_for(bs) == tpa.tile_blocks_for(bs)
    assert tpa.stage_blocks_for(bs) * bs >= min(bs, tpa.STAGE_TOKENS)


def test_stage_and_tile_tokens_match_the_kernel_sources():
    """The Python constants are the CUDA sources' own."""
    def constant(source, name):
        text = (CSRC / source).read_text()
        return int(re.search(rf"constexpr int {name} = (\d+);", text)
                   .group(1))

    assert constant("paged_decode_pipelined.cu", "kStageTokens") \
        == tpa.STAGE_TOKENS == tpa.TILE_TOKENS \
        == constant("paged_decode.cu", "kTileTokens")


def _c_entry_points(source):
    """{name: [parameter types]} of the extern "C" functions of a source."""
    text = (CSRC / source).read_text()
    text = text[text.index('extern "C" {'):]
    found = re.findall(r"^(?:int|const char\*) (tt_\w+)\(([^)]*)\)", text,
                       flags=re.M)
    return {name: [" ".join(p.split()[:-1]) for p in params.split(",")]
            for name, params in found}


@pytest.mark.parametrize("library", sorted(_build.SIGNATURES))
def test_ctypes_signatures_match_the_c_entry_points(library):
    """Every C entry point of a library is declared to ctypes with one
    argument type per parameter: ``c_void_p`` for each pointer and the
    stream, ``c_int`` for each int (a wrong count or type would pass a cut
    pointer or shift every argument after it)."""
    entries = _c_entry_points(f"{library}.cu")
    assert set(entries) == set(_build.SIGNATURES[library])
    for name, (_, argtypes) in _build.SIGNATURES[library].items():
        want = [_build._P if "*" in p else _build._I for p in entries[name]]
        assert argtypes == want, name


#: Worked cases of the plan at the flagship decode (16 rows), batch 1 and
#: 32 and chunk (144 rows) shapes: kv 2, block 16, tables 72 wide = 18
#: stages, on an H100's 132 SMs, at the occupancies the pipelined kernel's
#: instantiations can have (CTAs an SM).
@pytest.mark.parametrize("rows,ctas_per_sm,splits", [
    (16, 1, 5), (16, 2, 9), (16, 3, 9), (16, 4, 9), (16, 5, 18), (16, 6, 18),
    (1, 1, 18), (1, 4, 18), (32, 2, 5), (32, 4, 9), (32, 6, 9),
    (144, 1, 1), (144, 2, 1), (144, 3, 2), (144, 4, 2), (144, 6, 3)])
def test_split_plan_worked_cases_at_pipelined_occupancy(rows, ctas_per_sm,
                                                        splits):
    assert tpa.split_plan(rows, 2, 72, 16, 132, ctas_per_sm) == splits
    ranges = tpa.split_ranges(72, 16, splits)
    assert all((hi - lo) % tpa.stage_blocks_for(16) == 0
               for lo, hi in ranges[:-1])


def _case(rng, w, h, kv=2, slots=5):
    """Fragmented tables; row 0 reaches into the ragged last stage, row 1
    ends in the second stage, row 2 inside the first (every later split is
    empty for it), row 3 somewhere, row 4 is fresh at position 0. Pool
    values take a different scale per block."""
    n_blocks = 1 + slots * MAX_BLOCKS
    q = rng.normal(size=(slots, w, h, D)).astype(np.float32)
    spread = rng.uniform(0.5, 2.0, (n_blocks, 1, kv, 1))
    kp = (rng.normal(size=(n_blocks, BS, kv, D)) * spread).astype(np.float32)
    vp = (rng.normal(size=(n_blocks, BS, kv, D)) * spread).astype(np.float32)
    depths = [MAX_BLOCKS * BS - w, int(rng.integers(70, 120)),
              int(rng.integers(1, 50)), int(rng.integers(50, 200)), 0]
    tables = np.zeros((slots, MAX_BLOCKS), np.int32)
    pos = np.zeros((slots, w), np.int32)
    perm = rng.permutation(np.arange(1, n_blocks))
    used = 0
    for s, depth in enumerate(depths):
        n = min((depth + w - 1) // BS + 1, MAX_BLOCKS)
        tables[s, :n] = perm[used:used + n]
        used += n
        pos[s] = depth + np.arange(w)
    return q, kp, vp, tables, pos


@functools.lru_cache(maxsize=None)
def _inputs(kv_dtype, group, w):
    """(port args, JAX's interpret-mode kernel output, JAX's reference) of
    one case, from one numpy seed."""
    rng = np.random.default_rng(1000 + 100 * group + 10 * w
                                + len(kv_dtype or ""))
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
    kernel = np.asarray(jpa.paged_decode_attention(*jargs, interpret=True))
    reference = np.asarray(jpa.paged_reference_attention(*jargs))
    return targs, kernel, reference


def _skip_without_fp8(kv_dtype):
    if kv_dtype == "fp8" and not (jc.fp8_supported() and tc.fp8_supported()):
        pytest.skip("float8_e4m3fn is not supported by both packages here")


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("w", [1, 3])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8", "int4"])
def test_merged_stage_splits_match_jax(kv_dtype, group, w, splits):
    """The merge of the plain split states at stage-aligned split counts
    against JAX's interpret-mode kernel and JAX's reference, fp32 pools and
    int8, fp8 and int4 codes alike; a row's splits past its depth are the
    empty state."""
    _skip_without_fp8(kv_dtype)
    args, kernel, reference = _inputs(kv_dtype, group, w)
    partials = tpa.paged_split_partials(*args, splits=splits)
    rows, _, h, d = args[0].shape
    assert partials.shape == (rows, w, h, splits, tpa.PARTIAL_HEAD + d)
    got = tpa.combine_partials(partials).numpy()
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, reference, atol=ATOL, rtol=0)
    for s, (lo, _) in enumerate(tpa.split_ranges(MAX_BLOCKS, BS, splits)):
        assert lo % tpa.stage_blocks_for(BS) == 0 or lo == MAX_BLOCKS
        if lo * BS > int(args[4][2].max()):
            assert (partials[2, :, :, s, 0] == tpa.NEG_INF).all()
            assert (partials[2, :, :, s, 1:] == 0).all()


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8", "int4"])
def test_pipelined_wrapper_on_cpu_runs_the_plain_version(kv_dtype):
    """On CPU tensors the pipelined wrapper computes the plain version and
    counts it there; neither its kernel's counter nor its combine's
    moves."""
    _skip_without_fp8(kv_dtype)
    args, kernel, _ = _inputs(kv_dtype, 2, 1)
    tpa.reset_launch_counts()
    got = tpa.paged_decode_pipelined_attention(*args)
    assert tpa.paged_decode_pipelined_attention.launches == 0
    assert tpa.paged_decode_pipelined_attention.combine_launches == 0
    assert tpa.paged_decode_attention.launches == 0
    assert tpa.paged_reference_attention.launches == 1
    assert torch.equal(got, tpa.paged_reference_attention(*args))
    np.testing.assert_allclose(got.numpy(), kernel, atol=ATOL, rtol=0)
    via_dispatch = tpa.paged_attention(*args[:5], *args[5:],
                                       impl="pipelined")
    assert torch.equal(via_dispatch, got)


@pytest.mark.parametrize("bad", [0, STAGES + 1, -1])
def test_pipelined_forced_splits_out_of_range_raise(bad):
    """A forced split count outside 1 .. stages raises before any library
    is built or loaded (there is no nvcc here), and counts nothing."""
    args, _, _ = _inputs("int8", 2, 1)
    tpa.reset_launch_counts()
    with pytest.raises(ValueError, match="splits must be"):
        tpa._launch(*args[:5], torch.empty_like(args[0]), *args[5:],
                    pipelined=True, splits=bad)
    assert tpa.paged_decode_pipelined_attention.combine_launches == 0


def test_pipelined_forced_partials_are_checked_before_any_launch():
    args, _, _ = _inputs(None, 2, 3)
    rows, w, h, d = args[0].shape
    out = torch.empty_like(args[0])
    for partials in (torch.empty((rows, w, h, 3, d)),             # no m, l
                     torch.empty((rows, w, h, 2, d + 2)),         # 2 != 3
                     torch.empty((rows, w, h, 3, d + 2),
                                 dtype=torch.float64)):
        with pytest.raises(ValueError, match="partials must be"):
            tpa._launch(*args, out, pipelined=True, splits=3,
                        partials=partials)


def test_pipelined_wrapper_refuses_other_devices():
    """No plain-version fallback off the CPU: a tensor on another device
    type raises."""
    args, _, _ = _inputs(None, 1, 1)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no paged-decode kernel"):
        tpa.paged_decode_pipelined_attention(*meta)
