"""The port's CUDA kernels on the card, against their plain versions: the
two paged-decode kernels (over model-dtype and quantized pools), each
one's split-KV walk and its combine kernel, and the three flash-attention
kernels of training; and the serving engine's K-step loop captured as a
CUDA graph through the paged kernels.

These tests need an NVIDIA card and skip elsewhere: a CUDA kernel has no
interpret mode. They import no JAX, so they run where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda

fp32 is held to the accumulation-order pins of the CPU tests (2e-5; 5e-5
for the flash backward). bf16 is held to the plain version run in fp32 on
the same bf16 values: the paged kernel works in fp32 and rounds only its
output, so it stays within a bf16 rounding (2^-8 relative) of that; the
flash kernels also round their weights to bf16 before the tensor-core
products, so they get 2^-8 of the tensor's largest value on top."""

import numpy as np
import pytest
import torch

from tpu_task_torch.ml import train
from tpu_task_torch.ml.models import transformer
from tpu_task_torch.ml.ops import attention as fa
from tpu_task_torch.ml.ops import paged_attention as tpa
from tpu_task_torch.ml.serving import cache as tc
from tpu_task_torch.serve.replica import build_engine

ATOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the paged-decode kernel runs only "
                    "there (no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(rng, device, *, rows=6, w=1, h=8, kv=2, d=128, bs=16,
          max_blocks=12):
    """Fragmented shuffled tables, ragged depths, one inactive row."""
    depths = rng.integers(0, max_blocks * bs - w, size=rows)
    need = [(int(x) + w - 1) // bs + 1 for x in depths[:-1]]
    n_blocks = 1 + sum(need)
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((rows, max_blocks), np.int32)
    pos = np.zeros((rows, w), np.int32)
    used = 0
    for r, n in enumerate(need):              # the last row stays inactive
        tables[r, :n] = perm[used:used + n]
        used += n
        pos[r] = depths[r] + np.arange(w)
    arrays = (rng.normal(size=(rows, w, h, d)),
              rng.normal(size=(n_blocks, bs, kv, d)),
              rng.normal(size=(n_blocks, bs, kv, d)))
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays] + [torch.tensor(tables, device=device),
                                torch.tensor(pos, device=device)]


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [
    dict(h=8, kv=2, d=128, bs=16),            # the flagship
    # the flagship engine's 144-row chunk step, tables of max_len 1152
    dict(h=8, kv=2, d=128, bs=16, rows=144, max_blocks=72),
    dict(h=8, kv=4, d=16, bs=8),              # the tiny preset
    dict(h=4, kv=2, d=8, bs=4),               # the micro preset
    dict(h=8, kv=2, d=32, bs=32)])
@pytest.mark.parametrize("w", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda_device, geometry, w, dtype):
    rng = np.random.default_rng(w + geometry["d"])
    args = _case(rng, cuda_device, w=w, **geometry)
    args[:3] = [a.to(dtype) for a in args[:3]]
    before = tpa.paged_decode_attention.launches
    got = tpa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert tpa.paged_decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == args[0].shape
    exact = tpa.paged_reference_attention(
        *[a.float() for a in args[:3]], *args[3:])
    err = (got.float() - exact).abs()
    if dtype == torch.float32:
        assert err.max().item() <= ATOL
    else:
        assert (err <= 2.0 ** -8 * exact.abs() + 1e-5).all()


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    q, kp, vp, tables, pos = _case(np.random.default_rng(0), cuda_device)
    tpa.reset_launch_counts()
    for kernel in (tpa.paged_decode_attention,
                   tpa.paged_decode_pipelined_attention):
        with pytest.raises(ValueError, match="needs k_scale"):
            kernel(q, kp.to(torch.int8), vp.to(torch.int8), tables, pos)
        with pytest.raises(ValueError, match="share one storage type"):
            kernel(q, kp.to(torch.bfloat16), vp, tables, pos)
        with pytest.raises(ValueError, match="int32"):
            kernel(q, kp, vp, tables.long(), pos)
    # Nothing launched, and nothing fell back to the plain version.
    assert tpa.paged_decode_attention.launches == 0
    assert tpa.paged_decode_pipelined_attention.launches == 0
    assert tpa.paged_reference_attention.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["micro", "tiny"])
def test_engine_runs_the_kernel(cuda_device, preset):
    """``decode_impl="auto"`` picks the kernel on the card; every fused step
    launches it once per layer and never the plain version, and the streams
    equal a forced-plain engine's."""
    rng = np.random.default_rng(1)
    vocab = build_engine(preset, device="cpu").cfg.vocab_size
    prompts = [rng.integers(0, vocab, size=n) for n in (3, 13, 7, 1)]
    outs = {}
    for impl in ("auto", "reference"):
        engine = build_engine(preset, serving={"decode_impl": impl},
                              device=cuda_device)
        tpa.reset_launch_counts()
        for prompt in prompts:
            engine.submit(prompt, 8)
        outs[impl] = engine.drain()
        fused = engine.chunk_steps + engine.decode_steps
        if impl == "auto":
            assert engine.decode_impl == "cuda"
            assert tpa.paged_decode_attention.launches == \
                engine.cfg.n_layers * fused
            assert tpa.paged_reference_attention.launches == 0
    assert outs["auto"] == outs["reference"]


#: (kernel, kv_dtype): the tile kernel's quantized variants and the
#: pipelined kernel over every storage type.
QUANT_KERNELS = [("cuda", "int8"), ("cuda", "fp8"), ("cuda", "int4"),
                 ("pipelined", None), ("pipelined", "int8"),
                 ("pipelined", "fp8"), ("pipelined", "int4")]


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [
    dict(h=8, kv=2, d=128, bs=16),            # the flagship
    dict(h=8, kv=2, d=128, bs=16, rows=144, max_blocks=72),
    dict(h=8, kv=4, d=16, bs=8),              # the tiny preset
    dict(h=4, kv=2, d=8, bs=4)])              # the micro preset
@pytest.mark.parametrize("w", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl,kv_dtype", QUANT_KERNELS)
def test_quantized_kernels_match_plain(cuda_device, impl, kv_dtype, geometry,
                                       w, dtype):
    """Both kernels on the same codes and scales as the plain version run
    in fp32: fp32 within ATOL, bf16 within its output's rounding."""
    rng = np.random.default_rng(w + geometry["d"])
    q, kp, vp, tables, pos = _case(rng, cuda_device, w=w, **geometry)
    q = q.to(dtype)
    scales = ()
    if kv_dtype is None:
        kp, vp = kp.to(dtype), vp.to(dtype)
    else:
        code = tc.kv_code_dtype(kv_dtype)
        (kp, ks), (vp, vs) = (tc.quantize_blocks(a, code) for a in (kp, vp))
        scales = (ks, vs)
    args = (q, kp, vp, tables, pos, *scales)
    tpa.reset_launch_counts()
    got = tpa.paged_attention(*args[:5], *scales, impl=impl)
    torch.cuda.synchronize()
    counted = (tpa.paged_decode_pipelined_attention if impl == "pipelined"
               else tpa.paged_decode_attention)
    assert counted.launches == 1 and tpa.paged_reference_attention.launches \
        == 0
    assert got.dtype == dtype and got.shape == q.shape
    pools = [p.float() if p.dtype == dtype else p for p in (kp, vp)]
    exact = tpa.paged_reference_attention(q.float(), *pools, tables, pos,
                                          *scales)
    err = (got.float() - exact).abs()
    if dtype == torch.float32:
        assert err.max().item() <= ATOL
    else:
        assert (err <= 2.0 ** -8 * exact.abs() + 1e-5).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("preset", ["micro", "tiny"])
def test_quantized_engine_runs_both_kernels(cuda_device, preset, kv_dtype):
    """A quantized engine serves through either kernel, once per layer per
    fused step and never through the plain version, with the streams of a
    forced-plain engine."""
    rng = np.random.default_rng(2)
    vocab = build_engine(preset, device="cpu").cfg.vocab_size
    prompts = [rng.integers(0, vocab, size=n) for n in (3, 13, 7, 1)]
    outs = {}
    for impl in ("cuda", "pipelined", "reference"):
        engine = build_engine(preset, serving={"decode_impl": impl,
                                               "kv_dtype": kv_dtype},
                              device=cuda_device)
        tpa.reset_launch_counts()
        for prompt in prompts:
            engine.submit(prompt, 8)
        outs[impl] = engine.drain()
        fused = engine.chunk_steps + engine.decode_steps
        launches = engine.stats()["attention_launches"]
        want = {name: 0 for name in launches}
        want[impl] = engine.cfg.n_layers * fused
        assert launches == want
    assert outs["cuda"] == outs["pipelined"] == outs["reference"]


#: Every (q type, pool storage) pair the tile kernel takes; None = q's type.
TILE_PAIRS = [(dtype, kv_dtype) for dtype in (torch.float32, torch.bfloat16)
              for kv_dtype in (None, "int8", "fp8", "int4")]


def _close(got, ref, dtype):
    """fp32 within ATOL; bf16 within its output's rounding of ``ref``."""
    err = (got.float() - ref).abs()
    if dtype == torch.float32:
        return err.max().item() <= ATOL
    return bool((err <= 2.0 ** -8 * ref.abs() + 1e-5).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,impl", [
    (None, "cuda"), ("int8", "pipelined"), ("int4", "cuda")])
def test_micro_step_graphs_read_as_k1(cuda_device, kv_dtype, impl):
    """The tiny preset at micro_k 4: every pure-decode step replays a
    captured CUDA graph of the K-step loop (one capture per program used),
    the streams equal the K = 1 engine's, and the launch counts after the
    replays are those of K separate steps, n_layers each, with nothing of
    the warm-up or the capture counted."""
    waves = [(np.arange(1, 30), 9, {"eos_token": 3}),
             (np.arange(5, 14), 6, {"temperature": 0.8, "key": [4, 5]}),
             (np.arange(2, 4), 11, {}), (np.arange(40, 57), 2, {})]
    outs, stats = {}, {}
    for k in (1, 4):
        engine = build_engine("tiny", serving={
            "decode_impl": impl, "kv_dtype": kv_dtype, "micro_k": k},
            device=cuda_device)
        tpa.reset_launch_counts()
        for prompt, max_new, kw in waves:
            engine.submit(prompt, max_new, **kw)
        outs[k] = engine.drain()
        stats[k] = s = engine.stats()
        calls = s["chunk_steps"] + s["decode_steps"] + (k - 1) * s[
            "micro_steps"]
        want = {name: 0 for name in s["attention_launches"]}
        want[impl] = engine.cfg.n_layers * calls
        assert s["attention_launches"] == want
    assert outs[4] == outs[1]
    graphs = stats[4]["step_graph"]
    assert stats[4]["micro_steps"] > 0
    assert graphs["replays"] == stats[4]["micro_steps"]
    assert graphs["captures"] in (1, 2)
    assert stats[1]["step_graph"]["captures"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [
    dict(h=8, kv=2, d=128, bs=16),            # the flagship
    dict(h=8, kv=2, d=128, bs=16, rows=144, max_blocks=72),
    dict(h=8, kv=4, d=16, bs=8),              # the tiny preset
    dict(h=4, kv=2, d=8, bs=4),               # the micro preset
    dict(h=8, kv=2, d=32, bs=32)])
@pytest.mark.parametrize("w", [1, 3])
@pytest.mark.parametrize("dtype,kv_dtype", TILE_PAIRS)
@pytest.mark.parametrize("splits", [1, 2, "plan", "tiles"])
def test_split_kernel_matches_plain(cuda_device, geometry, w, dtype,
                                    kv_dtype, splits):
    """The tile kernel with its walk cut into forced splits (1, 2, the plan,
    one per tile), launched uncounted into a NaN-filled output with
    NaN-filled partial states: the merged output against the merge of the
    plain split states and against the plain version, both in fp32 on the
    same values; no NaN left behind; the combine kernel alone on the plain
    states against ``combine_partials``. Tables without a given width get
    three whole tiles and a ragged fourth."""
    _check_forced_splits(cuda_device, geometry, w, dtype, kv_dtype, splits,
                         pipelined=False)


def _check_forced_splits(cuda_device, geometry, w, dtype, kv_dtype, splits,
                         *, pipelined):
    geometry = dict(geometry)
    bs = geometry["bs"]
    geometry.setdefault("max_blocks", 3 * tpa.tile_blocks_for(bs) + 2)
    rng = np.random.default_rng(w + geometry["d"])
    q, kp, vp, tables, pos = _case(rng, cuda_device, w=w, **geometry)
    q = q.to(dtype)
    scales = ()
    if kv_dtype is None:
        kp, vp = kp.to(dtype), vp.to(dtype)
    else:
        code = tc.kv_code_dtype(kv_dtype)
        (kp, ks), (vp, vs) = (tc.quantize_blocks(a, code) for a in (kp, vp))
        scales = (ks, vs)
    args = (q, kp, vp, tables, pos, *scales)
    max_blocks = tables.shape[1]
    tiles = tpa.n_tiles(max_blocks, bs)
    n = {"plan": tpa.planned_splits(q, kp, max_blocks, pipelined=pipelined),
         "tiles": tiles}.get(splits, splits)
    rows, _, h, d = q.shape
    before = [a.clone() for a in args]
    out = torch.full_like(q, float("nan"))
    partials = (torch.full((rows, w, h, n, 2 + d), float("nan"),
                           device=cuda_device) if n > 1 else None)
    tpa.reset_launch_counts()
    assert tpa._launch(*args[:5], out, *scales, pipelined=pipelined,
                       splits=n, partials=partials) == n
    torch.cuda.synchronize()
    wrapper, other = (tpa.paged_decode_pipelined_attention,
                      tpa.paged_decode_attention)
    if not pipelined:
        wrapper, other = other, wrapper
    assert wrapper.launches == other.launches == 0
    assert wrapper.combine_launches == int(n > 1)
    assert other.combine_launches == 0
    assert tpa.paged_reference_attention.launches == 0
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(before, args))
    assert not torch.isnan(out).any()
    plain = tpa.paged_split_partials(*args, splits=n)
    assert _close(out, tpa.combine_partials(plain), dtype)
    pools = [p.float() if p.dtype == dtype else p for p in (kp, vp)]
    exact = tpa.paged_reference_attention(q.float(), *pools, tables, pos,
                                          *scales)
    assert _close(out, exact, dtype)
    if n > 1:
        assert not torch.isnan(partials).any()
        assert _states_close(partials, plain)
        alone = torch.empty_like(q)
        tpa._launch_combine(plain, alone, pipelined=pipelined)
        torch.cuda.synchronize()
        assert _close(alone, tpa.combine_partials(plain), dtype)


def _states_close(got, ref):
    """Split states against the plain ones: the same splits empty (exactly
    the empty state), m within ATOL of max(1, |m|), l and acc within ATOL of
    l, the scale of the output they divide into."""
    empty = ref[..., 0] <= tpa.NEG_INF / 2
    if not torch.equal(empty, got[..., 0] <= tpa.NEG_INF / 2) \
            or (got[..., 1:][empty] != 0).any():
        return False
    live = ~empty
    l = ref[..., 1]
    return bool(
        ((got[..., 0] - ref[..., 0]).abs()
         <= ATOL * ref[..., 0].abs().clamp(min=1.0))[live].all()
        and ((got[..., 1] - l).abs() <= ATOL * l)[live].all()
        and ((got[..., 2:] - ref[..., 2:]).abs()
             <= ATOL * l[..., None])[live].all())


#: Every (q type, pool storage) pair the pipelined kernel takes.
PIPELINED_PAIRS = TILE_PAIRS


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [
    dict(h=8, kv=2, d=128, bs=16),            # the flagship
    dict(h=8, kv=2, d=128, bs=16, rows=144, max_blocks=72),
    dict(h=8, kv=4, d=16, bs=8),              # the tiny preset
    dict(h=4, kv=2, d=8, bs=4),               # the micro preset
    dict(h=8, kv=2, d=32, bs=32)])
@pytest.mark.parametrize("w", [1, 3])
@pytest.mark.parametrize("dtype,kv_dtype", PIPELINED_PAIRS)
@pytest.mark.parametrize("splits", [1, 2, "plan", "tiles"])
def test_pipelined_split_kernel_matches_plain(cuda_device, geometry, w, dtype,
                                              kv_dtype, splits):
    """The pipelined kernel at forced splits (1, 2, its plan, one per
    stage), on its tensor-core path (bf16 queries at d 128, 32 and 16) and
    its scalar one (fp32 queries, d 8): the gates of the tile kernel's
    test, the split states against ``paged_split_partials`` and the inputs
    unchanged."""
    _check_forced_splits(cuda_device, geometry, w, dtype, kv_dtype, splits,
                         pipelined=True)


@pytest.mark.cuda
def test_pipelined_kernel_takes_the_tensor_cores_where_it_should(
        cuda_device):
    """bf16 queries at d a multiple of 16 up to 128 and at most 16 query
    rows a CTA take the tensor-core path; fp32 queries, d 8, d 256 and 20
    query rows the scalar one."""
    def uses(dtype, w, h, kv, d):
        q = torch.empty((1, w, h, d), dtype=dtype, device=cuda_device)
        pool = torch.empty((2, 16, kv, d), dtype=torch.int8,
                           device=cuda_device)
        return tpa.pipelined_uses_tensor_cores(q, pool)

    assert uses(torch.bfloat16, 1, 8, 2, 128)
    assert uses(torch.bfloat16, 3, 8, 2, 128)         # 12 rows
    assert uses(torch.bfloat16, 1, 8, 4, 16)
    assert uses(torch.bfloat16, 4, 8, 2, 64)          # 16 rows
    assert not uses(torch.float32, 1, 8, 2, 128)
    assert not uses(torch.bfloat16, 1, 4, 2, 8)
    assert not uses(torch.bfloat16, 1, 8, 2, 256)
    assert not uses(torch.bfloat16, 5, 8, 2, 128)     # 20 rows


@pytest.mark.cuda
def test_pipelined_wrapper_counts_its_combine_launches(cuda_device):
    """The pipelined wrapper splits where its own plan says so, and counts
    one call and one combine; a grid that already fills the card takes one
    split and no combine."""
    rng = np.random.default_rng(4)
    for rows in (2, 600):
        q, kp, vp, tables, pos = _case(rng, cuda_device, rows=rows,
                                       max_blocks=20)
        (kp, ks), (vp, vs) = (tc.quantize_blocks(a, torch.int8)
                              for a in (kp, vp))
        q = q.to(torch.bfloat16)
        tpa.reset_launch_counts()
        got = tpa.paged_decode_pipelined_attention(q, kp, vp, tables, pos,
                                                   ks, vs)
        torch.cuda.synchronize()
        split = tpa.planned_splits(q, kp, 20, pipelined=True) > 1
        assert tpa.paged_decode_pipelined_attention.launches == 1
        assert tpa.paged_decode_pipelined_attention.combine_launches == \
            int(split)
        assert tpa.paged_decode_attention.combine_launches == 0
        assert split == (rows == 2)
        exact = tpa.paged_reference_attention(q.float(), kp, vp, tables, pos,
                                              ks, vs)
        assert _close(got, exact, torch.bfloat16)


@pytest.mark.cuda
def test_wrapper_counts_its_combine_launches(cuda_device):
    """A call whose plan splits the walk counts one call and one combine;
    a grid that already fills the card takes one split and no combine."""
    rng = np.random.default_rng(3)
    for rows in (2, 300):
        args = _case(rng, cuda_device, rows=rows, max_blocks=20)
        tpa.reset_launch_counts()
        tpa.paged_decode_attention(*args)
        torch.cuda.synchronize()
        split = tpa.planned_splits(args[0], args[1], 20) > 1
        assert tpa.paged_decode_attention.launches == 1
        assert tpa.paged_decode_attention.combine_launches == int(split)
        assert split == (rows == 2)


def _flash_inputs(device, dtype, b, h, sq, sk, d, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dtype).to(device)
            for shape in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d),
                          (b, sq, h, d))]


def _flash_close(got, exact, atol):
    """bf16 also allows 2^-8 of the tensor's largest value: the kernels
    round p and ds to bf16 before their tensor-core products, as the TPU
    kernels do."""
    err = (got.float() - exact).abs()
    if got.dtype == torch.float32:
        assert err.max().item() <= atol
    else:
        scale = exact.abs()
        assert (err <= 2.0 ** -8 * (scale + scale.max()) + atol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,sk,d,causal,q_offset", [
    (2, 4, 128, 128, 64, True, None),         # self-attention
    (1, 2, 128, 512, 128, True, None),        # sq < sk
    (2, 2, 128, 256, 64, True, 0),            # ring's off-diagonal offset
    (2, 2, 256, 256, 128, True, -96),         # rows that see no key
    (1, 2, 200, 328, 40, False, None),        # ragged tiles, d 40
    (1, 2, 64, 64, 8, True, None),            # the smallest head dim
    # the wgmma forward's 128-row tile edges
    (2, 2, 1, 1, 128, True, None),            # sq 1
    (1, 2, 1, 300, 64, True, None),           # sq 1 against a long sk
    (2, 2, 127, 127, 128, True, None),        # one short tile
    (1, 2, 129, 129, 128, True, None),        # one row into a second tile
    (1, 2, 257, 300, 128, True, None),        # ragged q and kv tiles
    (1, 2, 257, 129, 128, True, None),        # sk < sq: 128 rows see nothing
    (1, 2, 300, 200, 64, False, None),        # sk < sq, not causal
    (2, 2, 256, 256, 128, True, -130),        # a whole q tile sees nothing
    (1, 4, 384, 384, 64, True, None),         # d 64 over three tiles
    # the wgmma backward's 64-row q stage edges
    (2, 2, 65, 65, 128, True, None),          # one row into a second stage
    (1, 2, 193, 193, 128, True, None),        # ragged stage and kv tile
    (1, 4, 193, 300, 64, True, None),         # the same at d 64, sk > sq
    (2, 2, 256, 256, 128, True, -64),         # a whole stage sees nothing
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(cuda_device, b, h, sq, sk, d, causal,
                                   q_offset, dtype):
    q, k, v, do = _flash_inputs(cuda_device, dtype, b, h, sq, sk, d)
    fa.reset_launch_counts()
    o, lse = fa.flash_attention(q, k, v, causal, q_offset=q_offset,
                                return_lse=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, q_offset=q_offset)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal,
                              q_offset=q_offset)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == (1, 1, 1)
    assert fa.flash_attention_reference.launches == 0
    wide = [t.float() for t in (q, k, v, do)]
    ex_o, ex_lse = fa.flash_attention_reference(*wide[:3], causal, q_offset)
    exact = fa.flash_bwd_reference(*wide, lse, delta, causal, q_offset)
    _flash_close(o, ex_o, 2e-5)
    assert (lse - ex_lse).abs().max().item() <= 2e-5
    for got, ref in zip((dq, dk, dv), exact):
        _flash_close(got, ref, 5e-5)
    off = sk - sq if q_offset is None else q_offset
    if causal and off < 0:
        assert (o[:, :-off] == 0).all()
        assert (lse[:, :, :-off] == fa.NEG_INF).all()


@pytest.mark.cuda
def test_flash_forward_occupancy_and_shared_memory(cuda_device):
    """The wgmma forward holds one 384-thread CTA an SM at both head dims,
    with Q and a 2-stage (d 128) or 3-stage (d 64) ring of 128-row K and V
    tiles in shared memory, from a 1024-byte boundary."""
    tile = {128: 32768, 64: 16384}
    for d, stages in ((128, 2), (64, 3)):
        assert fa.wgmma_ctas_per_sm("fwd", d) == 1
        assert fa.wgmma_smem_bytes("fwd", d) == \
            tile[d] * (1 + 2 * stages) + 8 * (1 + 3 * stages) + 1024


@pytest.mark.cuda
def test_flash_backward_occupancy_and_shared_memory(cuda_device):
    """The wgmma backward kernels hold one 384-thread CTA an SM at both
    head dims: dq with Q, dO and a 2-stage (d 128) or 3-stage (d 64) ring
    of 128-row K and V tiles; dk/dv with K, V and a 3-stage ring of 64-row
    Q and dO tiles and their 64 lse and delta values; each from a
    1024-byte boundary."""
    tile = {128: 32768, 64: 16384}
    for d, stages in ((128, 2), (64, 3)):
        assert fa.wgmma_ctas_per_sm("dq", d) == 1
        assert fa.wgmma_smem_bytes("dq", d) == \
            tile[d] * (2 + 2 * stages) + 8 * (1 + 3 * stages) + 1024
        assert fa.wgmma_ctas_per_sm("dkv", d) == 1
        assert fa.wgmma_smem_bytes("dkv", d) == \
            2 * tile[d] + 3 * (tile[d] + 512) + 8 * (1 + 2 * 3) + 1024


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_do_not_take(cuda_device):
    q, k, v, _ = _flash_inputs(cuda_device, torch.float32, 1, 2, 64, 64, 64)
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fa.flash_attention(q.half(), k.half(), v.half(), True)
    wide = torch.zeros((1, 64, 1, 136), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(wide, wide, wide, True)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), True)
    # Nothing launched, and nothing fell back to the plain version.
    assert fa.flash_attention.launches == 0
    assert fa.flash_attention_reference.launches == 0


@pytest.mark.cuda
def test_train_step_runs_the_kernels(cuda_device):
    """Every layer's attention goes through the three kernels, never the
    plain versions, and three steps on the card equal three on the CPU
    (the plain versions) within the CPU tests' 2e-5."""
    cfg = transformer.TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_head=16,
        d_ff=128, n_kv_heads=2, dtype=torch.float32)
    tokens = torch.randint(0, 256, (2, 129),
                           generator=torch.Generator().manual_seed(0))
    out = {}
    for device in ("cpu", cuda_device):
        state = train.init_state(torch.Generator().manual_seed(1), cfg,
                                 device=device)
        step = train.make_train_step(cfg)
        fa.reset_launch_counts()
        for _ in range(3):
            state, m = step(state, tokens.to(device))
        out[str(device)] = [p.detach().cpu()
                            for p in train._leaves(state.params)]
        if device != "cpu":
            assert (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
                    fa.flash_bwd_dkv.launches) == (6, 6, 6)
            assert fa.flash_attention_reference.launches == 0
            assert fa.flash_bwd_reference.launches == 0
            assert fa.mha_reference.launches == 0
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        assert (a - b).abs().max().item() <= 2e-5


class _PlainFlash(torch.autograd.Function):
    """FlashAttention's wiring over the plain versions, on the card."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = fa.flash_attention_reference(q, k, v, True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        return fa.flash_bwd_reference(q, k, v, do, lse, delta, True)


@pytest.mark.cuda
def test_bf16_train_step_runs_the_tensor_core_kernels(cuda_device):
    """bf16 at d 128 takes the tensor-core kernels, through GQA expansion
    and the autograd Function: three steps on the card equal three through
    the plain versions on the card in loss and grad norm within 2^-10
    relative (the kernels round p and ds to bf16 where the plain versions
    keep fp32)."""
    cfg = transformer.TransformerConfig(
        vocab_size=512, d_model=256, n_layers=2, n_heads=2, d_head=128,
        d_ff=512, n_kv_heads=1, dtype=torch.bfloat16)
    tokens = torch.randint(0, 512, (2, 257),
                           generator=torch.Generator().manual_seed(0))

    def plain_attn(q, k, v):
        return _PlainFlash.apply(q, transformer.expand_kv(k, cfg.n_heads),
                                 transformer.expand_kv(v, cfg.n_heads))

    metrics = {}
    for path, attn_fn in (("kernels", None), ("plain", plain_attn)):
        state = train.init_state(torch.Generator().manual_seed(1), cfg,
                                 device=cuda_device)
        step = train.make_train_step(cfg, attn_fn=attn_fn)
        fa.reset_launch_counts()
        metrics[path] = []
        for _ in range(3):
            state, m = step(state, tokens.to(cuda_device))
            metrics[path] += [m["loss"].item(), m["grad_norm"].item()]
        if path == "kernels":
            assert (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
                    fa.flash_bwd_dkv.launches) == (6, 6, 6)
            assert fa.flash_attention_reference.launches == 0
            assert fa.flash_bwd_reference.launches == 0
            assert fa.mha_reference.launches == 0
    for a, b in zip(metrics["kernels"], metrics["plain"]):
        assert abs(a - b) <= 2.0 ** -10 * abs(b)
