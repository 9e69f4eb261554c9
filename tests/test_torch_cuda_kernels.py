"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card and skip elsewhere: a CUDA kernel has no
interpret mode. They import no JAX, so they run where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda

fp32 is held to the 2e-5 accumulation-order pin of the CPU tests. bf16 is
held to the plain version run in fp32 on the same bf16 values: the kernel
works in fp32 and rounds only its output, so it stays within half a bf16
ulp (2^-8 relative) of that."""

import numpy as np
import pytest
import torch

from tpu_task_torch.ml.ops import paged_attention as tpa
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpa.paged_decode_attention(q, kp.to(torch.int8), vp.to(torch.int8),
                                   tables, pos)
    with pytest.raises(ValueError, match="one type"):
        tpa.paged_decode_attention(q, kp.to(torch.bfloat16), vp, tables, pos)
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_decode_attention(q, kp, vp, tables.long(), pos)


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
