#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_task_torch``) on one NVIDIA
card: builds the port's CUDA kernels from this checkout, holds each against
its plain PyTorch version, times it, drives the paged serving engine at the
flagship model's full width (model-dtype and quantized KV pools), and
trains the flagship for a few steps.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the
script exits non-zero:

1. device  — the card's name and power limit; TF32 off for the fp32 phases.
2. build   — nvcc for every kernel source, all started together, with
             ptxas's report; then the registers, spills, dynamic shared
             memory and CTAs per SM at d 64 and 128 of the flash forward
             (B1 v3) and of the backward's dq and dk/dv kernels (B2, B3
             v3), all wgmma fed by TMA rings, failing on a spill.
3. kernel  — the paged-decode kernel against its plain version at the
             flagship geometry (kv 2, group 4, d 128, block 16): fragmented
             shuffled tables, ragged depths, inactive rows, fp32 and bf16;
             24 rows of widths 1 and 3 up to depth 2048, and the serve
             run's 16-row decode and 144-row chunk steps (tables 72 wide).
             Each case also launches into a NaN-guarded buffer to show the
             kernel writes its output and nothing beside it. Each case is
             then run at forced split counts of the KV walk (1, 2, the
             plan, one per tile) with NaN-filled split states: the output
             against the merge of the plain split states and the plain
             version, the split states against ``paged_split_partials``,
             the combine kernel alone against ``combine_partials``, inputs
             unchanged.
4. timing  — kernel, plain version and SDPA over the gathered view
             (``library_ms``, a yardstick the port never calls) at batch 1,
             16 and 32, depth 1024, and at the serve run's 144-row chunk
             step (ragged depths up to 1151, SDPA masked), beside the
             memory bound, with the split plan and CTAs of each and the
             kernel's time with its walk left whole (``unsplit_ms``, one
             split); the kernel is held against the plain version there
             too. Then, at batch
             16, wrapper calls under ``torch.profiler`` (one split walk and
             one combine each: their device ms and the span between), and
             the combine kernel alone at that shape's split states.
5. parity  — the engine on the ``tiny`` and ``micro`` presets at fp32:
             greedy and keyed-sampled streams through the kernel equal those
             through the plain version, and greedy ones equal ``generate``;
             prefix cache, chunked prefill and a pool small enough to force
             preemption.
6. serve   — the flagship (vocab 32768, d_model 1024, 8 layers, 8 heads of
             128, 2 kv heads, d_ff 4096, bf16, random weights from a torch
             Generator): after a short warm-up wave, three timed waves of 16
             requests of 256-1024 prompt tokens and 64 new tokens each, 12
             greedy and 4 sampled: tokens/s (each wave and the median), step
             times, and launch counts that prove the fused steps ran the
             kernel (and the combine kernel wherever the plan splits the
             step's shape). Layer 0's attention in the first decode step
             and the
             last chunk step of the first wave is held against the plain
             version on the same inputs.
7. flash kernel — the forward, dq and dk/dv kernels against their plain
             versions: fp32 (2e-5 forward, 5e-5 backward) and bf16 (against
             the plain version in fp32 on the same bf16 values, within
             2^-8 of each element and of the tensor's largest), the flagship
             train shape (b 8, s 1024, h 8, d 128, causal), causal and not,
             sq = sk, sq < sk, q_offset 0 with sq != sk, a negative
             q_offset with rows that see no key, a ragged length, d 64 and
             128, lengths 128 to 2048, the forward's 128-row tile edges
             (sq 1, 127, 129, 257, sk < sq, q_offset -130, d 64 at sq
             384) and the backward's 64-row q stage edges (sq 65 and 193,
             q_offset -64). Each case also launches every kernel into
             NaN-guarded buffers.
8. flash timing — each kernel at the flagship train shape (bf16, held
             against its plain version in phase 7): kernel, plain and bound
             ms, SDPA's forward and backward (``library_ms``, a yardstick
             the port never calls) and the plain-torch delta before the
             backward; then the forward and SDPA's forward, and the
             backward pair and SDPA's backward, at six shapes, with a fit
             of each wgmma kernel's ms as a fixed cost per CTA plus a cost
             per tile step.
9. train parity — small GQA configs with a 256-token sequence, fp32 at d 32
             (the fp32-core kernels) and bf16 at d 128 (the tensor-core
             kernels): three ``make_train_step`` steps through the kernels
             and through the plain versions, from the same weights and
             tokens.
10. train  — the flagship train step (vocab 32768, d_model 1024, 8 layers,
             8 heads of 128, MHA, d_ff 4096, bf16 over fp32 master weights,
             batch 8 x 1024 tokens, random weights from a torch Generator):
             two warm-up steps, the first recorded so that layer 0's
             forward and the last layer's backward are held against the
             plain versions in fp32, then ten timed steps on one batch:
             step ms, tokens/s, MFU, peak memory, one profiled step, and
             launch counts that prove every layer ran the three kernels.

11. kernel quant — both paged kernels (``paged_decode.cu``'s int8, fp8 and
             int4 variants; ``paged_decode_pipelined.cu`` over all five
             storage types, on its tensor-core path for bf16 queries at d
             128 and 16 and its scalar path otherwise) against the plain
             version in fp32 on the same codes: the flagship geometry (kv
             2, group 4, d 128, block 16), d 16 at block 8 and d 8 at block
             4, widths 1 and 3, 24 rows of ragged depths up to 2048 with
             inactive rows, and the serve run's 16-row decode and 144-row
             chunk steps; fp32 and bf16 queries, phase 3's gates and forced
             splits (each kernel at its own plan), NaN-guarded, inputs
             unchanged.
12. timing quant — both kernels, the plain version and SDPA over the view
             dequantized to bf16 ahead of time (``library_ms``; the
             dequantization is not timed) for each storage type at batch
             1, 16 and 32, depth 1024, and at the 144-row chunk step,
             beside the bytes bound and each kernel's split plan, CTAs and
             ``unsplit_ms``; then the pipelined kernel's int8 batch-16
             calls under ``torch.profiler`` (split walk and combine).
13. parity quant — the engine on ``tiny``, ``micro`` and the INT8_PIN
             geometry of ``tests/test_paged_attention.py`` at fp32, for
             each kv_dtype: greedy and keyed-sampled streams through
             ``"cuda"``, ``"pipelined"`` and ``"reference"`` are equal, with
             the prefix cache, copy-on-write and a pool small enough to
             force preemption.
14. serve quant — the flagship at the serve phase's configuration with
             ``kv_dtype="int8", decode_impl="pipelined"``: a warm-up wave and
             three timed waves of phase 6's traffic (launches must be
             n_layers per fused step through the pipelined kernel, its
             combine after every call the plan splits, 0 through the tile
             kernel and the plain version; layer 0's attention in
             the first decode and last chunk step held against the plain
             version), then one shorter wave each of fp8 and int4 through
             the pipelined kernel and of int8 through the tile kernel, under
             the same gates.
15. serve micro — the flagship with bf16 pools through the tile kernel
             at ``micro_k`` 1, 4 and 8 (the K-step loop a CUDA graph at K >
             1), each engine after phase 6's warm-up: three timed waves of
             phase 6's traffic each, with tokens/s, mean chunk-step and
             decode- or micro-step ms, micro-steps, graph captures and
             capture ms, host_gap_frac, dispatches per token and peak
             memory. Every request's stream at K = 4 and 8 must equal K =
             1's token for token, greedy and sampled; launches must be
             n_layers per chunk step and n_layers x K per micro-step (a
             retired slot's iterations run masked), the combine kernel's
             likewise where the plan splits, 0 through the other kernel
             and the plain version.
16. serve trace — one more wave at K = 1 and at K = 8 under
             ``torch.profiler`` (CPU and CUDA): per chunk step and per
             decode or micro-step the mean wall, device-busy ms and idle
             share, the ten device ops with the most time and the ten host
             ops with the most self time; the paged kernels' launches
             counted by name in the trace must equal the counters.
17. serve micro quant — int8 pools through the pipelined kernel at K = 8,
             one wave against a K = 1 engine of the same configuration,
             under phase 15's gates.

Then the kernel table as one JSON line (the five ported kernels and the
split walk's combine kernel; the three flash rows name their version, v3,
their kernel and its registers; the paged rows and the combine's add
their launches in phases 15 and 17 at each K),
the ``nvidia-smi`` name and power limit, and
last ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout of the repository, it exits non-zero before any result."""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense bf16 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

FLAGSHIP = dict(vocab_size=32768, d_model=1024, n_layers=8, n_heads=8,
                d_head=128, d_ff=4096, n_kv_heads=2)
FP32_ATOL = 2e-5

#: The repository's training flagship (``bench.py``'s ``bench_train_mfu``):
#: MHA, trained at batch 8 on 1025-token rows (a 1024-token sequence).
TRAIN_FLAGSHIP = dict(vocab_size=32768, d_model=1024, n_layers=8, n_heads=8,
                      d_head=128, d_ff=4096)
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
FLASH_FWD_ATOL, FLASH_BWD_ATOL = 2e-5, 5e-5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def import_port():
    """The port from THIS checkout: a copy installed elsewhere must not
    stand in for it."""
    sys.path.insert(0, str(HERE))
    import tpu_task_torch

    where = Path(tpu_task_torch.__file__).resolve().parent.parent
    if where != HERE:
        raise RuntimeError(
            f"tpu_task_torch imported from {where}, not from this checkout "
            f"({HERE})")


# -- paged-attention inputs and timing ----------------------------------------

def paged_case(gen, depths, *, w=1, h=8, kv=2, d=128, bs=16, max_blocks,
               dtype, device):
    """q, pools, tables, positions for rows at the given depths (None = an
    inactive row: position 0, every table entry the scratch block 0).
    Physical blocks are handed out in a shuffled order, so every row's
    table is fragmented."""
    need = [0 if x is None else (x + w - 1) // bs + 1 for x in depths]
    n_blocks = 1 + sum(need)
    perm = (torch.randperm(n_blocks - 1, generator=gen) + 1).to(torch.int32)
    tables = torch.zeros((len(depths), max_blocks), dtype=torch.int32)
    positions = torch.zeros((len(depths), w), dtype=torch.int32)
    used = 0
    for r, (depth, n) in enumerate(zip(depths, need)):
        if depth is None:
            continue
        tables[r, :n] = perm[used:used + n]
        used += n
        positions[r] = depth + torch.arange(w, dtype=torch.int32)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dtype)

    tensors = (randn(len(depths), w, h, d), randn(n_blocks, bs, kv, d),
               randn(n_blocks, bs, kv, d), tables, positions)
    return [t.to(device) for t in tensors]


class DeviceTimer:
    """Device time of one call, in ms: each timed launch follows a write of
    a 256 MB buffer (the 50 MB L2 starts cold, as it does for a layer's
    pool in serving), and a spin kernel holds the card while the host
    enqueues, so host overhead stays out of the events."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device=device)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(50_000_000)
        for start, end in pairs:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def device_events(prof) -> list:
    """(name, start µs, end µs) of each device event a ``torch.profiler``
    run recorded."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def host_ms(fn, iters: int = 20) -> float:
    """Wall time per call of back-to-back calls, host overhead included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


# -- phases -------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this smoke run "
                         "needs an NVIDIA card")
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         tf32="off: torch.backends.cuda.matmul.allow_tf32 and "
              "torch.backends.cudnn.allow_tf32 are False, so fp32 products "
              "run in full fp32")
    return smi


def ptxas_report(output: str) -> dict:
    """ptxas's ``-v`` report as {kernel: "registers; stack and spills"},
    the kernel's mangled name cut to its name and template arguments."""
    report, name = {}, None
    for line in output.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[-1].strip()
            name = re.sub(r"^_ZN\d+_GLOBAL__N_.*?_cu_[0-9a-f]{8}\d+", "",
                          name)
            name = name[:name.find("EEv") + 2] if "EEv" in name else name
            report[name] = ""
        elif name and "stack frame" in line:
            report[name] = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            report[name] = f"{regs.group(1) if regs else '?'} registers; " \
                           f"{report[name]}"
            name = None
    return report


def phase_build() -> None:
    from tpu_task_torch.ml.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SIGNATURES)) as pool:
        list(pool.map(_build.load, _build.SIGNATURES))
    report = {name: ptxas_report(output)
              for name, output in _build.compiler_output.items()}
    emit("build", seconds=time.perf_counter() - t0,
         libraries=sorted(_build.SIGNATURES), ptxas=report)


def wgmma_build(name: str) -> dict:
    """{d: row} for each instantiation of the wgmma flash kernel ``name``
    ("flash_fwd", "flash_bwd_dq" or "flash_bwd_dkv") in the library's
    ptxas report: registers, stack and spill bytes, its dynamic shared
    memory and the CTAs that fit one SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    from tpu_task_torch.ml.ops import _build
    from tpu_task_torch.ml.ops import attention as fa

    kernel = name.rsplit("_", 1)[-1]             # fwd, dq or dkv
    output = _build.compiler_output.get("flash_attention", "")
    rows = {}
    for found_name, text in ptxas_report(output).items():
        found = re.search(name + r"_wgmma_kernelILi(\d+)E", found_name)
        if not found:
            continue
        d = int(found.group(1))
        row = {}
        for key, pattern in (("registers", r"(\d+) registers"),
                             ("stack_bytes", r"(\d+) bytes stack frame"),
                             ("spill_store_bytes", r"(\d+) bytes spill st"),
                             ("spill_load_bytes", r"(\d+) bytes spill lo")):
            value = re.search(pattern, text)
            row[key] = int(value.group(1)) if value else None
        row.update(smem_bytes=fa.wgmma_smem_bytes(kernel, d),
                   ctas_per_sm=fa.wgmma_ctas_per_sm(kernel, d))
        rows[d] = row
    return rows


def build_ok(rows: dict) -> bool:
    """Both head dims built, no spill, at least one CTA an SM."""
    return sorted(rows) == [64, 128] and all(
        row["spill_store_bytes"] == 0 and row["spill_load_bytes"] == 0
        and row["ctas_per_sm"] >= 1 for row in rows.values())


def ptxas_warnings() -> list:
    from tpu_task_torch.ml.ops import _build

    return [line.strip() for line in
            _build.compiler_output.get("flash_attention", "").splitlines()
            if "warning" in line.lower()]


def phase_flash_fwd_build() -> dict:
    """The wgmma forward's instantiations (d 64 and 128) by
    ``wgmma_build``, with every ptxas warning of the library. Fails on a
    spill or on an instantiation that fits no SM."""
    kernels = wgmma_build("flash_fwd")
    ok = build_ok(kernels)
    emit("flash_fwd_build", ok=ok, kernel="flash_fwd_wgmma_kernel (B1 v3)",
         threads=384, registers_note="ptxas's count is the launch's; "
         "setmaxnreg then gives the producer warpgroup 40 and the two "
         "consumers 232", by_head_dim={str(d): kernels[d]
                                       for d in sorted(kernels)},
         ptxas_warnings=ptxas_warnings())
    if not ok:
        raise AssertionError(f"the wgmma forward's build failed its gates: "
                             f"{kernels}")
    return kernels


def phase_flash_bwd_build() -> dict:
    """The same for the wgmma backward's four instantiations (dq and dk/dv
    at d 64 and 128); returns {"flash_bwd_dq": rows, "flash_bwd_dkv":
    rows}. Fails on a spill or on an instantiation that fits no SM."""
    kernels = {name: wgmma_build(name)
               for name in ("flash_bwd_dq", "flash_bwd_dkv")}
    ok = all(build_ok(rows) for rows in kernels.values())
    emit("flash_bwd_build", ok=ok,
         kernels="flash_bwd_dq_wgmma_kernel (B2 v3), "
                 "flash_bwd_dkv_wgmma_kernel (B3 v3)",
         threads=384, registers_note="ptxas's count is the launch's; "
         "setmaxnreg then gives the producer warpgroup 24 and the two "
         "consumers 240",
         by_kernel={name: {str(d): rows[d] for d in sorted(rows)}
                    for name, rows in kernels.items()},
         ptxas_warnings=ptxas_warnings())
    if not ok:
        raise AssertionError(f"the wgmma backward's build failed its "
                             f"gates: {kernels}")
    return kernels


def against_fp32_plain(got, args) -> dict:
    """Hold a bf16 kernel output to the plain version run in fp32 on the
    same bf16 values. The kernel works in fp32 and rounds only its output
    to bf16, so each element must lie within half an ulp (2^-8 relative)
    of that, plus 1e-5 for fp32 summation order."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    q = args[0]
    pools = [p.float() if p.dtype == q.dtype else p for p in args[1:3]]
    exact = pa.paged_reference_attention(q.float(), *pools, *args[3:])
    err = (got.float() - exact).abs()
    excess = (err - 2.0 ** -8 * exact.abs() - 1e-5).max().item()
    return dict(ok=excess <= 0, max_abs_err_vs_fp32=err.max().item(),
                tolerance_vs_fp32="2^-8*|ref| + 1e-5: the output's bf16 "
                                  "rounding")


def guarded_launch(args, want, pipelined: bool = False) -> bool:
    """Launch a paged kernel (uncounted) into the middle of a NaN-filled
    buffer: True if it wrote exactly ``want`` there and nothing on either
    side. ``args`` are the wrapper's, scales last when given."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    q, n, pad = args[0], args[0].numel(), 1 << 18
    buf = torch.full((n + 2 * pad,), float("nan"), dtype=q.dtype,
                     device=q.device)
    out = buf[pad:pad + n].view(q.shape)
    pa._launch(*args[:5], out, *args[5:], pipelined=pipelined)
    torch.cuda.synchronize()
    return bool(torch.isnan(buf[:pad]).all() and torch.isnan(buf[-pad:]).all()
                and torch.equal(out, want))


def close_to(got, ref, dtype) -> bool:
    """fp32 within FP32_ATOL of ``ref``; bf16 within its output's rounding
    (2^-8 relative) of ``ref`` plus 1e-5 for fp32 summation order."""
    err = (got.float() - ref).abs()
    if dtype == torch.float32:
        return err.max().item() <= FP32_ATOL
    return bool((err <= 2.0 ** -8 * ref.abs() + 1e-5).all())


def forced_splits(args, pipelined: bool = False) -> list:
    """The split counts a paged kernel is held at: 1, 2, its plan for these
    shapes on this card, and one per tile (stage)."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    q, k_pool, tables = args[0], args[1], args[3]
    tiles = pa.n_tiles(tables.shape[1], k_pool.shape[1])
    plan = pa.planned_splits(q, k_pool, tables.shape[1], pipelined=pipelined)
    return sorted({1, min(2, tiles), plan, tiles})


def partial_state_err(got, ref) -> float:
    """How far the kernel's split states are from the plain ones: m
    relative to max(1, |m|), l relative to l, acc relative to l (the scale
    of the output it divides into). Infinite where a state is empty in one
    and not exactly the empty state (m the mask value, l and acc 0) in the
    other."""
    from tpu_task_torch.ml.ops.attention import NEG_INF

    m, l, acc = ref[..., 0], ref[..., 1], ref[..., 2:]
    empty = m <= NEG_INF / 2
    if not torch.equal(empty, got[..., 0] <= NEG_INF / 2) \
            or (got[..., 1:][empty] != 0).any():
        return math.inf
    live = ~empty
    if not live.any():
        return 0.0
    dm = ((got[..., 0] - m).abs() / m.abs().clamp(min=1.0))[live].max()
    dl = ((got[..., 1] - l).abs() / l)[live].max()
    dacc = ((got[..., 2:] - acc).abs() / l[..., None])[live].max()
    return max(dm.item(), dl.item(), dacc.item())


def check_splits(args, pipelined: bool = False) -> dict:
    """A paged kernel (the tile kernel, or the pipelined one) at every
    count of ``forced_splits``, launched
    uncounted into the middle of a NaN-filled buffer with NaN-filled split
    states: its output against the merge of the plain split states
    (``combine_partials(paged_split_partials(...))``, fp32 on the same
    values) and against the plain version, at ``close_to``'s gate; its
    split states against ``paged_split_partials`` (``partial_state_err``
    within FP32_ATOL); the combine kernel alone on the plain states against
    ``combine_partials``; nothing written beside the output, no NaN left in
    it or in the states, the inputs unchanged. Raises on any disagreement;
    returns the split counts and the worst errors."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    q = args[0]
    rows, w, h, d = q.shape
    before = [a.clone() for a in args]
    wide = [q.float()] + [p.float() if p.dtype == q.dtype else p
                          for p in args[1:3]] + list(args[3:])
    exact = pa.paged_reference_attention(*wide)
    name = "paged_decode_pipelined" if pipelined else "paged_decode"
    result = dict(splits=forced_splits(args, pipelined),
                  split_max_abs_err=0.0,
                  split_states_max_rel_err=0.0, combine_max_abs_err=0.0)
    for splits in result["splits"]:
        plain = pa.paged_split_partials(*args, splits=splits)
        merged = pa.combine_partials(plain)
        n, pad = q.numel(), 1 << 16
        buf = torch.full((n + 2 * pad,), float("nan"), dtype=q.dtype,
                         device=q.device)
        out = buf[pad:pad + n].view(q.shape)
        states = (torch.full((rows, w, h, splits, pa.PARTIAL_HEAD + d),
                             float("nan"), device=q.device)
                  if splits > 1 else None)
        pa._launch(*args[:5], out, *args[5:], pipelined=pipelined,
                   splits=splits, partials=states)
        torch.cuda.synchronize()
        ok = bool(torch.isnan(buf[:pad]).all() and torch.isnan(buf[-pad:]).all()
                  and not torch.isnan(out).any()
                  and close_to(out, merged, q.dtype)
                  and close_to(out, exact, q.dtype))
        err = (out.float() - merged).abs().max().item()
        result["split_max_abs_err"] = max(result["split_max_abs_err"], err)
        if splits > 1:
            state_err = partial_state_err(states, plain)
            alone = torch.empty_like(q)
            pa._launch_combine(plain, alone, pipelined=pipelined)
            torch.cuda.synchronize()
            want = pa.combine_partials(plain)
            ok = ok and state_err <= FP32_ATOL \
                and close_to(alone, want, q.dtype)
            result["split_states_max_rel_err"] = max(
                result["split_states_max_rel_err"], state_err)
            result["combine_max_abs_err"] = max(
                result["combine_max_abs_err"],
                (alone.float() - want).abs().max().item())
        if not ok:
            raise AssertionError(
                f"{name} at {splits} splits disagrees or writes outside its "
                f"output: {result}, this count's error {err}")
    if not all(same_bytes(a, b) for a, b in zip(before, args)):
        raise AssertionError(f"{name} at forced splits changed its inputs")
    return result


#: (what the case stands for, rows, w, deepest position + w, max_blocks).
#: The last two are the flagship serve run's shapes: its 16-row decode step
#: and its 144-row token-packed chunk step, tables of max_len 1152 / 16.
KERNEL_CASES = (("deep", 24, 1, 2048, 128), ("deep", 24, 3, 2048, 128),
                ("decode step", 16, 1, 1152, 72),
                ("chunk step", 144, 1, 1152, 72))


def phase_kernel(device) -> tuple:
    """Kernel vs plain version, through the wrapper (its planned splits)
    and at forced split counts (``check_splits``); returns the largest
    error against the plain version run at the kernel's own dtype and the
    combine kernel's largest error against its plain version."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)
    worst = combine_worst = 0.0
    for case, rows, w, depth, max_blocks in KERNEL_CASES:
        depths = [None if r % 6 == 5 else int(rng.integers(0, depth - w))
                  for r in range(rows)]
        depths[0] = depth - w                     # the deepest row
        for dtype in (torch.float32, torch.bfloat16):
            args = paged_case(gen, depths, w=w, max_blocks=max_blocks,
                              dtype=dtype, device=device)
            before = [a.clone() for a in args]
            got = pa.paged_decode_attention(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(before, args)):
                raise AssertionError("paged_decode changed its inputs")
            guarded = guarded_launch(args, got)
            same = pa.paged_reference_attention(*args)
            err = (got.float() - same.float()).abs().max().item()
            split = check_splits(args)
            worst = max(worst, err, split["split_max_abs_err"]
                        if dtype == torch.float32 else 0.0)
            combine_worst = max(combine_worst, split["combine_max_abs_err"]
                                if dtype == torch.float32 else 0.0)
            line = dict(case=case, w=w, dtype=str(dtype).replace("torch.", ""),
                        rows=rows, max_blocks=max_blocks,
                        inactive_rows=depths.count(None), max_abs_err=err,
                        writes_only_out_and_repeats=guarded,
                        planned_splits=pa.planned_splits(args[0], args[1],
                                                         max_blocks),
                        **split)
            if dtype == torch.float32:
                ok = err <= FP32_ATOL
                line["tolerance"] = (f"{FP32_ATOL}: fp32 sums in another "
                                     "order")
            else:
                line.update(against_fp32_plain(got, args))
                # The plain bf16 version rounds scores and probabilities to
                # 8 bits too, so against it the gate is bf16's resolution
                # at the unit-scale values these inputs give.
                ok = line.pop("ok") and err <= 2e-2
                line["tolerance"] = "vs bf16 plain: 2e-2, its bf16 " \
                                    "probabilities"
            ok = ok and guarded
            emit("kernel", ok=ok, **line)
            if not ok:
                raise AssertionError(f"paged_decode disagrees: {line}")
    return worst, combine_worst


#: Rows of the timed paged shapes, tables 72 wide (the flagship engine's
#: max_len 1152 / block 16): batch 1, 16 and 32 at depth 1024, and the
#: serve run's 144-row token-packed chunk step at ragged depths up to 1151.
TIMED_ROWS = (1, 16, 32, 144)
CHUNK_ROWS = 144


def timed_case(gen, rng, rows: int, kv_dtype, device) -> tuple:
    """bf16-query inputs at one timed shape (flagship geometry), SDPA over
    the gathered live view (dequantized to bf16 ahead of time for a
    quantized pool; masked where depths are ragged) as ``library``, and the
    bytes and flops the function needs: each visible token's K and V row
    once in its storage type, the live blocks' scales and table entries, q
    in and out, the positions."""
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import flat_pool, gather_kv

    F = torch.nn.functional
    bs, h, kv, d = 16, 8, 2, 128
    depths = ([1151] + [int(x) for x in rng.integers(0, 1152, rows - 1)]
              if rows == CHUNK_ROWS else [1023] * rows)
    args = quant_args(gen, depths, w=1, h=h, kv=kv, d=d, bs=bs, max_blocks=72,
                      q_dtype=torch.bfloat16, kv_dtype=kv_dtype, device=device)
    q, kp, vp, tables, pos = args[:5]
    live = tables[:, :max(depths) // bs + 1]
    if kv_dtype is None:
        kd, vd = (gather_kv(flat_pool(p), live, bs) for p in (kp, vp))
    else:
        kd, vd = (pa.dequantize_view(
            gather_kv(flat_pool(p.view(torch.uint8)), live, bs)
            .view(p.dtype), s, live, bs, torch.bfloat16)
            for p, s in ((kp, args[5]), (vp, args[6])))
    kd, vd = (t.transpose(1, 2).contiguous() for t in (kd, vd))
    qd = q.transpose(1, 2).contiguous()              # (b, h, 1, d)
    if len(set(depths)) == 1:
        def library():
            return F.scaled_dot_product_attention(qd, kd, vd, enable_gqa=True)
    else:
        kd, vd = (t.repeat_interleave(h // kv, dim=1) for t in (kd, vd))
        mask = (torch.arange(kd.shape[2], device=device)
                <= pos[:, :, None])[:, None]          # (b, 1, 1, L)

        def library():
            return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
    tokens = sum(x + 1 for x in depths)
    blocks = sum(x // bs + 1 for x in depths)
    n_bytes = (tokens * kv * kp.shape[-1] * kp.element_size() * 2
               + (blocks * kv * 4 * 2 if kv_dtype else 0)
               + 2 * q.numel() * q.element_size() + blocks * 4
               + pos.numel() * 4)
    return args, library, n_bytes, 4 * h * d * tokens


def bound(n_bytes: int, flops: int) -> dict:
    by_bytes, by_flops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return dict(bound_ms=max(by_bytes, by_flops) * 1e3,
                bound_by="bytes" if by_bytes >= by_flops else "operations",
                bytes=n_bytes, flops=flops)


def unsplit_ms(timer, args, pipelined: bool = False) -> float:
    """A paged kernel's device ms with each row's walk left whole: one
    split, one CTA per row and kv head, the grid before split-KV; launched
    uncounted."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    out = torch.empty_like(args[0])
    return timer(lambda: pa._launch(*args[:5], out, *args[5:],
                                    pipelined=pipelined, splits=1))


def shape_name(rows: int) -> str:
    return "chunk step" if rows == CHUNK_ROWS else f"batch {rows}"


def phase_timing(device, smi: str) -> dict:
    """Kernel, plain and SDPA times at the flagship decode shapes and the
    serve run's chunk step, the split plan and CTAs beside each; then, at
    batch 16, wrapper calls traced apart into the split walk and the
    combine, and the combine kernel alone. Returns {rows: row, "combine":
    row}."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    timer = DeviceTimer(device)
    gen = torch.Generator().manual_seed(2)
    rng = np.random.default_rng(2)
    rows_out = {}
    for rows in TIMED_ROWS:
        args, library, n_bytes, flops = timed_case(gen, rng, rows, None,
                                                   device)
        q = args[0]

        def kernel():
            return pa.paged_decode_attention(*args)

        def plain():
            return pa.paged_reference_attention(*args)

        got = kernel()
        check = against_fp32_plain(got, args)
        lib_err = (library().transpose(1, 2).float()
                   - got.float()).abs().max().item()
        if not check.pop("ok") or lib_err > 2e-2:
            raise AssertionError(f"kernel or SDPA yardstick disagrees at "
                                 f"{shape_name(rows)}: {check}, SDPA "
                                 f"{lib_err}")
        splits = pa.planned_splits(q, args[1], args[3].shape[1])
        row = dict(shape=shape_name(rows), batch=rows,
                   depth="ragged up to 1151" if rows == CHUNK_ROWS else 1024,
                   dtype="bfloat16", splits=splits,
                   ctas=rows * args[1].shape[2] * splits,
                   ms=timer(kernel), unsplit_ms=unsplit_ms(timer, args),
                   plain_ms=timer(plain), library_ms=timer(library),
                   **bound(n_bytes, flops),
                   host_ms=host_ms(kernel), plain_host_ms=host_ms(plain),
                   library_max_abs_diff=lib_err, **check, gpu=smi)
        row["fraction_of_bound"] = row["bound_ms"] / row["ms"]
        emit("timing", **row)
        rows_out[rows] = row
        if rows == 16:
            profile_wrapper(timer, kernel, row, smi)
            rows_out["combine"] = time_combine(timer, args, splits, smi)
    return rows_out


def profile_wrapper(timer, kernel, row: dict, smi: str, iters: int = 20,
                    name: str = "paged_decode") -> None:
    """``iters`` wrapper calls under ``torch.profiler``, the L2 flushed
    before each as ``DeviceTimer`` does: each call must launch one split
    walk of kernel ``name``, and one combine after it when ``row``'s plan
    splits; prints the mean device ms of each and of the span from the
    walk's start to the combine's end (the gap between the two launches
    included). One more call runs first inside the trace and is not read:
    a tracer started after earlier ones in the process may miss its first
    kernel (seen on the H100: 19 walks of 20 calls)."""
    from torch.profiler import ProfilerActivity, profile

    kernel()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters + 1):
            timer.flush.zero_()
            kernel()
        torch.cuda.synchronize()
    events = sorted((start, end, name)
                    for name, start, end in device_events(prof))
    walk_names = {"paged_decode": ("paged_decode_kernel",),
                  "paged_decode_pipelined": (
                      "paged_decode_pipelined_kernel",
                      "paged_decode_pipelined_mma_kernel")}[name]
    walks = [(s, e) for s, e, ev in events
             if any(w in ev for w in walk_names)]
    combines = [(s, e) for s, e, ev in events
                if "combine_splits_kernel" in ev]
    split = row["splits"] > 1
    seen = (len(walks), len(combines))
    walks, combines = walks[-iters:], combines[-iters:] if split else []
    paired = all(w_end <= c_start and (i + 1 == iters
                                       or c_end <= walks[i + 1][0])
                 for i, ((_, w_end), (c_start, c_end))
                 in enumerate(zip(walks, combines)))
    if not (iters <= seen[0] <= iters + 1 and len(walks) == iters
            and seen[1] <= (iters + 1 if split else 0)
            and len(combines) == (iters if split else 0) and paired):
        raise AssertionError(
            f"{iters + 1} traced wrapper calls at {row['splits']} splits "
            f"showed {seen[0]} split walks and {seen[1]} combines"
            f"{'' if paired else ', not each combine after its walk'}")
    walk_ms = float(np.mean([e - s for s, e in walks])) / 1e3
    combine_ms = (float(np.mean([e - s for s, e in combines])) / 1e3
                  if combines else 0.0)
    ends = [e for _, e in (combines or walks)]
    span_ms = float(np.mean([e - s for (s, _), e in zip(walks, ends)])) / 1e3
    emit("timing_profile", kernel=name, storage=row.get("storage"),
         batch=row["batch"],
         splits=row["splits"], calls=iters, walk_ms=walk_ms,
         combine_ms=combine_ms, span_ms=span_ms,
         gap_ms=span_ms - walk_ms - combine_ms,
         combine_share_of_span=combine_ms / span_ms,
         timed_ms=row["ms"], gpu=smi)


def time_combine(timer, args, splits: int, smi: str) -> dict:
    """The combine kernel alone on the plain split states of ``args`` at
    ``splits``, against ``combine_partials`` in the same type; its bound
    reads the states once and writes the output once."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    q = args[0]
    states = pa.paged_split_partials(*args, splits=splits)
    out = torch.empty_like(q)

    def kernel():
        pa._launch_combine(states, out)

    def plain():
        return pa.combine_partials(states, q.dtype)

    kernel()
    want = pa.combine_partials(states)
    if not close_to(out, want, q.dtype):
        raise AssertionError("the combine kernel disagrees with "
                             "combine_partials")
    row = dict(kernel="paged_decode_combine", batch=q.shape[0],
               splits=splits, output_rows=q.numel() // q.shape[-1],
               max_abs_err=(out.float() - want).abs().max().item(),
               ms=timer(kernel), plain_ms=timer(plain), library_ms=None,
               **bound(states.numel() * 4 + out.numel() * out.element_size(),
                       0), gpu=smi)
    row["fraction_of_bound"] = row["bound_ms"] / row["ms"]
    emit("timing_combine", **row)
    return row


def _parity_waves(vocab: int, bs: int):
    rng = np.random.default_rng(7)
    ps = [rng.integers(0, vocab, size=n).astype(np.int32)
          for n in (3, 21, 9, 1, 3 * bs + 2, 6)]
    first = [(ps[0], 9, {}), (ps[1], 6, {}), (ps[2], 8, {}),
             (ps[3], 7, {"temperature": 0.8, "top_p": 0.9, "key": [7, 9]}),
             (ps[4], 8, {}), (ps[5], 10, {"temperature": 1.1})]
    shared = np.concatenate([ps[4][:2 * bs], ps[0]])
    second = [(shared, 6, {}), (ps[4][:3 * bs], 4, {}), (ps[1], 5, {})]
    return [first, second]


def phase_parity(device) -> None:
    from tpu_task_torch.ml.models.decoding import generate
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.serve.replica import build_engine

    for preset, small in (("micro", 14), ("tiny", 8)):
        for n_blocks in (None, small):
            outs, stats = {}, {}
            for impl in ("cuda", "reference"):
                serving = {"decode_impl": impl}
                if n_blocks:
                    serving["n_blocks"] = n_blocks
                engine = build_engine(preset, serving=serving, device=device)
                waves = _parity_waves(engine.cfg.vocab_size,
                                      engine.scfg.block_size)
                before = pa.paged_decode_attention.launches
                for wave in waves:
                    for prompt, max_new, kw in wave:
                        engine.submit(prompt, max_new, **kw)
                    outs[impl] = engine.drain(max_steps=5000)
                stats[impl] = engine.stats()
                fused = engine.chunk_steps + engine.decode_steps
                launched = pa.paged_decode_attention.launches - before
                want = engine.cfg.n_layers * fused if impl == "cuda" else 0
                if launched != want or stats[impl]["decode_impl"] != impl:
                    raise AssertionError(
                        f"{preset}/{impl}: {launched} kernel launches, "
                        f"expected {want}")
            if outs["cuda"] != outs["reference"]:
                raise AssertionError(f"{preset}: kernel and plain streams "
                                     "differ")
            greedy = [(rid, prompt, max_new) for rid, (prompt, max_new, kw)
                      in enumerate(w for wave in waves for w in wave)
                      if not kw]
            for rid, prompt, max_new in greedy:
                ref = generate(engine.params, engine.cfg, prompt[None],
                               max_new, device=device)[0].tolist()
                if outs["cuda"][rid] != ref:
                    raise AssertionError(
                        f"{preset}: request {rid} differs from generate")
            s = stats["cuda"]
            pressure = s["recompute_preemptions"] if n_blocks else None
            if n_blocks and not pressure:
                raise AssertionError(f"{preset}: the small pool never "
                                     "preempted")
            if not n_blocks and not s["prefix_cache"]["hit_requests"]:
                raise AssertionError(f"{preset}: no prefix-cache hit")
            emit("parity", ok=True, preset=preset, n_blocks=n_blocks
                 or engine.scfg.n_blocks, requests=len(outs["cuda"]),
                 greedy_vs_generate=len(greedy),
                 preemptions=s["recompute_preemptions"],
                 prefix_hit_requests=s["prefix_cache"]["hit_requests"],
                 cow_copies=s["prefix_cache"]["cow_copies"],
                 chunk_steps=s["chunk_steps"], decode_steps=s["decode_steps"])


class StepRecorder:
    """Stands in for the serving model's ``paged_attention``: passes every
    call through and, while ``armed``, keeps copies of layer 0's inputs and
    output in the first decode step and in the last chunk step, so the
    kernel's work in the run can be held against the plain version after
    it. ``calls`` counts from a step boundary."""

    def __init__(self, fn, n_layers: int, slots: int):
        self.fn, self.n_layers, self.slots = fn, n_layers, slots
        self.calls, self.armed, self.steps = 0, False, {}

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        layer = self.calls % self.n_layers
        self.calls += 1
        if self.armed and layer == 0:
            kind = ("decode step" if args[0].shape[0] == self.slots
                    else "chunk step")
            if kind == "chunk step" or kind not in self.steps:
                self.steps[kind] = ([a.clone() for a in args], out.clone())
        return out


def _submit_wave(engine, seed: int, max_new: int = 64):
    """16 requests of 256-1024 prompt tokens and ``max_new`` new tokens:
    12 greedy, 4 sampled at temperature 0.8 / top_p 0.9 with raw keys."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(256, 1025, size=16)
    rids = []
    for i, n in enumerate(lengths):
        prompt = rng.integers(0, engine.cfg.vocab_size, size=int(n))
        kw = ({"temperature": 0.8, "top_p": 0.9,
               "key": np.array([1000 + 100 * seed + i, i], np.uint32)}
              if i % 4 == 3 else {})
        rids.append(engine.submit(prompt, max_new, **kw))
    return rids, int(lengths.sum())


def _timed_drain(engine, seed: int, max_new: int = 64,
                 step_range=contextlib.nullcontext) -> dict:
    """One wave through the engine, its launch counts and goodput meter set
    to 0 just before and read just after; ``step_range()`` wraps each step
    (a profiler range). ``kernel_launches`` counts the kernel the engine
    resolved (``decode_impl``); ``other_kernel_launches`` the other one.
    A micro-step (``micro_k`` > 1) makes ``micro_k`` decode-shape calls a
    layer, a retired slot's masked iterations included. ``step_kinds``
    says which steps were chunk steps ("c") and which decode or micro
    steps ("d"), in order."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    rids, prompt_tokens = _submit_wave(engine, seed, max_new)
    chunk0, decode0 = engine.chunk_steps, engine.decode_steps
    micro0, preempt0 = engine.micro_steps, engine.preemption_count
    captures0 = engine.stats()["step_graph"]["captures"]
    decode_ms, chunk_ms, kinds = [], [], []
    decode_tokens = 0
    engine.goodput.reset()
    pa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.has_work:
        chunks, s0 = engine.chunk_steps, time.perf_counter()
        emitted = engine.goodput.tokens_emitted
        with step_range():
            engine.step()
        chunk = engine.chunk_steps > chunks
        (chunk_ms if chunk else decode_ms).append(
            (time.perf_counter() - s0) * 1e3)
        kinds.append("c" if chunk else "d")
        if not chunk:
            decode_tokens += engine.goodput.tokens_emitted - emitted
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = {"cuda": pa.paged_decode_attention,
               "pipelined": pa.paged_decode_pipelined_attention}
    kernel = kernels.pop(engine.decode_impl)
    launches, combines = kernel.launches, kernel.combine_launches
    other = sum(fn.launches + fn.combine_launches for fn in kernels.values())
    plain = pa.paged_reference_attention.launches
    plans = step_splits(engine)
    results = [engine.request(rid) for rid in rids]
    generated = sum(len(r.tokens) for r in results)
    chunk_steps = engine.chunk_steps - chunk0
    micro_steps = engine.micro_steps - micro0
    # decode-shape calls a layer: one a plain decode step, K a micro-step
    decode_calls = (engine.decode_steps - decode0 - micro_steps
                    + engine.scfg.micro_k * micro_steps)
    goodput = engine.stats()["goodput"]
    return dict(
        seed=seed, requests=len(results), prompt_tokens=prompt_tokens,
        generated_tokens=generated, wall_s=wall,
        tokens_per_s=generated / wall,
        prompt_and_generated_tokens_per_s=(generated + prompt_tokens) / wall,
        decode_steps=engine.decode_steps - decode0,
        chunk_steps=chunk_steps, micro_k=engine.scfg.micro_k,
        micro_steps=micro_steps,
        mean_decode_step_ms=float(np.mean(decode_ms)) if decode_ms else None,
        mean_chunk_step_ms=float(np.mean(chunk_ms)),
        # the tokens of the decode (or micro-) steps over their wall
        decode_phase_tokens=decode_tokens,
        decode_phase_tokens_per_s=(decode_tokens / sum(decode_ms) * 1e3
                                   if decode_ms else None),
        kernel=engine.decode_impl, kernel_launches=launches,
        other_kernel_launches=other, plain_launches=plain,
        expected_launches=engine.cfg.n_layers * (chunk_steps + decode_calls),
        step_splits=plans, combine_launches=combines,
        expected_combine_launches=engine.cfg.n_layers * (
            decode_calls * (plans["decode"] > 1)
            + chunk_steps * (plans["chunk"] > 1)),
        all_finished=all(r.status == "done" and len(r.tokens) == max_new
                         for r in results),
        preemptions=engine.preemption_count - preempt0,
        host_gap_frac=goodput["host_gap_frac"],
        dispatches_per_token=goodput["dispatches_per_token"],
        graph_captures=engine.stats()["step_graph"]["captures"] - captures0,
        rids=rids, step_kinds="".join(kinds))


def step_splits(engine) -> dict:
    """The split plan of the engine's kernel at its decode and chunk
    steps."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    cfg, scfg = engine.cfg, engine.scfg
    pool = engine.pools[0]["k"]
    plans = {}
    for step, rows in (("decode", scfg.slots),
                       ("chunk", scfg.slots + scfg.chunk_tokens)):
        q = torch.empty((rows, 1, cfg.n_heads, cfg.d_head), dtype=cfg.dtype,
                        device=pool.device)
        plans[step] = pa.planned_splits(
            q, pool, scfg.max_blocks_per_slot,
            pipelined=engine.decode_impl == "pipelined")
    return plans


#: The flagship serve engine's configuration (phases 6 and 14).
SERVE_KNOBS = dict(slots=16, block_size=16, chunk_tokens=128, max_len=1152,
                   n_blocks=16 * 72 + 1)


def flagship_model(device):
    from tpu_task_torch.ml.models import transformer

    cfg = transformer.TransformerConfig(dtype=torch.bfloat16, **FLAGSHIP)
    params = transformer.init(
        torch.Generator(device=device).manual_seed(0), cfg)
    return cfg, params


def warm_up(engine) -> None:
    """bf16 GEMMs at the chunk and decode row counts, both samplers, the
    allocator's growth and, at ``micro_k`` > 1, the capture of both
    K-step graphs (a decode step with a sampled request, then one with a
    greedy request alone), outside the timed waves."""
    rng = np.random.default_rng(99)
    vocab = engine.cfg.vocab_size
    engine.submit(rng.integers(0, vocab, size=300), 4)
    engine.submit(rng.integers(0, vocab, size=200), 4, temperature=0.8,
                  top_p=0.9, key=np.array([5, 6], np.uint32))
    engine.drain()
    engine.submit(rng.integers(0, vocab, size=100), 4)
    engine.drain()


def serve_flagship(device, smi: str, phase: str, **serving) -> tuple:
    """A flagship engine with ``serving`` over SERVE_KNOBS: a warm-up wave,
    then three timed waves of fresh prompts, gated. Returns (the engine,
    its kernel's launch count over the timed waves, the phase line)."""
    from tpu_task_torch.ml.serving import model as serving_model
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine

    cfg, params = flagship_model(device)
    n_params = sum(p.numel() for p in params.values() if torch.is_tensor(p))
    n_params += sum(p.numel() for layer in params["layers"]
                    for p in layer.values())
    scfg = ServingConfig(**SERVE_KNOBS, **serving)
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(params, cfg, scfg, device=device)
    warm_up(engine)

    # Every fused step's logits must be finite: checked on the card, with
    # no host sync, by wrapping the step the engine's samplers call.
    finite = torch.ones((), dtype=torch.bool, device=device)
    step_fn, attn_fn = serving_model.paged_decode_step, \
        serving_model.paged_attention
    recorder = StepRecorder(attn_fn, cfg.n_layers, scfg.slots)

    def checked_step(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        logits = out[0] if isinstance(out, tuple) else out
        finite.logical_and_(torch.isfinite(logits).all())
        return out

    serving_model.paged_decode_step = checked_step
    serving_model.paged_attention = recorder
    runs = []
    try:
        for seed in range(3):
            recorder.armed = seed == 0
            runs.append(_timed_drain(engine, seed))
    finally:
        serving_model.paged_decode_step = step_fn
        serving_model.paged_attention = attn_fn
    for run in runs:
        emit(f"{phase}_wave", **run, gpu=smi)

    # The kernel's output in the run against the plain version.
    steps_ok = True
    for kind, (args, out) in sorted(recorder.steps.items()):
        pos = args[4]
        check = against_fp32_plain(out, args)
        steps_ok = steps_ok and check["ok"]
        emit(f"{phase}_step_check", step=kind, layer=0,
             rows=int(pos.shape[0]), deepest_position=int(pos.max()), **check)
    checked = sorted(recorder.steps)
    recorder.steps.clear()               # its copies stay out of later peaks
    launches = sum(r["kernel_launches"] for r in runs)
    line = dict(
        params=n_params, waves=len(runs), kv_dtype=scfg.kv_dtype or "bfloat16",
        decode_impl=engine.decode_impl,
        tokens_per_s_median=float(np.median(
            [r["tokens_per_s"] for r in runs])),
        tokens_per_s_runs=[r["tokens_per_s"] for r in runs],
        mean_decode_step_ms_median=float(np.median(
            [r["mean_decode_step_ms"] for r in runs])),
        mean_chunk_step_ms_median=float(np.median(
            [r["mean_chunk_step_ms"] for r in runs])),
        kernel_launches=launches,
        other_kernel_launches=sum(r["other_kernel_launches"] for r in runs),
        plain_launches=sum(r["plain_launches"] for r in runs),
        step_splits=runs[0]["step_splits"],
        combine_launches=sum(r["combine_launches"] for r in runs),
        kv_pool_bytes=engine.stats()["kv_pool_bytes"],
        steps_checked=checked, logits_finite=bool(finite),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, gpu=smi)
    emit(phase, **line)
    if not (bool(finite) and steps_ok and len(checked) == 2
            and all(wave_ok(r) for r in runs)):
        raise AssertionError(f"flagship serving run ({phase}) failed its "
                             f"gates: {line}")
    return engine, launches, line


def phase_serve(device, smi: str) -> tuple:
    """The main path: the flagship with bf16 pools through the tile
    kernel. Returns the kernel's and the combine kernel's launch counts
    over the timed waves."""
    _, launches, line = serve_flagship(device, smi, "serve")
    return launches, line["combine_launches"]


def phase_serve_quant(device, smi: str) -> tuple:
    """The quantized path: the flagship with int8 pools through the
    pipelined kernel (three timed waves), then one shorter wave each of
    fp8 and int4 through the pipelined kernel and int8 through the tile
    kernel. Returns the pipelined kernel's and its combine kernel's launch
    counts over the three timed int8 waves."""
    from tpu_task_torch.ml.serving.cache import ServingConfig, \
        paged_cache_bytes
    from tpu_task_torch.ml.serving.engine import ServingEngine

    engine, launches, line = serve_flagship(
        device, smi, "serve_quant", kv_dtype="int8", decode_impl="pipelined")
    bf16_pool = paged_cache_bytes(engine.cfg, ServingConfig(**SERVE_KNOBS),
                                  SERVE_KNOBS["n_blocks"])
    params, cfg = engine.params, engine.cfg
    del engine
    short = []
    for kv_dtype, impl in (("fp8", "pipelined"), ("int4", "pipelined"),
                           ("int8", "cuda")):
        engine = ServingEngine(params, cfg,
                               ServingConfig(**SERVE_KNOBS, kv_dtype=kv_dtype,
                                             decode_impl=impl),
                               device=device)
        run = _timed_drain(engine, 3, max_new=16)
        run.update(kv_dtype=kv_dtype,
                   kv_pool_bytes=engine.stats()["kv_pool_bytes"])
        emit("serve_quant_short_wave", **run, gpu=smi)
        short.append(run)
        del engine
    emit("serve_quant_pool", bf16_kv_pool_bytes=bf16_pool,
         int8_kv_pool_bytes=line["kv_pool_bytes"],
         int8_over_bf16=line["kv_pool_bytes"] / bf16_pool,
         short_waves={f"{r['kv_dtype']}/{r['kernel']}": r["kv_pool_bytes"]
                      for r in short})
    if not all(wave_ok(r) for r in short):
        raise AssertionError(f"a short quantized wave failed its gates: "
                             f"{short}")
    return launches, line["combine_launches"]


def wave_ok(run: dict) -> bool:
    """A serve wave's gates: every request done, every fused step through
    the engine's kernel once per layer, nothing through the other kernel
    (nor its combine) or the plain version, and the combine kernel after
    every call whose step shape the plan splits."""
    return (run["all_finished"] and run["plain_launches"] == 0
            and run["other_kernel_launches"] == 0
            and run["kernel_launches"] == run["expected_launches"] > 0
            and run["combine_launches"] == run["expected_combine_launches"])


# -- K-token micro-steps --------------------------------------------------------

MICRO_KS = (1, 4, 8)


def serve_micro(device, smi: str, phase: str, ks, seeds,
                keep=(), **serving) -> tuple:
    """For each K of ``ks``: a flagship engine with ``serving`` over
    SERVE_KNOBS at ``micro_k`` K, the serve phase's warm-up, then one timed
    wave per seed, gated as the serve waves are (launches counted K a
    micro-step). Every request's stream at each K must equal the first
    K's, token for token. Returns (the phase line of each K, the engines
    of the Ks in ``keep``, kept for the trace)."""
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine

    cfg, params = flagship_model(device)
    streams, lines, kept = {}, {}, {}
    for k in ks:
        torch.cuda.reset_peak_memory_stats()
        engine = ServingEngine(params, cfg, ServingConfig(
            **SERVE_KNOBS, micro_k=k, **serving), device=device)
        warm_up(engine)
        runs = []
        for seed in seeds:
            run = _timed_drain(engine, seed)
            streams[k, seed] = [engine.request(rid).tokens
                                for rid in run["rids"]]
            emit(f"{phase}_wave", **run, gpu=smi)
            runs.append(run)
        graphs = engine.stats()["step_graph"]

        def median(key):
            return float(np.median([r[key] for r in runs]))

        lines[k] = line = dict(
            micro_k=k, kv_dtype=engine.scfg.kv_dtype or "bfloat16",
            decode_impl=engine.decode_impl, waves=len(runs),
            tokens_per_s_runs=[r["tokens_per_s"] for r in runs],
            tokens_per_s_median=median("tokens_per_s"),
            mean_chunk_step_ms_median=median("mean_chunk_step_ms"),
            mean_decode_or_micro_step_ms_median=median(
                "mean_decode_step_ms"),
            decode_phase_tokens_per_s_runs=[r["decode_phase_tokens_per_s"]
                                            for r in runs],
            chunk_steps=sum(r["chunk_steps"] for r in runs),
            decode_steps=sum(r["decode_steps"] for r in runs),
            micro_steps=sum(r["micro_steps"] for r in runs),
            graph_captures=graphs["captures"],
            graph_captures_in_waves=sum(r["graph_captures"] for r in runs),
            capture_ms=graphs["capture_ms"], graph_replays=graphs["replays"],
            host_gap_frac_runs=[r["host_gap_frac"] for r in runs],
            dispatches_per_token_runs=[r["dispatches_per_token"]
                                       for r in runs],
            kernel_launches=sum(r["kernel_launches"] for r in runs),
            combine_launches=sum(r["combine_launches"] for r in runs),
            other_kernel_launches=sum(r["other_kernel_launches"]
                                      for r in runs),
            plain_launches=sum(r["plain_launches"] for r in runs),
            step_splits=runs[0]["step_splits"],
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, gpu=smi)
        same = all(streams[k, seed] == streams[ks[0], seed]
                   for seed in seeds)
        line["streams_equal_micro_k_%d" % ks[0]] = same
        emit(phase, **line)
        if not (same and all(wave_ok(r) for r in runs)
                and (k == 1 or line["micro_steps"] > 0)):
            raise AssertionError(f"{phase} at micro_k {k} failed its gates: "
                                 f"{line}")
        if k in keep:
            kept[k] = engine
        del engine
    return lines, kept


def phase_serve_micro(device, smi: str) -> tuple:
    """The micro-step path: the flagship with bf16 pools through the tile
    kernel at K = 1, 4 and 8, three timed waves each. Returns the K lines
    and the K = 1 and K = 8 engines (for the trace)."""
    return serve_micro(device, smi, "serve_micro", MICRO_KS, (0, 1, 2),
                       keep=(1, MICRO_KS[-1]))


def phase_serve_micro_quant(device, smi: str) -> dict:
    """int8 pools through the pipelined kernel at K = 8, one wave against
    a K = 1 engine of the same configuration. Returns the K lines."""
    lines, _ = serve_micro(device, smi, "serve_micro_quant",
                           (1, MICRO_KS[-1]), (0,), kv_dtype="int8",
                           decode_impl="pipelined")
    return lines


#: Device kernel names of the paged kernels' split walks and their combine.
WALK_NAMES = {"cuda": ("paged_decode_kernel",),
              "pipelined": ("paged_decode_pipelined_kernel",
                            "paged_decode_pipelined_mma_kernel")}
COMBINE_NAME = "combine_splits_kernel"


def trace_wave(engine, seed: int, smi: str) -> dict:
    """One wave under ``torch.profiler`` (CPU and CUDA): per fused step
    kind the mean wall, device-busy ms and idle share (device events
    assigned to the step whose host range holds their start: every step
    ends in a readback), the ten device ops with the most time, the ten
    host ops with the most self time (``serve_step`` is the step's own
    Python), and the paged kernels' launches counted by name in the trace,
    which must equal the wrappers' counters."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # A tracer started after others in a process may miss its first
        # kernel: let that be this one, which nothing reads.
        torch.ones(1, device=engine.device).add_(1)
        torch.cuda.synchronize()
        run = _timed_drain(engine, seed,
                           step_range=lambda: record_function("serve_step"))
    steps = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name == "serve_step"
                   and e.device_type == torch.autograd.DeviceType.CPU)
    # The step ranges also show on the device timeline: leave them out.
    events = sorted((start, end, name)
                    for name, start, end in device_events(prof)
                    if name != "serve_step")
    kinds = run["step_kinds"]
    if len(steps) != len(kinds):
        raise AssertionError(f"the trace holds {len(steps)} step ranges for "
                             f"{len(kinds)} steps")
    per = {kind: {"steps": 0, "wall_ms": 0.0, "busy_ms": 0.0}
           for kind in "cd"}
    i, by_name = 0, {}
    for (start, end), kind in zip(steps, kinds):
        busy, last = 0.0, -math.inf
        while i < len(events) and events[i][0] < end:
            d_start, d_end, name = events[i]
            by_name[name] = by_name.get(name, 0.0) + (d_end - d_start) / 1e3
            if d_start >= start and d_end > last:  # union of intervals
                busy += d_end - max(d_start, last)
                last = d_end
            i += 1
        row = per[kind]
        row["steps"] += 1
        row["wall_ms"] += (end - start) / 1e3
        row["busy_ms"] += busy / 1e3
    walk_names = WALK_NAMES[engine.decode_impl]
    walks = sum(any(w in name for w in walk_names)
                for _, _, name in events)
    combines = sum(COMBINE_NAME in name for _, _, name in events)
    steps_out = {}
    for kind, label in (("c", "chunk_step"), ("d", "decode_or_micro_step")):
        row = per[kind]
        n = max(1, row["steps"])
        steps_out[label] = dict(
            steps=row["steps"], mean_wall_ms=row["wall_ms"] / n,
            mean_device_busy_ms=row["busy_ms"] / n,
            device_idle_share=(1 - row["busy_ms"] / row["wall_ms"]
                               if row["wall_ms"] else None))
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    line = dict(
        micro_k=engine.scfg.micro_k, kernel=engine.decode_impl,
        traced_tokens_per_s=run["tokens_per_s"],
        chunk_steps=run["chunk_steps"], decode_steps=run["decode_steps"],
        micro_steps=run["micro_steps"], **steps_out,
        wave_device_busy_ms=sum(r["busy_ms"] for r in per.values()),
        wave_wall_ms=sum(r["wall_ms"] for r in per.values()),
        top_device_ops_ms=[(name[:90], ms) for name, ms in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        top_host_ops_self_ms=[(e.key[:90], e.self_cpu_time_total / 1e3,
                               e.count) for e in host[:10]],
        traced_walks=walks, traced_combines=combines,
        kernel_launches=run["kernel_launches"],
        combine_launches=run["combine_launches"], gpu=smi)
    line["wave_device_idle_share"] = (
        1 - line["wave_device_busy_ms"] / line["wave_wall_ms"])
    emit("serve_trace", **line)
    if not (wave_ok(run) and walks == run["kernel_launches"]
            and combines == run["combine_launches"]):
        raise AssertionError(f"serve trace at micro_k "
                             f"{engine.scfg.micro_k}: the trace's paged "
                             f"kernels differ from the counters or the wave "
                             f"failed its gates: {line}")
    return line


def phase_serve_trace(engines: dict, smi: str) -> dict:
    """One wave at K = 1 and one at K = 8 under the profiler (seed 3, a
    wave none of the timed ones was)."""
    return {k: trace_wave(engine, 3, smi) for k, engine in engines.items()}


# -- flash attention ------------------------------------------------------------

#: (b, h, sq, sk, d, causal, q_offset): the flagship train step's own shape
#: first, then sq = sk, sq < sk, ring attention's q_offset 0 with sq != sk,
#: a negative offset whose first 96 rows see no key, ragged lengths the
#: 64-row tiles mask, and non-causal pairs; then the forward's 128-row tile
#: edges: sq 1, 127, 129 and 257, sk < sq (causal rows that see nothing,
#: and a non-causal pair), a q_offset of -130 (a whole tile that sees
#: nothing) and d 64 at sq 384; then the backward's 64-row q stage edges:
#: sq 65 and 193 (one row into a stage, at d 128 and 64) and a q_offset of
#: -64 (a whole stage that sees nothing).
FLASH_CASES = (
    (8, 8, 1024, 1024, 128, True, None),
    (2, 4, 128, 128, 64, True, None),
    (2, 4, 128, 128, 128, False, None),
    (1, 8, 512, 2048, 128, True, None),
    (1, 8, 2048, 2048, 128, True, None),
    (2, 2, 256, 512, 64, True, 0),
    (2, 2, 256, 256, 128, True, -96),
    (1, 4, 200, 328, 128, False, None),
    (1, 4, 200, 328, 64, True, None),
    (2, 2, 1, 1, 128, True, None),
    (1, 2, 1, 300, 64, True, None),
    (2, 2, 127, 127, 128, True, None),
    (1, 2, 129, 129, 128, True, None),
    (1, 2, 257, 300, 128, True, None),
    (1, 2, 257, 129, 128, True, None),
    (1, 2, 300, 200, 64, False, None),
    (2, 2, 256, 256, 128, True, -130),
    (1, 4, 384, 384, 64, True, None),
    (2, 2, 65, 65, 128, True, None),
    (1, 2, 193, 193, 128, True, None),
    (1, 4, 193, 300, 64, True, None),
    (2, 2, 256, 256, 128, True, -64),
)


def nan_guarded(launch, wants) -> bool:
    """Run an uncounted ``launch(*outs)`` whose outputs are views into the
    middle of NaN-filled buffers: True if it wrote exactly ``wants`` there
    and nothing on either side."""
    pad = 1 << 16
    bufs, outs = [], []
    for want in wants:
        buf = torch.full((want.numel() + 2 * pad,), float("nan"),
                         dtype=want.dtype, device=want.device)
        bufs.append(buf)
        outs.append(buf[pad:pad + want.numel()].view(want.shape))
    launch(*outs)
    torch.cuda.synchronize()
    return all(bool(torch.isnan(buf[:pad]).all())
               and bool(torch.isnan(buf[-pad:]).all())
               and torch.equal(out, want)
               for buf, out, want in zip(bufs, outs, wants))


def flash_gate(got, exact, atol: float) -> bool:
    """fp32: within ``atol`` of the plain version (sums in another order).
    bf16: within 2^-8 |ref| + 2^-8 max|ref| + ``atol`` of the plain version
    run in fp32 on the same bf16 values: the output's bf16 rounding, plus
    the bf16 rounding of the weights (p, and ds in the backward) before the
    tensor-core products, which the TPU kernels round too; each such
    rounding moves a sum by at most 2^-9 of its terms' magnitude, bounded
    by the tensor's scale."""
    err = (got.float() - exact.float()).abs()
    if got.dtype == torch.float32:
        return bool(err.max() <= atol)
    scale = exact.float().abs()
    return bool((err <= 2.0 ** -8 * (scale + scale.max()) + atol).all())


def phase_flash_kernel(device) -> dict:
    """The three flash kernels against their plain versions; returns each
    kernel's largest error against the plain version at its own type."""
    from tpu_task_torch.ml.ops import attention as fa

    gen = torch.Generator().manual_seed(3)
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for b, h, sq, sk, d, causal, q_offset in FLASH_CASES:
        off = sk - sq if q_offset is None else q_offset
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(shape, generator=gen).to(dtype)
                           .to(device) for shape in
                           ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d),
                            (b, sq, h, d)))
            before = [t.clone() for t in (q, k, v, do)]
            o, lse = fa.flash_attention(q, k, v, causal, q_offset=q_offset,
                                        return_lse=True)
            delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal,
                                 q_offset=q_offset)
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal,
                                      q_offset=q_offset)
            torch.cuda.synchronize()
            unchanged = all(torch.equal(x, y)
                            for x, y in zip(before, (q, k, v, do)))
            guarded = (
                nan_guarded(lambda o_, l_: fa._launch_fwd(
                    q, k, v, causal, off, o_, l_), (o, lse))
                and nan_guarded(lambda dq_: fa._launch_dq(
                    q, k, v, do, lse, delta, causal, off, dq_), (dq,))
                and nan_guarded(lambda dk_, dv_: fa._launch_dkv(
                    q, k, v, do, lse, delta, causal, off, dk_, dv_),
                    (dk, dv)))
            same_o, same_lse = fa.flash_attention_reference(q, k, v, causal,
                                                            q_offset)
            same = fa.flash_bwd_reference(q, k, v, do, lse, delta, causal,
                                          q_offset)
            wide = [t.float() for t in (q, k, v, do)]
            ex_o, ex_lse = fa.flash_attention_reference(*wide[:3], causal,
                                                        q_offset)
            exact = fa.flash_bwd_reference(*wide, lse, delta, causal,
                                           q_offset)
            errs, ok = {}, unchanged and guarded
            for name, got, plain, ref, atol in (
                    ("o", o, same_o, ex_o, FLASH_FWD_ATOL),
                    ("lse", lse, same_lse, ex_lse, FLASH_FWD_ATOL),
                    ("dq", dq, same[0], exact[0], FLASH_BWD_ATOL),
                    ("dk", dk, same[1], exact[1], FLASH_BWD_ATOL),
                    ("dv", dv, same[2], exact[2], FLASH_BWD_ATOL)):
                errs[name] = (got.float() - plain.float()).abs().max().item()
                errs[name + "_vs_fp32"] = (got.float() - ref).abs().max() \
                    .item()
                ok = ok and flash_gate(got, ref, atol)
            hidden = max(0, -off) if causal else 0
            if hidden:                 # rows that see no key: JAX's values
                ok = ok and bool((o[:, :hidden] == 0).all()) and bool(
                    (lse[:, :, :hidden] == fa.NEG_INF).all())
            worst["flash_fwd"] = max(worst["flash_fwd"], errs["o"],
                                     errs["lse"])
            worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"])
            worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs["dk"],
                                         errs["dv"])
            line = dict(b=b, h=h, sq=sq, sk=sk, d=d, causal=causal,
                        q_offset=off, rows_seeing_no_key=hidden,
                        dtype=str(dtype).replace("torch.", ""),
                        inputs_unchanged=unchanged,
                        writes_only_out_and_repeats=guarded,
                        max_abs_err=errs,
                        tolerance=(f"fp32: {FLASH_FWD_ATOL} forward, "
                                   f"{FLASH_BWD_ATOL} backward"
                                   if dtype == torch.float32 else
                                   "bf16: 2^-8*(|fp32 ref| + max|fp32 "
                                   "ref|) + the fp32 tolerance"))
            emit("flash_kernel", ok=ok, **line)
            if not ok:
                raise AssertionError(f"flash kernels disagree: {line}")
    return worst


def visible_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs the mask lets through: the score entries a kernel
    that skips masked tiles must still compute."""
    if not causal:
        return sq * sk
    return sum(max(0, min(sk, q_offset + i + 1)) for i in range(sq))


def phase_flash_timing(device, smi: str) -> dict:
    """Each flash kernel, its plain version and SDPA at the flagship train
    shape; returns one row per kernel."""
    from tpu_task_torch.ml.ops import attention as fa

    F = torch.nn.functional
    timer = DeviceTimer(device)
    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, TRAIN_FLAGSHIP["n_heads"], \
        TRAIN_FLAGSHIP["d_head"]
    gen = torch.Generator(device=device).manual_seed(4)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=device,
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, True, return_lse=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    # SDPA wants (b, h, s, d): the yardstick's own layout, made once.
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    lq, lk, lv = (t.clone().requires_grad_(True) for t in (qt, kt, vt))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    lib_err = (lib_out.detach().transpose(1, 2).float()
               - o.float()).abs().max().item()
    if lib_err > 2e-2:
        raise AssertionError(f"SDPA yardstick disagrees with the kernel: "
                             f"{lib_err}")

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_bwd():
        return torch.autograd.grad(lib_out, (lq, lk, lv), dot,
                                   retain_graph=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
        return torch.autograd.grad(out, (lq, lk, lv), dot)

    sdpa = dict(fwd=timer(sdpa_fwd), bwd=timer(sdpa_bwd),
                fwd_bwd=timer(sdpa_fwd_bwd))
    # delta = rowsum(dO * O), the plain torch before the backward pair
    # (flash_attention_bwd).
    delta_ms = timer(lambda: (do.float() * o.float()).sum(-1)
                     .transpose(1, 2).contiguous())
    pairs = visible_pairs(s, s, True, 0) * b * h
    tensor = b * s * h * d * q.element_size()     # one (b, s, h, d) tensor
    stats = b * h * s * 4                         # one (b, h, s) f32 array
    kernels = {
        # name: (kernel, plain, FLOPs, bytes). Products of the executed
        # (visible) score entries; each input read once, each output
        # written once.
        "flash_fwd": (
            lambda: fa.flash_attention(q, k, v, True, return_lse=True),
            lambda: fa.flash_attention_reference(q, k, v, True),
            2 * 2 * pairs * d, 4 * tensor + stats, sdpa["fwd"]),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
            lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, True),
            3 * 2 * pairs * d, 5 * tensor + 2 * stats, sdpa["bwd"]),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
            lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, True),
            4 * 2 * pairs * d, 6 * tensor + 2 * stats, sdpa["bwd"]),
    }
    rows = {}
    for name, (kernel, plain, flops, n_bytes, lib_ms) in kernels.items():
        t_ops, t_bytes = flops / BF16_FLOPS, n_bytes / HBM_BYTES_PER_S
        row = dict(kernel=name, b=b, s=s, h=h, d=d, dtype="bfloat16",
                   causal=True, ms=timer(kernel), plain_ms=timer(plain),
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   flops=flops, bytes=n_bytes, library_ms=lib_ms, gpu=smi)
        row["fraction_of_bound"] = row["bound_ms"] / row["ms"]
        row["tflops"] = flops / row["ms"] / 1e9
        emit("flash_timing", **row)
        rows[name] = row
    emit("flash_timing_sdpa", sdpa_fwd_ms=sdpa["fwd"],
         sdpa_bwd_ms=sdpa["bwd"], sdpa_fwd_bwd_ms=sdpa["fwd_bwd"],
         kernels_fwd_bwd_ms=sum(r["ms"] for r in rows.values()),
         kernels_bwd_ms=rows["flash_bwd_dq"]["ms"]
         + rows["flash_bwd_dkv"]["ms"], delta_ms=delta_ms,
         sdpa_max_abs_diff=lib_err, gpu=smi,
         note="library_ms of dq and dk/dv is SDPA's one backward call, "
              "which computes dq, dk and dv together; delta_ms is the "
              "plain-torch rowsum(dO * O) the kernels' backward runs first")
    return rows


#: (b, h, s, d, causal) of the forward's extra timings: the flagship's
#: non-causal twin, longer and shorter causal rows at the same tokens, and
#: d 64.
FWD_SHAPES = ((8, 8, 1024, 128, True), (8, 8, 1024, 128, False),
              (2, 8, 4096, 128, True), (4, 8, 2048, 128, True),
              (16, 8, 512, 128, True), (8, 16, 1024, 64, True))


def fwd_shape_times(device) -> list:
    """The flash forward and SDPA's forward at FWD_SHAPES, one row each.
    It calls only the port's public wrapper, so ``chip_ab.py`` times
    another checkout's forward with it too."""
    from tpu_task_torch.ml.ops import attention as fa

    F = torch.nn.functional
    timer = DeviceTimer(device)
    gen = torch.Generator(device=device).manual_seed(8)
    rows = []
    for b, h, s, d, causal in FWD_SHAPES:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=device,
                               dtype=torch.bfloat16) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rows.append(dict(
            b=b, h=h, s=s, d=d, causal=causal,
            ms=timer(lambda: fa.flash_attention(q, k, v, causal,
                                                return_lse=True)),
            sdpa_ms=timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))))
    return rows


def phase_flash_fwd_shapes(device, smi: str) -> None:
    """``fwd_shape_times`` with the CTAs and kv tile steps of the wgmma
    forward's schedule (``flash_fwd_tiles``), then a least-squares fit of
    the kernel's ms as a fixed cost per CTA plus a cost per tile step,
    each spread over the card's SMs (one CTA an SM)."""
    from tpu_task_torch.ml.ops import attention as fa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = fwd_shape_times(device)
    for row in rows:
        tiles = fa.flash_fwd_tiles(row["s"], row["s"], row["causal"], 0)
        heads = row["b"] * row["h"]
        row.update(ctas=len(tiles) * heads,
                   tile_steps=sum(t.n for t in tiles) * heads)
    d128 = [r for r in rows if r["d"] == 128]
    a = np.array([[r["ctas"] / sms, r["tile_steps"] / sms] for r in d128])
    us = np.array([r["ms"] * 1e3 for r in d128])
    (per_cta, per_step), *_ = np.linalg.lstsq(a, us, rcond=None)
    emit("flash_fwd_shapes", shapes=rows, sms=sms,
         fit_d128=dict(per_cta_us=float(per_cta),
                       per_tile_step_us=float(per_step),
                       worst_rel_err=float(np.max(np.abs(a @ [per_cta,
                                                               per_step]
                                                          - us) / us))),
         note="fit: ms x 1e3 = per_cta_us x ctas / sms + per_tile_step_us "
              "x tile_steps / sms over the d 128 shapes; one tile step is "
              "the two 128 x 128 x 128 products of both consumers, 1.12 us "
              "at 989 TFLOP/s over 132 SMs",
         gpu=smi)


def bwd_shape_times(device) -> list:
    """The flash backward pair (dq, then dk/dv) and SDPA's backward at
    FWD_SHAPES, one row each: the pair's ms, each kernel's, and SDPA's one
    backward call (dq, dk and dv). It calls only the port's public
    wrappers, so ``chip_ab.py`` times another checkout's pair with it
    too."""
    from tpu_task_torch.ml.ops import attention as fa

    F = torch.nn.functional
    timer = DeviceTimer(device)
    gen = torch.Generator(device=device).manual_seed(9)
    rows = []
    for b, h, s, d, causal in FWD_SHAPES:
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen,
                                   device=device, dtype=torch.bfloat16)
                       for _ in range(4))
        o, lse = fa.flash_attention(q, k, v, causal, return_lse=True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
        dot = do.transpose(1, 2).contiguous()

        def dq():
            return fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)

        def dkv():
            return fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)

        rows.append(dict(
            b=b, h=h, s=s, d=d, causal=causal,
            ms=timer(lambda: (dq(), dkv())), dq_ms=timer(dq),
            dkv_ms=timer(dkv),
            sdpa_bwd_ms=timer(lambda: torch.autograd.grad(
                out, (lq, lk, lv), dot, retain_graph=True))))
        del out
    return rows


def phase_flash_bwd_shapes(device, smi: str) -> None:
    """``bwd_shape_times`` with the CTAs and tile steps of each wgmma
    backward kernel's schedule (``flash_bwd_tiles``: dq's 128-row kv
    stages, dk/dv's 64-row q stages), then for each kernel a least-squares
    fit of its ms as a fixed cost per CTA plus a cost per tile step over
    the d 128 shapes, each spread over the card's SMs (one CTA an SM)."""
    from tpu_task_torch.ml.ops import attention as fa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = bwd_shape_times(device)
    for row in rows:
        tiles = fa.flash_bwd_tiles(row["s"], row["s"], row["causal"], 0)
        heads = row["b"] * row["h"]
        row.update(dq_ctas=len(tiles.dq) * heads,
                   dq_tile_steps=sum(t.n for t in tiles.dq) * heads,
                   dkv_ctas=len(tiles.dkv) * heads,
                   dkv_tile_steps=sum(t.end - t.begin for t in tiles.dkv)
                   * heads)
    d128 = [r for r in rows if r["d"] == 128]
    fits = {}
    for kernel in ("dq", "dkv"):
        a = np.array([[r[kernel + "_ctas"] / sms,
                       r[kernel + "_tile_steps"] / sms] for r in d128])
        us = np.array([r[kernel + "_ms"] * 1e3 for r in d128])
        (per_cta, per_step), *_ = np.linalg.lstsq(a, us, rcond=None)
        fits[kernel] = dict(
            per_cta_us=float(per_cta), per_tile_step_us=float(per_step),
            worst_rel_err=float(np.max(np.abs(a @ [per_cta, per_step] - us)
                                       / us)))
    emit("flash_bwd_shapes", shapes=rows, sms=sms, fit_d128=fits,
         note="fit: ms x 1e3 = per_cta_us x ctas / sms + per_tile_step_us "
              "x tile_steps / sms over the d 128 shapes; a dq tile step is "
              "both consumers' three 64 x 128 x 128 products (1.68 us at "
              "989 TFLOP/s over 132 SMs), a dk/dv step their four 64 x 64 "
              "x 128 products (1.12 us)",
         gpu=smi)


def flash_counts() -> dict:
    from tpu_task_torch.ml.ops import attention as fa

    return {"flash_fwd": fa.flash_attention.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
            "plain_fwd": fa.flash_attention_reference.launches,
            "plain_bwd": fa.flash_bwd_reference.launches,
            "plain_mha": fa.mha_reference.launches}


class PlainFlash(torch.autograd.Function):
    """``FlashAttention``'s wiring over the plain versions, on any device:
    the reference path of the train-parity phase."""

    @staticmethod
    def forward(ctx, q, k, v):
        from tpu_task_torch.ml.ops import attention as fa

        o, lse = fa.flash_attention_reference(q, k, v, True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        from tpu_task_torch.ml.ops import attention as fa

        q, k, v, o, lse = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        return fa.flash_bwd_reference(q, k, v, do, lse, delta, True)


#: (dtype, config, params' abs tolerance, loss and grad norm's relative
#: tolerance). fp32 at d 32 takes the fp32-core kernels: after three AdamW
#: steps (lr 3e-4) the parameters may differ by the last-bit gradient
#: differences of fp32 sums in another order, scaled by lr: 2e-5, as in the
#: CPU tests against JAX. bf16 at d 128 takes the tensor-core kernels, which
#: round p and ds to bf16 where the plain version keeps fp32: loss and grad
#: norm within 2^-10 relative (an all-bf16 attention and an fp32 one differ
#: by 3.3e-5 at this config on the CPU). Its parameters are not held element
#: by element: AdamW's first steps move a parameter whose gradient is near 0
#: by about lr whichever way that gradient's sign falls, so two right paths
#: differ there by up to 2 lr a step.
PARITY_TRAIN = (
    (torch.float32, dict(vocab_size=1024, d_model=256, n_layers=2,
                         n_heads=8, d_head=32, d_ff=512, n_kv_heads=4),
     2e-5, 1e-5),
    (torch.bfloat16, dict(vocab_size=1024, d_model=512, n_layers=2,
                          n_heads=4, d_head=128, d_ff=1024, n_kv_heads=2),
     None, 2.0 ** -10),
)


def phase_train_parity(device) -> None:
    from tpu_task_torch.ml import train
    from tpu_task_torch.ml.models import transformer
    from tpu_task_torch.ml.ops import attention as fa

    for dtype, config, param_atol, rtol in PARITY_TRAIN:
        cfg = transformer.TransformerConfig(dtype=dtype, **config)
        tokens = torch.randint(0, cfg.vocab_size, (4, 257),
                               generator=torch.Generator().manual_seed(5))
        tokens = tokens.to(device)

        def plain_attn(q, k, v):
            return PlainFlash.apply(q, transformer.expand_kv(k, cfg.n_heads),
                                    transformer.expand_kv(v, cfg.n_heads))

        runs = {}
        for path, attn_fn in (("kernels", None), ("plain", plain_attn)):
            state = train.init_state(torch.Generator().manual_seed(6), cfg,
                                     device=device)
            step = train.make_train_step(cfg, attn_fn=attn_fn)
            fa.reset_launch_counts()
            metrics = []
            for _ in range(3):
                state, m = step(state, tokens)
                metrics.append((m["loss"].item(), m["grad_norm"].item()))
            runs[path] = dict(metrics=metrics, counts=flash_counts(),
                              params=[p.detach().clone() for p in
                                      train._leaves(state.params)])
        kern, plain = runs["kernels"], runs["plain"]
        n = 3 * cfg.n_layers
        param_err = max((a - b).abs().max().item()
                        for a, b in zip(kern["params"], plain["params"]))
        rel = max(abs(a - b) / abs(b) for x, y in zip(kern["metrics"],
                                                      plain["metrics"])
                  for a, b in zip(x, y))
        ok = ((param_atol is None or param_err <= param_atol)
              and rel <= rtol
              and all(kern["counts"][name] == n for name in
                      ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
              and kern["counts"]["plain_fwd"] == kern["counts"]["plain_bwd"]
              == kern["counts"]["plain_mha"] == 0
              and plain["counts"]["flash_fwd"] == 0)
        emit("train_parity", ok=ok, config=config, tokens=[4, 257],
             dtype=str(dtype).replace("torch.", ""), steps=3,
             kernels_metrics=kern["metrics"], plain_metrics=plain["metrics"],
             max_param_abs_diff=param_err, max_metric_rel_diff=rel,
             kernel_counts=kern["counts"], plain_counts=plain["counts"],
             tolerance=(f"loss and grad norm {rtol} rel"
                        + ("" if param_atol is None
                           else f", params {param_atol} abs")))
        if not ok:
            raise AssertionError(f"{dtype} train step through the kernels "
                                 "differs from the plain versions")


class FlashRecorder:
    """Stands in for the flash kernels' uncounted launchers in
    ``tpu_task_torch.ml.ops.attention`` for one train step: passes every
    launch through and keeps a copy of the first launch's arguments of
    each kernel, outputs included (the forward of layer 0, the backward of
    the last layer), so the kernels' work in the step can be held against
    the plain versions after it."""

    NAMES = ("_launch_fwd", "_launch_dq", "_launch_dkv")

    def __init__(self, fa):
        self.fa, self.calls = fa, {}

    def __enter__(self):
        self.saved = {name: getattr(self.fa, name) for name in self.NAMES}
        for name, fn in self.saved.items():
            setattr(self.fa, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.fa, name, fn)

    def _wrap(self, name, fn):
        def recorded(*args):
            fn(*args)
            if name not in self.calls:
                self.calls[name] = [a.clone() if torch.is_tensor(a) else a
                                    for a in args]
        return recorded


def check_recorded(calls) -> dict:
    """Each recorded kernel output against the plain version run in fp32 on
    the same inputs, under phase 7's bf16 gate with its fp32 term scaled
    down to a tensor whose largest value is below 1 (the gradients of a
    token-mean loss are far below 1; at unit scale the term would pass
    anything)."""
    from tpu_task_torch.ml.ops import attention as fa

    q, k, v, causal, off, o, lse = calls["_launch_fwd"]
    ex_o, ex_lse = fa.flash_attention_reference(q.float(), k.float(),
                                                v.float(), causal, off)
    q, k, v, do, blse, delta, causal, off, dq = calls["_launch_dq"]
    dk, dv = calls["_launch_dkv"][-2:]
    exact = fa.flash_bwd_reference(q.float(), k.float(), v.float(),
                                   do.float(), blse, delta, causal, off)
    out = {}
    for name, got, ref, atol in (
            ("o", o, ex_o, FLASH_FWD_ATOL),
            ("lse", lse, ex_lse, FLASH_FWD_ATOL),
            ("dq", dq, exact[0], FLASH_BWD_ATOL),
            ("dk", dk, exact[1], FLASH_BWD_ATOL),
            ("dv", dv, exact[2], FLASH_BWD_ATOL)):
        big = ref.float().abs().max().item()
        out[name] = dict(ok=flash_gate(got, ref, atol * min(big, 1.0)),
                         max_abs_err_vs_fp32=(got.float() - ref)
                         .abs().max().item(),
                         max_abs_fp32=big)
    return out


def train_flops_per_step(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one optimizer step with the attention term
    causal-halved: the first convention of ``bench.py``'s
    ``_train_flops_per_step``, copied (matmuls forward x3; attention
    scaled by (s + 1) / 2s, the score entries a causal kernel executes)."""
    n_mm_layer = (2 * cfg.d_model * cfg.d_attn + 2 * cfg.d_model * cfg.d_kv
                  + 3 * cfg.d_model * cfg.d_ff)
    n_mm = cfg.n_layers * n_mm_layer + cfg.d_model * cfg.vocab_size
    mm_fwd = 2.0 * batch * seq * n_mm
    attn_fwd = cfg.n_layers * 4.0 * batch * seq * seq * cfg.d_attn
    return 3.0 * (mm_fwd + attn_fwd * (seq + 1) / (2.0 * seq))


def profile_step(step, state, tokens, wall_ms: float) -> dict:
    """One step under ``torch.profiler``: device time by kernel name (the
    top ten) and the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for name, start, end in device_events(prof):
        spans.append((start, end))
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    busy, last = 0.0, -math.inf
    for start, end in sorted(spans):            # union of kernel intervals
        if end > last:
            busy += end - max(start, last)
            last = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(profiled_step_wall_ms=wall, device_events=len(spans),
                device_busy_ms=busy / 1e3,
                device_idle_share=(1 - busy / 1e3 / wall) if spans else None,
                top_kernels_ms=[(name[:90], ms) for name, ms in top],
                timed_step_median_ms=wall_ms)


def phase_train(device, smi: str) -> dict:
    """The train path: the flagship at full width and depth, two warm-up
    steps, then ten timed steps on one batch, the flash launch counts set
    to 0 just before them and read just after."""
    from tpu_task_torch.ml import train
    from tpu_task_torch.ml.models import transformer
    from tpu_task_torch.ml.ops import attention as fa

    cfg = transformer.TransformerConfig(dtype=torch.bfloat16,
                                        **TRAIN_FLAGSHIP)
    state = train.init_state(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    n_params = sum(p.numel() for p in train._leaves(state.params))
    tokens = torch.randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), device=device,
        generator=torch.Generator(device=device).manual_seed(1))
    step = train.make_train_step(cfg)
    losses = []
    # The first warm-up step is recorded: layer 0's forward and the last
    # layer's backward are held against the plain versions after it.
    with FlashRecorder(fa) as recorder:
        state, m = step(state, tokens)
    losses.append(m["loss"])
    state, m = step(state, tokens)                            # warm-up
    losses.append(m["loss"])
    torch.cuda.synchronize()
    recorded = check_recorded(recorder.calls)
    recorder.calls.clear()                 # its copies stay out of the peak
    emit("train_step_check", ok=all(c["ok"] for c in recorded.values()),
         step=1, forward_layer=0, backward_layer=cfg.n_layers - 1,
         outputs=recorded,
         tolerance="2^-8*(|fp32 ref| + max|fp32 ref|) + the fp32 tolerance "
                   "x min(1, max|fp32 ref|)")
    if not all(c["ok"] for c in recorded.values()):
        raise AssertionError(f"flash kernels in the flagship train step "
                             f"disagree with the plain versions: {recorded}")
    step_ms, per_step = [], []
    # Peak memory of the timed steps, not of the check above.
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    for _ in range(10):
        before = flash_counts()
        t0 = time.perf_counter()
        state, m = step(state, tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = flash_counts()
        per_step.append({key: after[key] - before[key] for key in after})
        losses.append(m["loss"])
    counts = flash_counts()
    losses = [x.item() for x in losses]
    median_ms = float(np.median(step_ms))
    flops = train_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers, "plain_fwd": 0, "plain_bwd": 0,
            "plain_mha": 0}
    line = dict(
        params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ, dtype="bfloat16",
        master_weights="float32", warmup_steps=2, timed_steps=len(step_ms),
        step_ms=step_ms, step_ms_median=median_ms,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / median_ms * 1e3,
        flops_per_step=flops,
        mfu=flops / (median_ms / 1e3) / BF16_FLOPS,
        mfu_peak="989 TFLOP/s dense bf16 (H100 SXM data sheet)",
        losses=losses, launches_per_step=per_step[0],
        launches_every_step_as_expected=all(p == want for p in per_step),
        launches=counts,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, gpu=smi)
    emit("train", **line)
    finite = all(math.isfinite(x) for x in losses)
    if not (finite and losses[-1] < losses[0]
            and line["launches_every_step_as_expected"]):
        raise AssertionError(f"flagship train run failed its gates: {line}")
    emit("train_profile", **profile_step(step, state, tokens, median_ms),
         gpu=smi)
    return counts


# -- quantized KV: both paged kernels ------------------------------------------

#: (name, geometry) of the kernel_quant cases: the flagship's, and the head
#: dims and block sizes of the tiny and micro presets.
QUANT_GEOMETRIES = (("flagship", dict(h=8, kv=2, d=128, bs=16)),
                    ("d16", dict(h=8, kv=4, d=16, bs=8)),
                    ("d8", dict(h=4, kv=2, d=8, bs=4)))
#: Pool storage types; None is the model dtype (q's own).
KV_STORAGE = (None, "int8", "fp8", "int4")
PAGED_KERNELS = ("paged_decode", "paged_decode_pipelined")


def quant_args(gen, depths, *, w, h, kv, d, bs, max_blocks, q_dtype,
               kv_dtype, device) -> list:
    """``paged_case``'s inputs in fp32, the pools turned into ``kv_dtype``
    codes and scales by the port's ``quantize_blocks`` (None: pools in q's
    dtype, no scales), q in ``q_dtype``."""
    from tpu_task_torch.ml.serving import cache

    q, kp, vp, tables, pos = paged_case(
        gen, depths, w=w, h=h, kv=kv, d=d, bs=bs, max_blocks=max_blocks,
        dtype=torch.float32, device=device)
    if kv_dtype is None:
        return [q.to(q_dtype), kp.to(q_dtype), vp.to(q_dtype), tables, pos]
    code = cache.kv_code_dtype(kv_dtype)
    (kc, ks), (vc, vs) = (cache.quantize_blocks(p, code) for p in (kp, vp))
    return [q.to(q_dtype), kc, vc, tables, pos, ks, vs]


def paged_kernel(name: str):
    from tpu_task_torch.ml.ops import paged_attention as pa

    return {"paged_decode": pa.paged_decode_attention,
            "paged_decode_pipelined": pa.paged_decode_pipelined_attention}[name]


def same_bytes(a, b) -> bool:
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def storage_name(kv_dtype, q_dtype) -> str:
    return kv_dtype or str(q_dtype).replace("torch.", "")


def phase_kernel_quant(device) -> dict:
    """Both paged kernels against the plain version on the same codes, each
    also at forced split counts (``check_splits``): the tile kernel's
    quantized variants (its model-dtype ones are phase 3's) and the
    pipelined kernel over every storage type, its tensor-core path (bf16
    queries, d 128 and 16) and its scalar one (fp32 queries, d 8). One line
    per (kernel, storage, q dtype); returns each kernel's largest fp32
    error, the combine kernel's under ``"paged_decode_combine"``."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    gen = torch.Generator().manual_seed(5)
    rng = np.random.default_rng(5)
    flagship = QUANT_GEOMETRIES[0][1]
    cases = [(name, geo, 24, w, 2048, 2048 // geo["bs"])
             for name, geo in QUANT_GEOMETRIES for w in (1, 3)]
    cases += [(case, flagship, rows, w, depth, max_blocks)
              for case, rows, w, depth, max_blocks in KERNEL_CASES
              if case != "deep"]
    worst = {name: 0.0 for name in PAGED_KERNELS + ("paged_decode_combine",)}
    summary = {}
    for case, geo, rows, w, depth, max_blocks in cases:
        depths = [None if r % 6 == 5 else int(rng.integers(0, depth - w))
                  for r in range(rows)]
        depths[0] = depth - w                     # the deepest row
        for q_dtype in (torch.float32, torch.bfloat16):
            for kv_dtype in KV_STORAGE:
                args = quant_args(gen, depths, w=w, max_blocks=max_blocks,
                                  q_dtype=q_dtype, kv_dtype=kv_dtype,
                                  device=device, **geo)
                before = [a.clone() for a in args]
                same = pa.paged_reference_attention(*args)
                for kernel in PAGED_KERNELS:
                    if kernel == "paged_decode" and kv_dtype is None:
                        continue                  # phase 3's cases
                    got = paged_kernel(kernel)(*args)
                    torch.cuda.synchronize()
                    unchanged = all(same_bytes(a, b)
                                    for a, b in zip(before, args))
                    guarded = guarded_launch(
                        args, got, pipelined=kernel != "paged_decode")
                    err = (got.float() - same.float()).abs().max().item()
                    split = check_splits(args, kernel != "paged_decode")
                    line = dict(kernel=kernel, case=case, w=w, rows=rows,
                                storage=storage_name(kv_dtype, q_dtype),
                                q_dtype=str(q_dtype).replace("torch.", ""),
                                max_abs_err=err, inputs_unchanged=unchanged,
                                writes_only_out_and_repeats=guarded, **split)
                    if q_dtype == torch.float32:
                        ok = err <= FP32_ATOL
                        worst[kernel] = max(worst[kernel], err,
                                            split.get("split_max_abs_err", 0))
                        worst["paged_decode_combine"] = max(
                            worst["paged_decode_combine"],
                            split.get("combine_max_abs_err", 0))
                    else:
                        line.update(against_fp32_plain(got, args))
                        ok = line.pop("ok") and err <= 2e-2
                    ok = ok and unchanged and guarded
                    if not ok:
                        emit("kernel_quant", ok=False, **line)
                        raise AssertionError(f"{kernel} disagrees: {line}")
                    key = (kernel, line["storage"], line["q_dtype"])
                    agg = summary.setdefault(key, dict(
                        cases=0, max_abs_err=0.0, max_abs_err_vs_fp32=0.0,
                        stage_math=[]))
                    agg["cases"] += 1
                    if kernel == "paged_decode_pipelined":
                        path = (f"{case} w{w}: tensor cores"
                                if pa.pipelined_uses_tensor_cores(*args[:2])
                                else f"{case} w{w}: scalar")
                        if path not in agg["stage_math"]:
                            agg["stage_math"].append(path)
                    agg["max_abs_err"] = max(agg["max_abs_err"], err)
                    agg["max_abs_err_vs_fp32"] = max(
                        agg["max_abs_err_vs_fp32"],
                        line.get("max_abs_err_vs_fp32", err))
                    agg["splits_checked"] = sorted(
                        set(agg.get("splits_checked", []))
                        | set(split["splits"]))
                    for name in ("split_max_abs_err",
                                 "split_states_max_rel_err",
                                 "combine_max_abs_err"):
                        agg[name] = max(agg.get(name, 0.0), split[name])
    for (kernel, storage, q_dtype), agg in summary.items():
        emit("kernel_quant", ok=True, kernel=kernel, storage=storage,
             q_dtype=q_dtype, **agg,
             geometries=[name for name, _ in QUANT_GEOMETRIES],
             widths=[1, 3], serve_steps=["decode step", "chunk step"],
             tolerance=(f"{FP32_ATOL} vs the fp32 plain version"
                        if q_dtype == "float32" else
                        "2^-8*|fp32 ref| + 1e-5, and 2e-2 vs the bf16 plain "
                        "version"),
             writes_only_out_and_repeats=True, inputs_unchanged=True)
    return worst


def phase_timing_quant(device, smi: str) -> dict:
    """Both paged kernels over each storage type at the flagship decode
    shape (bf16 queries, depth 1024, tables 72 wide) at batch 1, 16 and 32
    and at the serve run's 144-row chunk step, beside the plain version,
    SDPA over the view dequantized to bf16 ahead of time (the
    dequantization is not in ``library_ms``), the bytes bound, each
    kernel's split plan and CTAs and its time at one split
    (``unsplit_ms``); then the pipelined kernel's int8 batch-16 wrapper
    calls traced apart into the split walk and the combine. Returns
    {kernel: {storage: {rows: row}}}."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    timer = DeviceTimer(device)
    gen = torch.Generator().manual_seed(6)
    rng = np.random.default_rng(6)
    out = {name: {} for name in PAGED_KERNELS}
    for kv_dtype in KV_STORAGE:
        storage = storage_name(kv_dtype, torch.bfloat16)
        for rows in TIMED_ROWS:
            args, library, n_bytes, flops = timed_case(gen, rng, rows,
                                                       kv_dtype, device)

            def plain():
                return pa.paged_reference_attention(*args)

            plain_ms, library_ms = timer(plain), timer(library)
            row_common = dict(
                shape=shape_name(rows), batch=rows,
                depth="ragged up to 1151" if rows == CHUNK_ROWS else 1024,
                q_dtype="bfloat16", storage=storage, plain_ms=plain_ms,
                library_ms=library_ms,
                library_note="SDPA over the gathered view already "
                             "dequantized to bf16; the dequantization is "
                             "not timed",
                **bound(n_bytes, flops), gpu=smi)
            for kernel in PAGED_KERNELS:
                fn = paged_kernel(kernel)
                got = fn(*args)
                check = against_fp32_plain(got, args)
                lib_err = (library().transpose(1, 2).float()
                           - got.float()).abs().max().item()
                if not check.pop("ok") or lib_err > 2e-2:
                    raise AssertionError(
                        f"{kernel} or SDPA yardstick disagrees at {storage} "
                        f"{shape_name(rows)}: {check}, SDPA {lib_err}")
                pipelined = kernel == "paged_decode_pipelined"
                splits = pa.planned_splits(args[0], args[1], args[3].shape[1],
                                           pipelined=pipelined)
                row = dict(kernel=kernel, splits=splits,
                           ctas=rows * args[1].shape[2] * splits,
                           ms=timer(lambda: fn(*args)),
                           unsplit_ms=unsplit_ms(timer, args, pipelined),
                           host_ms=host_ms(lambda: fn(*args)),
                           library_max_abs_diff=lib_err, **check,
                           **row_common)
                if pipelined:
                    row["tensor_cores"] = pa.pipelined_uses_tensor_cores(
                        *args[:2])
                row["fraction_of_bound"] = row["bound_ms"] / row["ms"]
                emit("timing_quant", **row)
                out[kernel].setdefault(storage, {})[rows] = row
                if pipelined and rows == 16 and kv_dtype == "int8":
                    profile_wrapper(timer, lambda: fn(*args), row, smi,
                                    name=kernel)
    return out


#: The INT8_PIN geometry of ``tests/test_paged_attention.py``: its model
#: and engine configuration.
INT8_PIN = dict(vocab_size=128, d_model=128, n_layers=2, n_heads=4,
                d_head=16, d_ff=256, n_kv_heads=2)
INT8_PIN_SERVING = dict(slots=3, block_size=4, n_blocks=32, max_len=48,
                        chunk_tokens=6)


def parity_engines(preset: str, serving: dict, device):
    """An fp32 engine of a preset (``build_engine``) or of the INT8_PIN
    geometry (random weights from a seeded torch Generator)."""
    from tpu_task_torch.ml.models import transformer
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine
    from tpu_task_torch.serve.replica import build_engine

    if preset != "int8_pin":
        return build_engine(preset, serving=serving, device=device)
    cfg = transformer.TransformerConfig(dtype=torch.float32, **INT8_PIN)
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    return ServingEngine(params, cfg,
                         ServingConfig(**{**INT8_PIN_SERVING, **serving}),
                         device=device)


def phase_parity_quant(device) -> None:
    """For each kv_dtype, the engine's streams through both kernels and
    the plain version are equal, with the prefix cache, copy-on-write and
    (with the small pool) preemption; each fused step launches its
    kernel once per layer and nothing else."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    for preset, small in (("micro", 14), ("tiny", 8), ("int8_pin", 12)):
        for kv_dtype in ("int8", "fp8", "int4"):
            for n_blocks in (None, small):
                outs, stats = {}, {}
                for impl in ("cuda", "pipelined", "reference"):
                    serving = {"decode_impl": impl, "kv_dtype": kv_dtype}
                    if n_blocks:
                        serving["n_blocks"] = n_blocks
                    engine = parity_engines(preset, serving, device)
                    waves = _parity_waves(engine.cfg.vocab_size,
                                          engine.scfg.block_size)
                    pa.reset_launch_counts()
                    for wave in waves:
                        for prompt, max_new, kw in wave:
                            engine.submit(prompt, max_new, **kw)
                        outs[impl] = engine.drain(max_steps=5000)
                    stats[impl] = s = engine.stats()
                    fused = engine.chunk_steps + engine.decode_steps
                    want = {name: 0 for name in s["attention_launches"]}
                    want[impl] = engine.cfg.n_layers * fused
                    if s["attention_launches"] != want:
                        raise AssertionError(
                            f"{preset}/{kv_dtype}/{impl}: launches "
                            f"{s['attention_launches']}, expected {want}")
                if not outs["cuda"] == outs["pipelined"] == outs["reference"]:
                    raise AssertionError(f"{preset}/{kv_dtype}: streams differ "
                                         "between the kernels and the plain "
                                         "version")
                s = stats["pipelined"]
                if n_blocks and not s["recompute_preemptions"]:
                    raise AssertionError(f"{preset}/{kv_dtype}: the small "
                                         "pool never preempted")
                if not n_blocks and not s["prefix_cache"]["cow_copies"]:
                    raise AssertionError(f"{preset}/{kv_dtype}: no "
                                         "copy-on-write")
                emit("parity_quant", ok=True, preset=preset,
                     kv_dtype=kv_dtype,
                     n_blocks=n_blocks or engine.scfg.n_blocks,
                     requests=len(outs["cuda"]),
                     impls=["cuda", "pipelined", "reference"],
                     preemptions=s["recompute_preemptions"],
                     prefix_hit_requests=s["prefix_cache"]["hit_requests"],
                     cow_copies=s["prefix_cache"]["cow_copies"],
                     quantized_block_writes=s["kv_quant"][
                         "quantized_block_writes"],
                     chunk_steps=s["chunk_steps"],
                     decode_steps=s["decode_steps"])


def main() -> int:
    smi = phase_device()
    import_port()
    device = torch.device("cuda")
    phase_build()
    fwd_build = phase_flash_fwd_build()
    bwd_build = phase_flash_bwd_build()
    max_err, combine_err = phase_kernel(device)
    timing = phase_timing(device, smi)
    phase_parity(device)
    launches, combine_launches = phase_serve(device, smi)
    flash_err = phase_flash_kernel(device)
    flash_times = phase_flash_timing(device, smi)
    phase_flash_fwd_shapes(device, smi)
    phase_flash_bwd_shapes(device, smi)
    phase_train_parity(device)
    train_counts = phase_train(device, smi)
    quant_err = phase_kernel_quant(device)
    quant_times = phase_timing_quant(device, smi)
    phase_parity_quant(device)
    pipelined_launches, pipelined_combines = phase_serve_quant(device, smi)
    micro, traced = phase_serve_micro(device, smi)
    phase_serve_trace(traced, smi)
    del traced
    micro_quant = phase_serve_micro_quant(device, smi)

    def micro_launches(lines: dict, key: str) -> dict:
        return {f"micro_k_{k}": line[key] for k, line in lines.items()}

    def by_storage(kernel: str) -> dict:
        return {storage: {key: rows[16][key] for key in (
                    "ms", "plain_ms", "bound_ms", "library_ms")}
                for storage, rows in quant_times[kernel].items()}

    int8 = quant_times["paged_decode_pipelined"]["int8"][16]
    int8_chunk = quant_times["paged_decode_pipelined"]["int8"][CHUNK_ROWS]
    batch16, combine = timing[16], timing["combine"]
    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "tpu_task_torch/csrc/paged_decode.cu",
        "replaces": "tpu_task/ml/ops/paged_attention.py:175",
        "launches": launches,
        "max_abs_err": max(max_err, quant_err["paged_decode"]),
        "ms": batch16["ms"], "plain_ms": batch16["plain_ms"],
        "bound_ms": batch16["bound_ms"], "bound_by": batch16["bound_by"],
        "library_ms": batch16["library_ms"],
        "splits_batch16": batch16["splits"],
        "unsplit_ms": batch16["unsplit_ms"],
        "chunk_step_ms": timing[CHUNK_ROWS]["ms"],
        "chunk_step_splits": timing[CHUNK_ROWS]["splits"],
        "chunk_step_unsplit_ms": timing[CHUNK_ROWS]["unsplit_ms"],
        "by_storage_batch16": by_storage("paged_decode"),
        "launches_serve_micro": micro_launches(micro, "kernel_launches")}]
    for name, line in (("flash_fwd", 186), ("flash_bwd_dq", 344),
                       ("flash_bwd_dkv", 394)):
        row = flash_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tpu_task_torch/csrc/flash_attention.cu",
            "replaces": f"tpu_task/ml/ops/attention.py:{line}",
            "launches": train_counts[name], "max_abs_err": flash_err[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "fraction_of_bound": row["fraction_of_bound"]})
        # B1, B2 and B3 v3: wgmma fed by TMA rings
        build = fwd_build if name == "flash_fwd" else bwd_build[name]
        kernels[-1].update(version="v3", kernel=f"{name}_wgmma_kernel",
                           registers_d128=build[128]["registers"],
                           ctas_per_sm_d128=build[128]["ctas_per_sm"])
    kernels.append({
        "name": "paged_decode_pipelined", "route": "cuda",
        "source": "tpu_task_torch/csrc/paged_decode_pipelined.cu",
        "replaces": "tpu_task/ml/ops/paged_attention.py:339",
        "launches": pipelined_launches,
        "max_abs_err": quant_err["paged_decode_pipelined"],
        "ms": int8["ms"], "plain_ms": int8["plain_ms"],
        "bound_ms": int8["bound_ms"], "bound_by": int8["bound_by"],
        "library_ms": int8["library_ms"], "storage": "int8",
        "splits_batch16": int8["splits"], "unsplit_ms": int8["unsplit_ms"],
        "tensor_cores": int8["tensor_cores"],
        "chunk_step_ms": int8_chunk["ms"],
        "chunk_step_splits": int8_chunk["splits"],
        "chunk_step_unsplit_ms": int8_chunk["unsplit_ms"],
        "by_storage_batch16": by_storage("paged_decode_pipelined"),
        "launches_serve_micro_quant": micro_launches(micro_quant,
                                                     "kernel_launches")})
    # The split walk's second pass: the merge that _paged_decode_kernel's
    # _finalize does at the end of its sequential block axis.
    kernels.append({
        "name": "paged_decode_combine", "route": "cuda",
        "source": "tpu_task_torch/csrc/paged_kv.cuh",
        "replaces": "tpu_task/ml/ops/paged_attention.py:252",
        "launches": combine_launches,
        "launches_after_pipelined": pipelined_combines,
        "launches_serve_micro": micro_launches(micro, "combine_launches"),
        "launches_serve_micro_quant": micro_launches(micro_quant,
                                                     "combine_launches"),
        "max_abs_err": max(combine_err, quant_err["paged_decode_combine"]),
        "ms": combine["ms"], "plain_ms": combine["plain_ms"],
        "bound_ms": combine["bound_ms"], "bound_by": combine["bound_by"],
        "library_ms": None, "splits": combine["splits"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
