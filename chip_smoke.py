#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_task_torch``) on one NVIDIA
card: builds the port's CUDA kernels from this checkout, holds each against
its plain PyTorch version, times it, and drives the paged serving engine at
the flagship model's full width.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the
script exits non-zero:

1. device  — the card's name and power limit; TF32 off for the fp32 phases.
2. build   — nvcc for every kernel source, with ptxas's report.
3. kernel  — the paged-decode kernel against its plain version at the
             flagship geometry (kv 2, group 4, d 128, block 16): fragmented
             shuffled tables, ragged depths, inactive rows, fp32 and bf16;
             24 rows of widths 1 and 3 up to depth 2048, and the serve
             run's 16-row decode and 144-row chunk steps (tables 72 wide).
             Each case also launches into a NaN-guarded buffer to show the
             kernel writes its output and nothing beside it.
4. timing  — kernel, plain version and SDPA over the gathered view
             (``library_ms``, a yardstick the port never calls) at batch 1,
             16 and 32, depth 1024, beside the memory bound; the kernel is
             held against the plain version there too.
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
             kernel. Layer 0's attention in the first decode step and the
             last chunk step of the first wave is held against the plain
             version on the same inputs.

Then the kernel table as one JSON line, the ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout of the repository, it exits non-zero before any result."""

from __future__ import annotations

import json
import subprocess
import sys
import time
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


def phase_build() -> None:
    from tpu_task_torch.ml.ops import _build

    t0 = time.perf_counter()
    for name in _build.SIGNATURES:
        _build.load(name)
    report = {name: [line.strip() for line in output.splitlines()
                     if "registers" in line or "spill" in line]
              for name, output in _build.compiler_output.items()}
    emit("build", seconds=time.perf_counter() - t0,
         libraries=sorted(_build.SIGNATURES), ptxas=report)


def against_fp32_plain(got, args) -> dict:
    """Hold a bf16 kernel output to the plain version run in fp32 on the
    same bf16 values. The kernel works in fp32 and rounds only its output
    to bf16, so each element must lie within half an ulp (2^-8 relative)
    of that, plus 1e-5 for fp32 summation order."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    exact = pa.paged_reference_attention(
        args[0].float(), args[1].float(), args[2].float(), *args[3:])
    err = (got.float() - exact).abs()
    excess = (err - 2.0 ** -8 * exact.abs() - 1e-5).max().item()
    return dict(ok=excess <= 0, max_abs_err_vs_fp32=err.max().item(),
                tolerance_vs_fp32="2^-8*|ref| + 1e-5: the output's bf16 "
                                  "rounding")


def guarded_launch(args, want) -> bool:
    """Launch the kernel (uncounted) into the middle of a NaN-filled
    buffer: True if it wrote exactly ``want`` there and nothing on either
    side."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    q, n, pad = args[0], args[0].numel(), 1 << 18
    buf = torch.full((n + 2 * pad,), float("nan"), dtype=q.dtype,
                     device=q.device)
    out = buf[pad:pad + n].view(q.shape)
    pa._launch(*args, out)
    torch.cuda.synchronize()
    return bool(torch.isnan(buf[:pad]).all() and torch.isnan(buf[-pad:]).all()
                and torch.equal(out, want))


#: (what the case stands for, rows, w, deepest position + w, max_blocks).
#: The last two are the flagship serve run's shapes: its 16-row decode step
#: and its 144-row token-packed chunk step, tables of max_len 1152 / 16.
KERNEL_CASES = (("deep", 24, 1, 2048, 128), ("deep", 24, 3, 2048, 128),
                ("decode step", 16, 1, 1152, 72),
                ("chunk step", 144, 1, 1152, 72))


def phase_kernel(device) -> float:
    """Kernel vs plain version; returns the largest error against the
    plain version run at the kernel's own dtype."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)
    worst = 0.0
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
            worst = max(worst, err)
            line = dict(case=case, w=w, dtype=str(dtype).replace("torch.", ""),
                        rows=rows, max_blocks=max_blocks,
                        inactive_rows=depths.count(None), max_abs_err=err,
                        writes_only_out_and_repeats=guarded)
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
    return worst


def phase_timing(device, smi: str) -> dict:
    """Kernel, plain and SDPA times at the flagship decode shape; returns
    the batch-16 row (the flagship engine's slot count)."""
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import flat_pool, gather_kv

    F = torch.nn.functional
    timer = DeviceTimer(device)
    gen = torch.Generator().manual_seed(2)
    rows_out = {}
    depth, bs, h, kv, d = 1024, 16, 8, 2, 128
    for batch in (1, 16, 32):
        # max_blocks 72 = the flagship engine's max_len 1152 / block 16.
        args = paged_case(gen, [depth - 1] * batch, max_blocks=72,
                          dtype=torch.bfloat16, device=device)
        q, kp, vp, tables, pos = args
        live = tables[:, :depth // bs]
        kd = gather_kv(flat_pool(kp), live, bs).transpose(1, 2).contiguous()
        vd = gather_kv(flat_pool(vp), live, bs).transpose(1, 2).contiguous()
        qd = q.transpose(1, 2).contiguous()          # (b, h, 1, d)

        def kernel():
            return pa.paged_decode_attention(*args)

        def plain():
            return pa.paged_reference_attention(*args)

        def library():
            return F.scaled_dot_product_attention(qd, kd, vd, enable_gqa=True)

        got = kernel()
        check = against_fp32_plain(got, args)
        lib_err = (library().transpose(1, 2).float()
                   - got.float()).abs().max().item()
        if not check.pop("ok") or lib_err > 2e-2:
            raise AssertionError(f"kernel or SDPA yardstick disagrees at "
                                 f"batch {batch}: {check}, SDPA {lib_err}")
        itemsize = q.element_size()
        n_bytes = (batch * depth * kv * d * 2 * itemsize      # live K and V
                   + 2 * q.numel() * itemsize                  # q in, out
                   + batch * (depth // bs) * 4 + pos.numel() * 4)
        flops = 4 * batch * h * depth * d
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        row = dict(batch=batch, depth=depth, dtype="bfloat16",
                   ms=timer(kernel), plain_ms=timer(plain),
                   library_ms=timer(library), bound_ms=bound_ms,
                   bound_by="bytes" if n_bytes / HBM_BYTES_PER_S
                   >= flops / BF16_FLOPS else "operations",
                   bytes=n_bytes, flops=flops,
                   host_ms=host_ms(kernel), plain_host_ms=host_ms(plain),
                   library_max_abs_diff=lib_err, **check, gpu=smi)
        row["fraction_of_bound"] = bound_ms / row["ms"]
        emit("timing", **row)
        rows_out[batch] = row
    return rows_out[16]


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


def _submit_wave(engine, seed: int):
    """16 requests of 256-1024 prompt tokens and 64 new tokens: 12
    greedy, 4 sampled at temperature 0.8 / top_p 0.9 with raw keys."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(256, 1025, size=16)
    rids = []
    for i, n in enumerate(lengths):
        prompt = rng.integers(0, engine.cfg.vocab_size, size=int(n))
        kw = ({"temperature": 0.8, "top_p": 0.9,
               "key": np.array([1000 + 100 * seed + i, i], np.uint32)}
              if i % 4 == 3 else {})
        rids.append(engine.submit(prompt, 64, **kw))
    return rids, int(lengths.sum())


def _timed_drain(engine, seed: int) -> dict:
    """One wave through the engine, its launch counts set to 0 just before
    and read just after."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    rids, prompt_tokens = _submit_wave(engine, seed)
    chunk0, decode0 = engine.chunk_steps, engine.decode_steps
    preempt0 = engine.preemption_count
    decode_ms, chunk_ms = [], []
    pa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.has_work:
        chunks, s0 = engine.chunk_steps, time.perf_counter()
        engine.step()
        (chunk_ms if engine.chunk_steps > chunks else decode_ms).append(
            (time.perf_counter() - s0) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.paged_decode_attention.launches
    plain = pa.paged_reference_attention.launches
    results = [engine.request(rid) for rid in rids]
    generated = sum(len(r.tokens) for r in results)
    fused = engine.chunk_steps - chunk0 + engine.decode_steps - decode0
    return dict(
        seed=seed, requests=len(results), prompt_tokens=prompt_tokens,
        generated_tokens=generated, wall_s=wall,
        tokens_per_s=generated / wall,
        prompt_and_generated_tokens_per_s=(generated + prompt_tokens) / wall,
        decode_steps=engine.decode_steps - decode0,
        chunk_steps=engine.chunk_steps - chunk0,
        mean_decode_step_ms=float(np.mean(decode_ms)) if decode_ms else None,
        mean_chunk_step_ms=float(np.mean(chunk_ms)),
        kernel_launches=launches, plain_launches=plain,
        expected_launches=engine.cfg.n_layers * fused,
        all_finished=all(r.status == "done" and len(r.tokens) == 64
                         for r in results),
        preemptions=engine.preemption_count - preempt0)


def phase_serve(device, smi: str) -> int:
    """The main path: a warm-up wave, then three timed waves of fresh
    prompts. Returns the kernel's launch count over the timed waves."""
    from tpu_task_torch.ml.models import transformer
    from tpu_task_torch.ml.serving import model as serving_model
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine

    cfg = transformer.TransformerConfig(dtype=torch.bfloat16, **FLAGSHIP)
    params = transformer.init(
        torch.Generator(device=device).manual_seed(0), cfg)
    n_params = sum(p.numel() for p in params.values() if torch.is_tensor(p))
    n_params += sum(p.numel() for layer in params["layers"]
                    for p in layer.values())
    scfg = ServingConfig(slots=16, block_size=16, chunk_tokens=128,
                         max_len=1152, n_blocks=16 * 72 + 1)
    engine = ServingEngine(params, cfg, scfg, device=device)
    # Warm-up: bf16 GEMMs at the chunk and decode row counts, the sampler,
    # and the allocator's growth, outside the timed waves.
    rng = np.random.default_rng(99)
    engine.submit(rng.integers(0, cfg.vocab_size, size=300), 4)
    engine.submit(rng.integers(0, cfg.vocab_size, size=200), 4,
                  temperature=0.8, top_p=0.9, key=np.array([5, 6], np.uint32))
    engine.drain()

    # Every fused step's logits must be finite: checked on the card, with
    # no host sync, by wrapping the step the engine's samplers call.
    finite = torch.ones((), dtype=torch.bool, device=device)
    step_fn, attn_fn = serving_model.paged_decode_step, \
        serving_model.paged_attention
    recorder = StepRecorder(attn_fn, cfg.n_layers, scfg.slots)

    def checked_step(*args, **kwargs):
        logits = step_fn(*args, **kwargs)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits

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
        emit("serve_wave", **run, gpu=smi)

    # The kernel's output in the run against the plain version.
    steps_ok = True
    for kind, (args, out) in sorted(recorder.steps.items()):
        pos = args[4]
        check = against_fp32_plain(out, args)
        steps_ok = steps_ok and check["ok"]
        emit("serve_step_check", step=kind, layer=0, rows=int(pos.shape[0]),
             deepest_position=int(pos.max()), **check)
    launches = sum(r["kernel_launches"] for r in runs)
    line = dict(
        params=n_params, waves=len(runs),
        tokens_per_s_median=float(np.median(
            [r["tokens_per_s"] for r in runs])),
        tokens_per_s_runs=[r["tokens_per_s"] for r in runs],
        mean_decode_step_ms_median=float(np.median(
            [r["mean_decode_step_ms"] for r in runs])),
        mean_chunk_step_ms_median=float(np.median(
            [r["mean_chunk_step_ms"] for r in runs])),
        kernel_launches=launches,
        plain_launches=sum(r["plain_launches"] for r in runs),
        steps_checked=sorted(recorder.steps), logits_finite=bool(finite),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, gpu=smi)
    emit("serve", **line)
    if not (bool(finite) and steps_ok and len(recorder.steps) == 2
            and all(r["all_finished"] and r["plain_launches"] == 0
                    and r["kernel_launches"] == r["expected_launches"] > 0
                    for r in runs)):
        raise AssertionError(f"flagship serving run failed its gates: {line}")
    return launches


def main() -> int:
    smi = phase_device()
    import_port()
    device = torch.device("cuda")
    phase_build()
    max_err = phase_kernel(device)
    timing = phase_timing(device, smi)
    phase_parity(device)
    launches = phase_serve(device, smi)
    print(json.dumps({"kernels": [{
        "name": "paged_decode", "route": "cuda",
        "source": "tpu_task_torch/csrc/paged_decode.cu",
        "replaces": "tpu_task/ml/ops/paged_attention.py:175",
        "launches": launches, "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
