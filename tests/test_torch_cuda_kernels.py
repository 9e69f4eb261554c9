"""The port's CUDA kernels on the card, against their plain versions: the
two paged-decode kernels (over model-dtype and quantized pools), each
one's split-KV walk and its combine kernel, and the three flash-attention
kernels of training; the serving engine's K-step loop captured as a
CUDA graph through the paged kernels; and both paged kernels at the
speculative scoring widths, with a spec engine's target and draft steps
through them; a drained engine's requests resumed through both; and a
weight roll at micro_k 4, each generation with its own graphs; paged
LoRA adapters evicted and reloaded from a bucket under those graphs; and
a replica's graphs replayed from the thread a profiler capture hands its
step loop to; an overlapped drain through each kernel that waits for the
device only at its consume edge, and the host tier's demotion and
promotion with a program in flight, waiting for nothing; the ``moe``
preset's MoE layers through each kernel. Then
the train path's card work beside the kernels: ``AsyncCheckpointer``'s
device snapshot and ``prefetch_to_device``'s pinned side-stream copies.

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
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.serve.replica import SERVING_PRESETS, build_engine

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
def test_profile_hand_over_replays_the_graphs_on_the_new_thread(
        cuda_device, tmp_path):
    """A replica at micro_k 4 through the tile kernel captures both K-step
    graphs (greedy, sampled) on its first step-loop thread; a ``/profile``
    capture moves the step loop to a new thread, where the same graphs
    replay with no capture again, the streams equal a direct engine's, the
    trace names the tile kernel's walk, and nothing fails."""
    import json
    import time
    from pathlib import Path

    from tpu_task_torch.serve.replica import ReplicaServer

    serving = {"decode_impl": "cuda", "micro_k": 4}
    greedy = {"prompt": list(range(1, 30)), "max_new_tokens": 24}
    sampled = {"prompt": list(range(5, 14)), "max_new_tokens": 20,
               "temperature": 0.8, "key": [4, 5]}
    bodies = [greedy, sampled,
              {"prompt": list(range(40, 57)), "max_new_tokens": 16}]
    direct = build_engine("tiny", serving=serving, device=cuda_device)
    ids = [direct.submit(b["prompt"], b["max_new_tokens"],
                         temperature=b.get("temperature", 0.0),
                         key=b.get("key")) for b in bodies]
    out = direct.drain()
    want = [out[i] for i in ids]
    replica = ReplicaServer(preset="tiny", serving=serving,
                            profile_dir=str(tmp_path)).start()

    def wave(wave_bodies):
        rids = [replica.submit(b) for b in wave_bodies]
        deadline = time.monotonic() + 120
        for rid in rids:
            got = replica.stream(rid, 0, wait_ms=2000)
            while got["status"] != "done":
                assert not got["draining"], replica.step_error
                assert time.monotonic() < deadline, "a stream stalled"
                got = replica.stream(rid, 0, wait_ms=2000)
        return [replica.stream(rid, 0)["tokens"] for rid in rids]

    try:
        wave([greedy])                   # each program alone: both captured
        wave([sampled])
        assert wave(bodies) == want
        first = replica._step_thread
        graphs = replica.engine.stats()["step_graph"]
        runner = replica.engine._micro_graphs[0]
        captured = dict(runner._graphs)
        assert graphs["captures"] == len(captured) == 2
        reply = replica.profile(500)
        assert reply is not None
        waves, deadline = [], time.monotonic() + 120
        while replica._profile_thread.is_alive():
            assert time.monotonic() < deadline, "the capture never ended"
            waves.append(wave(bodies))
        replica._profile_thread.join(timeout=60)
        assert waves and all(w == want for w in waves)
        assert replica._step_thread is not first and not first.is_alive()
        after = replica.engine.stats()["step_graph"]
        assert runner._graphs == captured and after["captures"] == 2
        assert after["replays"] > graphs["replays"]
        events = json.loads((Path(reply["dir"]) / "trace-cuda.json")
                            .read_text())["traceEvents"]
        assert any("paged_decode_kernel" in e.get("name", "")
                   for e in events if e.get("cat") == "kernel")
        assert replica.step_error is None and not replica.draining
    finally:
        replica.stop()


def _sync_checked(engine):
    """Run ``engine``'s overlap dispatch region (planning, reservation and
    the dispatch of the next program) under
    ``torch.cuda.set_sync_debug_mode("error")``: any wait for the device in
    it raises."""
    dispatch = engine._dispatch_next

    def checked(finished):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(finished)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    engine._dispatch_next = checked


@pytest.mark.cuda
@pytest.mark.parametrize("micro_k", [1, 4])
@pytest.mark.parametrize("impl", ["cuda", "pipelined"])
def test_overlapped_drain_equals_sync_and_waits_only_at_consume(
        cuda_device, impl, micro_k):
    """The tiny preset at fp32 through each kernel, overlapped: a first
    drain captures the carry graphs; the second, of the same traffic, runs
    its dispatch region under the sync debug mode and equals the
    synchronous engine's drain token for token, with launches those of its
    programs (n_layers a chunk program, n_layers x K a micro program)."""
    waves = [(np.arange(1, 30), 9, {"eos_token": 3}),
             (np.arange(5, 14), 6, {"temperature": 0.8, "key": [4, 5]}),
             (np.arange(2, 4), 11, {}), (np.arange(40, 57), 2, {}),
             (np.arange(7, 19), 12, {"temperature": 1.1, "key": [8, 1]})]
    outs = {}
    for overlap in (False, True):
        engine = build_engine("tiny", serving={
            "decode_impl": impl, "micro_k": micro_k, "overlap": overlap},
            device=cuda_device)
        for checked in (False, True):
            if checked and overlap:
                _sync_checked(engine)
            tpa.reset_launch_counts()
            chunk0, decode0 = engine.chunk_steps, engine.decode_steps
            micro0 = engine.micro_steps
            rids = [engine.submit(prompt, max_new, **kw)
                    for prompt, max_new, kw in waves]
            engine.drain()
            outs[overlap, checked] = [engine.result(r) for r in rids]
        micro = engine.micro_steps - micro0
        calls = (engine.chunk_steps - chunk0 + engine.decode_steps
                 - decode0 + (micro_k - 1) * micro)
        launches = engine.stats()["attention_launches"]
        assert launches[impl] == engine.cfg.n_layers * calls > 0
        assert launches["reference"] == 0
    assert outs[True, True] == outs[True, False] == outs[False, True] \
        == outs[False, False]
    stats = engine.stats()
    assert stats["overlap"] and stats["goodput"]["overlapped_host_s"] > 0
    assert stats["step_graph"]["replays"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("micro_k", [1, 4])
@pytest.mark.parametrize("impl,kv_dtype", [("cuda", None),
                                           ("pipelined", "int8")])
def test_moe_preset_runs_the_kernels(cuda_device, impl, kv_dtype, micro_k):
    """The ``moe`` preset (a MoE layer of 4 experts, top-1) at fp32
    through each kernel: a synchronous and an overlapped engine (its
    second drain under the sync debug mode, so the dense expert dispatch
    reads nothing back inside the dispatch region) equal the plain route
    on the card token for token, every launch through the kernel; the
    dispatch on the card equals the CPU's within 1e-5."""
    from tpu_task_torch.ml.models import moe

    waves = [(np.arange(1, 20), 9, {}),
             (np.arange(5, 14), 6, {"temperature": 0.8, "key": [4, 5]}),
             (np.arange(2, 4), 11, {"eos_token": 3}),
             (np.arange(30, 47), 8, {"temperature": 1.1, "key": [8, 1]})]
    outs = {}
    for route, overlap in ((impl, False), (impl, True),
                           ("reference", False)):
        engine = build_engine("moe", serving={
            "decode_impl": route, "kv_dtype": kv_dtype, "micro_k": micro_k,
            "overlap": overlap}, device=cuda_device)
        for checked in (False, True):
            if checked and overlap:
                _sync_checked(engine)
            tpa.reset_launch_counts()
            rids = [engine.submit(prompt, max_new, **kw)
                    for prompt, max_new, kw in waves]
            engine.drain()
            outs[route, overlap, checked] = [engine.result(r) for r in rids]
        launches = engine.stats()["attention_launches"]
        assert launches[route] > 0
        assert sum(launches.values()) == launches[route]
    tpa.reset_launch_counts()       # the counters are process-wide
    want = outs["reference", False, False]
    assert all(out == want for out in outs.values())
    cfg, layer = engine.cfg, engine.params["layers"][1]
    h = torch.randn((2, 9, cfg.d_model), device=cuda_device)
    got, aux = moe.apply_dense(layer, cfg.moe_cfg, h)
    ref, ref_aux = moe.apply_dense(
        {k: v.cpu() for k, v in layer.items()}, cfg.moe_cfg, h.cpu())
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(aux.cpu(), ref_aux, rtol=0, atol=1e-5)


def _tier_sessions(engine, base: int, n_sessions: int = 8, turns: int = 3):
    """Multi-turn sessions (``tests/test_kv_tiering.py``'s shape on the
    tiny preset): each turn resubmits every session's whole context for
    4, 7 or 10 new tokens, so slots retire apart."""
    ctxs = [list(range(base + s, base + s + 16)) for s in range(n_sessions)]
    streams = []
    for t in range(turns):
        rids = [engine.submit(np.asarray(c), 4 + 3 * (s % 3))
                for s, c in enumerate(ctxs)]
        out = engine.drain()
        streams.append([out[r] for r in rids])
        for s, r in enumerate(rids):
            ctxs[s] += out[r] + [(3 * s + 7 * t) % 200 + 1]
    return streams


@pytest.mark.cuda
@pytest.mark.parametrize("micro_k", [1, 4])
def test_tier_migration_waits_for_nothing_with_a_program_in_flight(
        cuda_device, micro_k):
    """The tiny preset at fp32 through the tile kernel, overlapped, on a
    12-block pool with a 64-block host tier. After a first pass captures
    the carry graphs, a second pass runs every dispatch, demote pass,
    force and promotion import under ``set_sync_debug_mode("error")``:
    none raises, each moved blocks while a program was in flight, and the
    streams equal a pressure-free engine's."""
    knobs = {"decode_impl": "cuda", "micro_k": micro_k, "slots": 2,
             "max_len": 64}
    engine = build_engine("tiny", device=cuda_device, serving=dict(
        knobs, n_blocks=12, host_offload_blocks=64, overlap=True))
    free = build_engine("tiny", device=cuda_device, serving=knobs)
    _tier_sessions(engine, 1)
    _tier_sessions(free, 1)
    in_flight = [None]
    dispatch = engine._dispatch_next

    def dispatched(finished):
        in_flight[0] = dispatch(finished)
        return in_flight[0]

    engine._dispatch_next = dispatched
    moved = {}
    for name in ("_dispatch_next", "_demote_pass", "_finalize_demotions",
                 "_import_hash_chain"):
        inner = getattr(engine, name)
        moved[name] = 0

        def checked(*args, inner=inner, name=name):
            before = (engine.demoted_blocks, len(engine._pending_demotions))
            live = (engine._inflight if name in (
                "_dispatch_next", "_import_hash_chain") else in_flight[0]) \
                is not None
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = inner(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            did = (bool(out) if name == "_import_hash_chain" else
                   name == "_dispatch_next" and out is not None or
                   (engine.demoted_blocks,
                    len(engine._pending_demotions)) != before)
            moved[name] += int(did and live)
            return out

        setattr(engine, name, checked)
    got = _tier_sessions(engine, 40)
    assert got == _tier_sessions(free, 40)
    assert all(count > 0 for count in moved.values()), moved
    tiering = engine.stats()["tiering"]
    assert tiering["demoted_blocks"] > 0 and tiering["promoted_blocks"] > 0
    assert engine.stats()["attention_launches"]["reference"] == 0


@pytest.mark.cuda
def test_roll_at_k4_keeps_each_stream_on_its_generation(cuda_device):
    """The tiny preset at micro_k 4 through the tile kernel, rolled to new
    weights mid-wave: every generation captures its own K-step graphs,
    the old streams equal an engine that holds the old weights alone and
    the new ones an engine that holds the new weights alone, the old
    generation's weights and graphs are freed with its last stream, and
    the launch counts are those of the steps that ran."""
    old = [(np.arange(1, 30), 14, {}),
           (np.arange(5, 14), 12, {"temperature": 0.8, "key": [4, 5]})]
    new = [(np.arange(2, 9), 9, {}),
           (np.arange(40, 57), 7, {"temperature": 0.7, "key": [6, 7]})]
    serving = {"decode_impl": "cuda", "micro_k": 4}
    engine = build_engine("tiny", serving=serving, device=cuda_device)
    fresh = transformer.init(
        torch.Generator(device=cuda_device).manual_seed(5), engine.cfg)
    tpa.reset_launch_counts()
    rids = [engine.submit(p, n, **kw) for p, n, kw in old]
    while min(len(engine.request(r).tokens) for r in rids) < 5:
        engine.step()
    engine.adopt_params(fresh, generation=3)
    rids += [engine.submit(p, n, **kw) for p, n, kw in new]
    out = engine.drain()
    s = engine.stats()
    calls = s["chunk_steps"] + s["decode_steps"] + 3 * s["micro_steps"]
    assert s["attention_launches"] == {
        "cuda": engine.cfg.n_layers * calls, "pipelined": 0, "reference": 0}
    assert s["step_graph"]["captures"] >= 2
    assert s["step_graph"]["replays"] == s["micro_steps"]
    assert set(engine._gen_params) == set(engine._micro_graphs) == {3}
    assert s["adapters"]["param_swaps"] == 1

    def alone(params, wave):
        single = build_engine("tiny", serving=serving, device=cuda_device)
        if params is not None:
            single.adopt_params(params)
        ids = [single.submit(p, n, **kw) for p, n, kw in wave]
        got = single.drain()
        return [got[i] for i in ids]

    assert [out[r] for r in rids[:2]] == alone(None, old)
    assert [out[r] for r in rids[2:]] == alone(fresh, new)


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


#: The speculative scoring step's query widths: spec_k + 1 at spec_k 3 (the
#: quantized spec run, tensor cores at group 4) and 4 (the bf16 one).
SPEC_WIDTHS = [4, 5]


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [
    # the flagship's scoring step: 16 slots, tables of max_len 1152
    dict(h=8, kv=2, d=128, bs=16, rows=16, max_blocks=72),
    dict(h=8, kv=4, d=16, bs=8),              # the tiny preset
    dict(h=4, kv=2, d=8, bs=4)])              # the micro preset
@pytest.mark.parametrize("w", SPEC_WIDTHS)
@pytest.mark.parametrize("dtype,kv_dtype", TILE_PAIRS)
@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["tile", "pipelined"])
@pytest.mark.parametrize("splits", [1, 2, "plan", "tiles"])
def test_spec_scoring_widths_match_plain(cuda_device, geometry, w, dtype,
                                         kv_dtype, pipelined, splits):
    """Both paged kernels at the scoring widths, every (q type, storage)
    pair: fragmented tables, ragged depths, an inactive row, forced splits
    with NaN-filled output and split states, the split states and the
    combine alone against their plain versions, inputs unchanged."""
    _check_forced_splits(cuda_device, geometry, w, dtype, kv_dtype, splits,
                         pipelined=pipelined)


@pytest.mark.cuda
def test_pipelined_tensor_cores_at_the_scoring_widths(cuda_device):
    """At the flagship's group 4, a CTA takes w × 4 query rows: w 4 (spec_k
    3) is 16 rows, on the tensor cores; w 5 (spec_k 4) is 20, scalar."""
    pool = torch.empty((2, 16, 2, 128), dtype=torch.int8, device=cuda_device)
    for w, mma in ((4, True), (5, False)):
        q = torch.empty((16, w, 8, 128), dtype=torch.bfloat16,
                        device=cuda_device)
        assert tpa.pipelined_uses_tensor_cores(q, pool) == mma


@pytest.mark.cuda
@pytest.mark.parametrize("spec_k", [3, 4])
@pytest.mark.parametrize("impl,kv_dtype", [("cuda", None), ("cuda", "int8"),
                                           ("pipelined", "int8")])
def test_spec_engine_runs_the_kernels(cuda_device, spec_k, impl, kv_dtype):
    """A spec engine (micro preset, a differently seeded draft of the same
    geometry) through a kernel: the target's scoring step and the draft's
    steps all launch it, never the plain version, as many calls as a
    forced-plain engine makes, with the same streams."""
    base = build_engine("micro", device="cpu")
    draft = transformer.init(torch.Generator().manual_seed(1), base.cfg)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, base.cfg.vocab_size, size=n)
               for n in (3, 13, 7, 1, 22)]
    outs, calls = {}, {}
    for path in (impl, "reference"):
        serving = {"decode_impl": path, "kv_dtype": kv_dtype,
                   "spec_k": spec_k}
        engine = ServingEngine(base.params, base.cfg,
                               ServingConfig(**{**SERVING_PRESETS["micro"],
                                                **serving}),
                               device=cuda_device, draft_params=draft,
                               draft_cfg=base.cfg)
        tpa.reset_launch_counts()
        for i, prompt in enumerate(prompts):
            engine.submit(prompt, 12, **({"temperature": 0.8, "key": [i, 1]}
                                         if i % 2 else {}))
        outs[path] = engine.drain()
        launches = engine.stats()["attention_launches"]
        calls[path] = launches[path]
        assert sum(launches.values()) == launches[path] > 0
        assert engine.stats()["spec"]["rounds"] > 0
        assert engine.stats()["draft_decode_impl"] == path
    assert outs[impl] == outs["reference"]
    assert calls[impl] == calls["reference"]


@pytest.mark.cuda
@pytest.mark.parametrize("micro_k", [1, 4])
@pytest.mark.parametrize("impl,kv_dtype", [("cuda", None), ("cuda", "int8"),
                                           ("pipelined", None),
                                           ("pipelined", "int8")])
def test_resumed_requests_run_the_kernels(cuda_device, impl, kv_dtype,
                                          micro_k):
    """Drain and resume on the card: an export taken once every request
    holds tokens resumes in a fresh engine whose pool preempts, through
    the kernel and through the plain version, with the uninterrupted
    streams, launching only the engine's own paged attention."""
    import json

    serving = {"decode_impl": impl, "kv_dtype": kv_dtype,
               "micro_k": micro_k, "slots": 6, "max_len": 40}
    rng = np.random.default_rng(21)
    wave = [(rng.integers(0, 64, size=7 + 2 * i), 14,
             {"temperature": 0.9, "key": [i, 3]} if i % 2 else {})
            for i in range(6)]
    first = build_engine("micro", serving=serving, device=cuda_device)
    rids = [first.submit(p, n, **kw) for p, n, kw in wave]
    while not all(first.request(r).tokens for r in rids):
        first.step()
    records = json.loads(json.dumps(first.export_inflight()))
    want = first.drain()
    for path in (impl, "reference"):
        second = build_engine("micro", serving={
            **serving, "decode_impl": path, "n_blocks": 12},
            device=cuda_device)
        tpa.reset_launch_counts()
        mapping = second.resume_inflight(records)
        out = second.drain()
        assert {r: out[mapping[r]] for r in mapping} == \
            {r: want[r] for r in mapping}
        assert second.preemption_count > 0
        launches = second.stats()["attention_launches"]
        assert sum(launches.values()) == launches[path] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["cuda", "pipelined"])
def test_spec_engine_refuses_a_width_the_kernel_cannot_take(cuda_device,
                                                            impl):
    """The flagship's heads at spec_k 127 would score at w 128: 512 query
    rows a CTA, past the card's shared memory. The engine says so at
    construction, naming the step, rather than at a launch mid-stream."""
    cfg = transformer.TransformerConfig(
        vocab_size=256, d_model=256, n_layers=1, n_heads=8, d_head=128,
        d_ff=256, n_kv_heads=2, dtype=torch.bfloat16)
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    scfg = ServingConfig(slots=2, block_size=16, n_blocks=40, max_len=256,
                         spec_k=127, decode_impl=impl)
    with pytest.raises(ValueError, match="scoring step.*shared memory"):
        ServingEngine(params, cfg, scfg, device=cuda_device,
                      draft_params=params, draft_cfg=cfg)
    engine = ServingEngine(params, cfg,
                           ServingConfig(**{**scfg.__dict__, "spec_k": 4}),
                           device=cuda_device, draft_params=params,
                           draft_cfg=cfg)
    assert engine.stats()["draft_decode_impl"] == impl


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


def _tenant(seed, d_model, n_layers, rank=4):
    rng = np.random.default_rng(seed)
    return [{"a": rng.normal(size=(d_model, rank)) * 0.5,
             "b": rng.normal(size=(rank, d_model)) * 0.5}
            for _ in range(n_layers)]


@pytest.mark.cuda
@pytest.mark.parametrize("micro_k", [1, 4])
def test_lora_evict_and_reload_keeps_the_pool_under_its_graphs(
        cuda_device, tmp_path, micro_k):
    """The tiny preset with room for two resident adapters, registered
    with ``host_copy=False`` into a local bucket: tenants 0-1, then 2-3
    (which evict them), then 0-1 again, reloaded from the bucket. The
    third wave equals the first token for token, the pool is the same
    tensor at the same address throughout (written in place), and at
    micro_k 4 the LoRA variant of the greedy graph is captured once and
    reads the reloaded adapters."""
    from tpu_task_torch.serve.kvfleet import FleetKvClient
    from tpu_task_torch.storage.backends import LocalBackend

    client = FleetKvClient(LocalBackend(str(tmp_path)), "card",
                           refresh_interval=0.0)
    engine = build_engine("tiny", device=cuda_device, kv_client=client,
                          serving={"decode_impl": "cuda", "micro_k": micro_k,
                                   "lora_rank": 4, "n_adapter_blocks": 5})
    cfg = engine.cfg
    for i in range(4):
        engine.register_adapter(f"t{i}", _tenant(i, cfg.d_model,
                                                 cfg.n_layers),
                                host_copy=False)
    pool, ptr = engine._lora_pool, engine._lora_pool.data_ptr()
    prompts = [np.arange(3 + i, 40 + 7 * i) % cfg.vocab_size
               for i in range(4)]

    def wave(tenants):
        rids = [engine.submit(prompts[t], 12, adapter_id=f"t{t}")
                for t in tenants for _ in range(2)]
        out = engine.drain()
        return [out[r] for r in rids]

    first = wave([0, 1])
    graphs = dict(engine._micro_graphs[0]._graphs) if micro_k > 1 else {}
    second = wave([2, 3])
    third = wave([0, 1])
    assert third == first and second != first
    assert engine._lora_pool is pool and pool.data_ptr() == ptr
    s = engine.stats()
    assert s["adapters"]["evictions"] >= 4 and s["adapters"]["loads"] >= 6
    assert client.bytes_fetched > 0
    if micro_k > 1:
        runner = engine._micro_graphs[0]
        assert set(graphs) == {(False, True)}
        assert runner._graphs == graphs
        assert s["step_graph"]["lora_captures"] == 1


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


@pytest.mark.cuda
def test_async_snapshot_on_the_card_survives_in_place_updates(cuda_device,
                                                              tmp_path):
    """save() returns after the device clone; the leaves are then changed
    in place on the compute stream, and the files hold the values at
    save() (bf16 as its bits), restored onto the card."""
    from tpu_task_torch.ml import AsyncCheckpointer, restore_checkpoint_sharded

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    tree = {"w": torch.randn(1024, 4096, device=cuda_device, generator=gen),
            "b": torch.randn(333, device=cuda_device,
                             generator=gen).to(torch.bfloat16),
            "n": 5}
    expected = {k: v.clone() if torch.is_tensor(v) else v
                for k, v in tree.items()}
    with AsyncCheckpointer(tmp_path, keep=2) as saver:
        for step in (1, 2):
            saver.save(step, tree)
            tree["w"].mul_(3.0).add_(1.0)
            tree["b"].add_(1.0)
        assert saver.pinned_bytes >= 1024 * 4096 * 4 + 333 * 2
    template = {k: torch.zeros_like(v) if torch.is_tensor(v) else 0
                for k, v in tree.items()}
    got = restore_checkpoint_sharded(tmp_path, template, step=1)
    assert got["n"] == 5 and got["w"].is_cuda
    assert torch.equal(got["w"], expected["w"])
    assert torch.equal(got["b"], expected["b"])


@pytest.mark.cuda
def test_prefetch_to_device_on_the_card(cuda_device):
    from tpu_task_torch.ml.data import prefetch_to_device

    batches = [(np.full((256, 1025), i, np.int64), np.arange(3) + i)
               for i in range(5)]
    got = list(prefetch_to_device(iter(batches), depth=2))
    assert len(got) == 5
    for i, (x, y) in enumerate(got):
        assert x.is_cuda and y.is_cuda
        assert torch.equal(x.cpu(), torch.from_numpy(batches[i][0]))
        assert torch.equal(y.cpu(), torch.from_numpy(batches[i][1]))
