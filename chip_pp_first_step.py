#!/usr/bin/env python3
"""Where a rank's first pipeline-parallel step spends its time: 4 SPMD
ranks (gloo over ``tcp://localhost``) on one device, each a stage of
``train.make_pp_train_step`` on pp 4 at 4 microbatches (chip_smoke's
``TRAIN_PP_TINY``, fp32, tokens (8, 257)).

    timeout 400 python3 chip_pp_first_step.py            # on the card
    timeout 400 python3 chip_pp_first_step.py --device cpu
    timeout 400 python3 chip_pp_first_step.py --profile   # first step under torch.profiler
    timeout 400 python3 chip_pp_first_step.py --preimport # the import first

Each rank first warms its device the way chip_smoke's earlier legs do
(two one-process train steps of the same config), times a few
``pipeline_hop`` and ``all_reduce_as`` calls, then runs three pipeline
steps with a sync before and after every hand-off, so each tick splits
into the stage's compute and the hand-off's wait; every flash wrapper call
and every ``torch.autograd.grad`` call is timed on its own (with a sync).
One JSON line a rank; ``--profile`` adds the first step's ten ops with
the most host time. The first stage backward's ``torch.autograd.grad``
(the first given ``grad_outputs``) imports ``torch.fx.experimental.
symbolic_shapes`` and sympy once a process, which ``pipeline_train`` now
does itself before its first hand-off (so ``slowest_calls`` no longer
shows it); ``--preimport`` imports them before the timed steps and times
that import. The card's name and power limit come first."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent

RANK = r'''
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from tpu_task_torch.ml import train
from tpu_task_torch.ml.models import transformer
from tpu_task_torch.ml.ops import attention as fa
from tpu_task_torch.ml.parallel import collectives
from tpu_task_torch.ml.parallel.mesh import (distributed_init_from_env,
                                             local_batch, make_mesh)

distributed_init_from_env()
dev = torch.device(sys.argv[2])
profile = sys.argv[3] == "1"
out = {"rank": dist.get_rank()}
if sys.argv[4] == "1":
    t0 = time.perf_counter()
    import torch.fx.experimental.symbolic_shapes  # noqa: F401
    out["preimport_s"] = time.perf_counter() - t0


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize()


def timed(name, fn, calls):
    def run(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        sync()
        calls.append([name, time.perf_counter() - t0])
        return result
    return run


model = dict(vocab_size=1024, d_model=256, n_layers=4, n_heads=8, d_head=32,
             d_ff=512, n_kv_heads=4)
cfg = transformer.TransformerConfig(dtype=torch.float32, **model)
tokens = torch.randint(0, 1024, (8, 257),
                       generator=torch.Generator().manual_seed(5))
t0 = time.perf_counter()
state = train.init_state(torch.Generator().manual_seed(6), cfg, device=dev)
one = train.make_train_step(cfg)
for _ in range(2):
    state, m = one(state, tokens.to(dev))
    m["loss"].item()
sync()
out["warm_one_process_s"] = time.perf_counter() - t0
del state

mesh = make_mesh(axis_names=("pp",), axis_sizes=(4,), device=dev)
like = torch.zeros(2, 8, device=dev)
rank = out["rank"]
hops = []
for kind in ("empty", "empty", "data", "data"):
    sync()
    t0 = time.perf_counter()
    if kind == "empty":
        collectives.pipeline_hop(mesh, "pp", like)
    else:
        collectives.pipeline_hop(mesh, "pp", like,
                                 forward=like if rank < 3 else None,
                                 receive_forward=rank > 0)
    sync()
    hops.append([kind, time.perf_counter() - t0])
out["hops_s"] = hops
sums = []
for n in (4, 4, 1 << 20, 1 << 20):
    v = torch.ones(n, device=dev)
    sync()
    t0 = time.perf_counter()
    collectives.all_reduce_as(mesh, v, "pp", "probe")
    sync()
    sums.append([n, time.perf_counter() - t0])
out["all_reduce_s"] = sums

full = train.init_pp_state(torch.Generator().manual_seed(6), cfg, 4,
                           device="cpu")
blocks, _ = train.shard_pp_state(full, mesh)
step = train.make_pp_train_step(cfg, mesh, 4)(blocks)
rows = local_batch(tokens, mesh).to(dev)
calls = []
original = {"hop": collectives.pipeline_hop, "grad": torch.autograd.grad,
            "fwd": fa.flash_attention, "dq": fa.flash_bwd_dq,
            "dkv": fa.flash_bwd_dkv}
torch.autograd.grad = timed("autograd.grad", original["grad"], calls)
fa.flash_attention = timed("flash_fwd", original["fwd"], calls)
fa.flash_bwd_dq = timed("flash_dq", original["dq"], calls)
fa.flash_bwd_dkv = timed("flash_dkv", original["dkv"], calls)
steps = []
for i in range(3):
    ticks, last = [], [time.perf_counter()]

    def hop(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        result = original["hop"](*args, **kwargs)
        sync()
        t1 = time.perf_counter()
        ticks.append([t0 - last[0], t1 - t0])
        last[0] = t1
        return result

    collectives.pipeline_hop = hop
    t0 = time.perf_counter()
    if i == 0 and profile:
        from torch.profiler import ProfilerActivity, profile as prof
        with prof(activities=[ProfilerActivity.CPU]
                  + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                  ) as p:
            blocks, m = step(blocks, rows)
            m["loss"].item()
            sync()
        out["profile_top"] = [
            [e.key, e.self_cpu_time_total / 1e6, e.count]
            for e in sorted(p.key_averages(),
                            key=lambda e: -e.self_cpu_time_total)[:10]]
    else:
        blocks, m = step(blocks, rows)
        m["loss"].item()
        sync()
    steps.append({"s": time.perf_counter() - t0,
                  "after_last_hop_s": time.perf_counter() - last[0],
                  "ticks_compute_wait_s": ticks,
                  "slowest_calls": sorted(calls, key=lambda c: -c[1])[:3]})
    calls.clear()
    collectives.pipeline_hop = original["hop"]
out["steps"] = steps
print(json.dumps(out), flush=True)
'''


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--preimport", action="store_true")
    args = parser.parse_args()
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    work = Path(tempfile.mkdtemp(prefix="pp-first-step-"))
    script = work / "rank.py"
    script.write_text(RANK)
    with socket.socket() as probe:
        probe.bind(("localhost", 0))
        port = probe.getsockname()[1]
    procs = []
    try:
        for i in range(4):
            env = dict(os.environ, TPU_TASK_WORKER_ID=str(i),
                       TPU_TASK_NUM_WORKERS="4", OMP_NUM_THREADS="2",
                       TPU_TASK_COORDINATOR=f"localhost:{port}")
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(HERE), args.device,
                 "1" if args.profile else "0",
                 "1" if args.preimport else "0"],
                env=env, stdout=subprocess.PIPE, text=True))
        rc = 0
        for p in procs:
            stdout, _ = p.communicate(timeout=360)
            print(stdout.strip(), flush=True)
            rc = rc or p.returncode
        return rc
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
