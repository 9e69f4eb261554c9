#!/usr/bin/env python3
"""Which gloo spellings of a point-to-point hop take CUDA tensors, and how
long each takes, with 2 and 4 ranks on one card: the check behind
``tpu_task_torch/ml/parallel/collectives.py``'s ``ppermute``.

    timeout 300 python3 chip_p2p.py

For each mode and world size it starts that many rank processes (a gloo
group over ``tcp://localhost``); each sends a tensor to the next rank and
receives the previous rank's, 1 Ki and 4 Mi elements in fp32 and bf16,
five times, and reports whether the values arrived and the median ms.
Modes: ``a2a:<device>``, ``dist.all_to_all_single`` with uneven split
sizes (zero for every rank but the neighbours; also one call that keeps a
piece and sends one, as the zigzag re-layout does); ``p2p:<device>``,
``dist.batch_isend_irecv`` with the recv posted first; ``stage:cuda``,
the same on CPU tensors through pinned host buffers. One JSON line a
(mode, world), each rank's report or its error and exit code; the card's
name and power limit first. A mode that fails is reported, not fatal."""

from __future__ import annotations

import json
import shutil
import socket
import subprocess
import sys
import time

MODES = ("a2a:cuda", "stage:cuda", "a2a:cpu", "p2p:cpu", "p2p:cuda")
WORLDS = (2, 4)


def hop(mode: str, x, y, nxt: int, prv: int, world: int) -> None:
    """Send ``x`` to rank ``nxt`` and receive rank ``prv``'s into ``y``."""
    import torch
    import torch.distributed as dist

    if mode.startswith("a2a"):
        send, recv = [0] * world, [0] * world
        send[nxt], recv[prv] = x.numel(), y.numel()
        dist.all_to_all_single(y, x, output_split_sizes=recv,
                               input_split_sizes=send)
        return
    if mode.startswith("stage"):
        hx = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        hy = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        hx.copy_(x)
        ops = [dist.P2POp(dist.irecv, hy, prv), dist.P2POp(dist.isend, hx, nxt)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        y.copy_(hy)
        return
    ops = [dist.P2POp(dist.irecv, y, prv), dist.P2POp(dist.isend, x, nxt)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def rank_main(rank: int, world: int, port: int, mode: str) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    dev = torch.device(mode.split(":")[1])
    out = {"rank": rank, "mode": mode}
    nxt, prv = (rank + 1) % world, (rank - 1) % world

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    for dtype in (torch.float32, torch.bfloat16):
        for numel in (1 << 10, 4 << 20):
            key = f"{str(dtype)[6:]}_{numel}"
            x = torch.full((numel,), float(rank), dtype=dtype, device=dev)
            y = torch.empty_like(x)
            try:
                times = []
                for _ in range(5):
                    sync()
                    t0 = time.perf_counter()
                    hop(mode, x, y, nxt, prv, world)
                    sync()
                    times.append((time.perf_counter() - t0) * 1e3)
                out[key] = {"ok": bool((y.float() == prv).all()),
                            "ms": sorted(times)[2]}
            except RuntimeError as exc:
                out[key] = {"error": repr(exc)[:300]}
    if mode.startswith("a2a"):
        # Keep one piece and send one to the next rank.
        x = torch.arange(8, dtype=torch.float32, device=dev) + 100 * rank
        send, recv = [0] * world, [0] * world
        send[rank] += 4
        send[nxt] += 4
        recv[rank] += 4
        recv[prv] += 4
        pieces = sorted([(rank, x[:4]), (nxt, x[4:])], key=lambda p: p[0])
        y = torch.empty(8, device=dev)
        try:
            dist.all_to_all_single(y, torch.cat([p for _, p in pieces]),
                                   output_split_sizes=recv,
                                   input_split_sizes=send)
            out["kept_and_sent"] = y.tolist()
        except RuntimeError as exc:
            out["kept_and_sent"] = {"error": repr(exc)[:300]}
    print(json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    import torch

    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)
    if shutil.which("nvidia-smi"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    for mode in MODES:
        for world in WORLDS:
            with socket.socket() as probe:
                probe.bind(("localhost", 0))
                port = probe.getsockname()[1]
            procs = [subprocess.Popen(
                [sys.executable, __file__, str(r), str(world), str(port),
                 mode], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for r in range(world)]
            t0, ranks = time.time(), []
            for proc in procs:
                try:
                    text, _ = proc.communicate(
                        timeout=max(1.0, 90 - (time.time() - t0)))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    text, _ = proc.communicate()
                    text = "TIMEOUT " + (text or "")
                ranks.append([proc.returncode, text[-1500:]])
            print(json.dumps({"mode": mode, "world": world, "ranks": ranks}),
                  flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                  sys.argv[4])
        sys.exit(0)
    sys.exit(main())
