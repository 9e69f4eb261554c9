#!/usr/bin/env python3
"""Count, on one card, the replica's ``/profile`` captures that keep their
kernel records, with the step loop handed to a thread that starts inside
each capture and without that hand-over.

    timeout 900 python3 chip_capture.py [captures]

A ``ReplicaServer`` on the ``tiny`` preset (fp32, through the tile
kernel) serves phase 25's wave of ``chip_smoke.py`` again and again to a
client thread, while this script takes
``captures`` (default 40) captures of 200 ms each of the two kinds in
turns: ``handover`` (the replica as it is) and ``control`` (its
``_hand_over_step_loop`` replaced by a no-op, so the kernels come from a
thread that launched before the capture began). One JSON line a capture
(kind, the trace's events, runtime calls, kernel records, the tile
kernel's walks and the combines) and a last line with, by kind, the
captures that hold no kernel record and those that name no walk. The
lines also go to ``chiprun_out/capture.jsonl``. The script imports no JAX
and needs the card; it sets no time limit of its own."""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

import chip_smoke as cs


def trace_counts(path: Path) -> dict:
    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return dict(events=len(events),
                runtime_calls=sum(e.get("cat") == "cuda_runtime"
                                  for e in events),
                kernels=len(names),
                walks=sum(any(w in n for w in cs.WALK_NAMES["cuda"])
                          for n in names),
                combines=sum(cs.COMBINE_NAME in n for n in names))


def main(captures: int) -> int:
    smi = cs.phase_device()
    cs.import_port()
    cs.phase_build()
    from tpu_task_torch.serve.replica import MODEL_PRESETS, ReplicaServer

    root = Path(tempfile.mkdtemp(prefix="tpu-task-capture-"))
    out = cs.HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    log = (out / "capture.jsonl").open("w")
    replica = ReplicaServer(preset="tiny", serving={"decode_impl": "cuda"},
                            profile_dir=str(root)).start()
    handover = replica._hand_over_step_loop
    wave = cs._replica_wave(MODEL_PRESETS["tiny"]["vocab_size"])
    stop = threading.Event()

    def load():
        client = cs.HttpClient(replica.url)
        while not stop.is_set():
            for rid in [client.call("POST", "/submit", body)[2]["rid"]
                        for body in wave]:
                client.stream(rid)
        client.close()

    loader = threading.Thread(target=load, daemon=True)
    loader.start()
    client = cs.HttpClient(replica.url)
    lines = []
    try:
        time.sleep(1.0)                      # the load is flowing
        for i in range(2 * captures):
            kind = ("handover", "control")[i % 2]
            replica._hand_over_step_loop = (
                handover if kind == "handover" else (lambda: None))
            status, _, body = client.call("GET", "/profile?ms=200")
            if status != 200:
                raise AssertionError(f"/profile answered {status}: {body}")
            replica._profile_thread.join(timeout=120)
            line = dict(capture=i, kind=kind, **trace_counts(
                Path(body["dir"]) / "trace-cuda.json"))
            lines.append(line)
            print(json.dumps(line), flush=True)
            log.write(json.dumps(line) + "\n")
    finally:
        stop.set()
        loader.join(timeout=60)
        client.close()
        replica.stop()
        shutil.rmtree(root, ignore_errors=True)
    summary = {"summary": {kind: dict(
        captures=sum(line["kind"] == kind for line in lines),
        without_kernels=sum(line["kind"] == kind and not line["kernels"]
                            for line in lines),
        without_walks=sum(line["kind"] == kind and not line["walks"]
                          for line in lines))
        for kind in ("handover", "control")},
        "step_error": replica.step_error, "gpu": smi}
    log.write(json.dumps(summary) + "\n")
    log.close()
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 40))
