#!/usr/bin/env python3
"""Time this checkout's flash kernels against another checkout's on one
card, in turns: other, this, this, other.

    git archive <commit> | tar -x -C build/parent   # a git-ignored directory
    timeout 900 python3 chip_ab.py build/parent

Each turn is a fresh process in the checkout it times. It imports that
checkout's own ``chip_smoke.py``, runs its device, build and
``flash_timing`` phases (the flash kernels at the flagship train shape),
then times that checkout's flash forward and its backward pair (dq, then
dk/dv) at this checkout's ``FWD_SHAPES`` with this checkout's
``fwd_shape_times`` and ``bwd_shape_times``, which call only the port's
public wrappers. Every JSON line a turn prints is printed again with
``turn`` and ``checkout`` ("other" or "this") added; the last line
gathers, by checkout in turn order, the ``ms`` of every line that names a
``kernel``, the forward's ``ms`` at each shape, and the backward pair's,
dq's and dk/dv's at each shape. Compare two versions only within one run
of this script: cards and hosts differ between runs. The script sets no
time limit of its own; run it under ``timeout``."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

TURN = """
import importlib.util
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
smi = cs.phase_device()
cs.import_port()
cs.phase_build()
device = torch.device("cuda")
cs.phase_flash_timing(device, smi)
spec = importlib.util.spec_from_file_location("chip_ab_shapes", sys.argv[1])
shapes = importlib.util.module_from_spec(spec)
spec.loader.exec_module(shapes)
shapes.emit("fwd_shapes", shapes=shapes.fwd_shape_times(device), gpu=smi)
shapes.emit("bwd_shapes", shapes=shapes.bwd_shape_times(device), gpu=smi)
"""


def shape_key(kernel: str, row: dict) -> str:
    return (kernel + " b{b} h{h} s{s} d{d} ".format(**row)
            + ("causal" if row["causal"] else "non-causal"))


def run_turn(turn: int, who: str, where: Path, summary: dict) -> None:
    done = subprocess.run(
        [sys.executable, "-c", TURN, str(HERE / "chip_smoke.py")],
        cwd=where, capture_output=True, text=True)
    for line in done.stdout.splitlines():
        try:
            row = json.loads(line)
        except ValueError:
            continue
        row.update(turn=turn, checkout=who)
        print(json.dumps(row), flush=True)
        if "kernel" in row and "ms" in row:
            summary[who].setdefault(row["kernel"], []).append(row["ms"])
        if row.get("phase") == "fwd_shapes":
            for shape in row["shapes"]:
                summary[who].setdefault(shape_key("flash_fwd", shape),
                                        []).append(shape["ms"])
        if row.get("phase") == "bwd_shapes":
            for shape in row["shapes"]:
                for kernel, key in (("flash_bwd_pair", "ms"),
                                    ("flash_bwd_dq", "dq_ms"),
                                    ("flash_bwd_dkv", "dkv_ms")):
                    summary[who].setdefault(shape_key(kernel, shape),
                                            []).append(shape[key])
    if done.returncode:
        sys.stderr.write(done.stderr[-8000:])
        raise SystemExit(f"chip_ab: turn {turn} ({who}, {where}) exited "
                         f"{done.returncode}")


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit("usage: chip_ab.py OTHER_CHECKOUT")
    other = Path(sys.argv[1]).resolve()
    if not (other / "chip_smoke.py").exists():
        raise SystemExit(f"chip_ab: {other} holds no chip_smoke.py")
    summary = {"other": {}, "this": {}}
    for turn, (who, where) in enumerate((("other", other), ("this", HERE),
                                         ("this", HERE), ("other", other))):
        run_turn(turn, who, where, summary)
    print(json.dumps({"ab_ms": summary, "order": "other, this, this, other",
                      "other": str(other)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
