"""On-demand profiler capture on ``torch.profiler`` — the capture half of
``tpu_task/ml/profiling.py`` (``busy``, ``capture``, ``acquire_capture``,
``capture_reserved``), which a replica's ``GET /profile?ms=`` runs on a
worker thread.

One capture at a time: the profiler is process-global state, so a
process-wide lock is the reservation. A capture records ``duration_s``
seconds of whatever the process does and writes a Chrome trace under
``log_dir``. On a CUDA device it records the device's activity (every
kernel the process launches, from any thread) beside the host's, and
raises if this torch build cannot; off the card it records the host
alone and says so in the trace's file name (``trace-cpu.json`` against
``trace-cuda.json``) and in :func:`activities`. The JAX module's
``trace``, ``annotate`` and ``step_window`` are ROADMAP A15."""

from __future__ import annotations

import os
import threading
import time
from typing import List

import torch

from tpu_task_torch.device import resolve_device

__all__ = ["acquire_capture", "activities", "busy", "capture",
           "capture_reserved"]

#: One capture at a time: the profiler is process-global.
_capture_lock = threading.Lock()


def busy() -> bool:
    """Whether a capture is recording."""
    return _capture_lock.locked()


def activities(device=None) -> List[str]:
    """What a capture for ``device`` records: ``["cpu", "cuda"]`` on a
    CUDA device, ``["cpu"]`` on the CPU the caller asked for. Raises
    RuntimeError when CUDA is wanted and this torch build's profiler
    cannot trace it: a capture never stands in the host alone for the
    card."""
    device = resolve_device(device)
    if device.type != "cuda":
        return ["cpu"]
    if torch.profiler.ProfilerActivity.CUDA not in \
            torch.profiler.supported_activities():
        raise RuntimeError(
            "torch.profiler cannot trace CUDA in this build (no CUPTI): a "
            "capture would record the host alone")
    return ["cpu", "cuda"]


def capture(log_dir: str, duration_s: float, device=None) -> str:
    """Blocking capture of ``duration_s`` seconds into ``log_dir``;
    returns the trace's path. Raises RuntimeError when a capture is
    already running."""
    if not acquire_capture():
        raise RuntimeError("a profiler capture is already running")
    return capture_reserved(log_dir, duration_s, device)


def acquire_capture() -> bool:
    """Reserve the profiler for a caller that will run
    :func:`capture_reserved` (possibly on another thread). False when a
    capture is running: two racing requests can never both win."""
    return _capture_lock.acquire(blocking=False)


def capture_reserved(log_dir: str, duration_s: float, device=None) -> str:
    """Run one capture under a reservation taken with
    :func:`acquire_capture`, released on completion (success or failure).
    Returns the Chrome trace's path: ``trace-cuda.json`` when the
    device's activity was recorded, ``trace-cpu.json`` when the host's
    alone was."""
    try:
        wanted = activities(device)
        kinds = [getattr(torch.profiler.ProfilerActivity, name.upper())
                 for name in wanted]
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"trace-{wanted[-1]}.json")
        with torch.profiler.profile(activities=kinds) as prof:
            time.sleep(duration_s)
        prof.export_chrome_trace(path)
    finally:
        _capture_lock.release()
    return path
