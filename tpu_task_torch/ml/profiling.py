"""Profiler capture on ``torch.profiler`` — the counterpart of
``tpu_task/ml/profiling.py``: the on-demand capture a replica's ``GET
/profile?ms=`` runs on a worker thread (``busy``, ``capture``,
``acquire_capture``, ``capture_reserved``), and the task script's
``trace``, ``step_window``, ``annotate`` and ``device_memory_summary``.

One capture at a time: the profiler is process-global state, so a
process-wide lock is the reservation, and :func:`trace` takes it too. A
capture writes a Chrome trace under ``log_dir``, which the worker agent's
workdir sync ships to the bucket. On a CUDA device it records the device's
activity (every kernel the process launches, from any thread) beside the
host's, and raises if this torch build cannot; off the card it records the
host alone and says so in the trace's file name (``...-cpu.json`` against
``...-cuda.json``) and in :func:`activities`.

Usage in a task script::

    with profiling.trace():                  # env-gated: no-op unless
        state, metrics = step(state, batch)  # TPU_TASK_PROFILE=<dir> is set

    for step_ix in range(n):                 # or: trace a step window
        with profiling.step_window(step_ix, start=100, stop=105):
            state, metrics = step(state, batch)

    with profiling.annotate("data-load"):    # named range inside a trace
        batch = next(batches)
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Callable, ContextManager, List, Optional

import torch

from tpu_task_torch.device import resolve_device

__all__ = ["acquire_capture", "activities", "annotate", "busy", "capture",
           "capture_reserved", "device_memory_summary", "step_window",
           "trace"]

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


def capture_reserved(log_dir: str, duration_s: float, device=None,
                     on_start: Optional[Callable[[], None]] = None,
                     hold: Optional[ContextManager] = None) -> str:
    """Run one capture under a reservation taken with
    :func:`acquire_capture`, released on completion (success or failure).
    ``on_start`` runs once the profiler records, before the
    ``duration_s`` window. ``hold`` (a lock) is held while the profiler
    starts and while it stops: a replica passes its engine lock, so that
    neither happens while another thread launches kernels (on the card,
    stopping the profiler while another thread replayed a CUDA graph has
    deadlocked both). Returns the Chrome trace's path:
    ``trace-cuda.json`` when the device's activity was recorded,
    ``trace-cpu.json`` when the host's alone was."""
    try:
        wanted = activities(device)
        path = os.path.join(log_dir, f"trace-{wanted[-1]}.json")
        with _recording(wanted, path, hold):
            if on_start is not None:
                on_start()
            time.sleep(duration_s)
    finally:
        _capture_lock.release()
    return path


@contextmanager
def _recording(wanted: List[str], path: str,
               hold: Optional[ContextManager] = None):
    """``torch.profiler`` over ``wanted`` for the enclosed block, started
    and stopped under ``hold``; its Chrome trace written to ``path``."""
    kinds = [getattr(torch.profiler.ProfilerActivity, name.upper())
             for name in wanted]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    hold = nullcontext() if hold is None else hold
    prof = torch.profiler.profile(activities=kinds)
    with hold:
        prof.start()
    try:
        yield
    finally:
        with hold:
            prof.stop()
    prof.export_chrome_trace(path)


@contextmanager
def trace(log_dir: Optional[str] = None, device=None):
    """Capture a trace of the enclosed block into ``log_dir`` as
    ``trace-<ns>-<pid>-<cuda|cpu>.json``.

    An explicit ``log_dir`` always traces. With ``log_dir=None`` the
    capture is gated on ``TPU_TASK_PROFILE``: unset → no-op (and nothing
    touches the filesystem), set → its value is the trace directory — so
    production scripts leave the call sites in place and opt in per run.
    ``device`` is what :func:`activities` records (CUDA unless the caller
    passes ``device="cpu"``). Raises RuntimeError while another capture
    holds the profiler."""
    if log_dir is None:
        log_dir = os.environ.get("TPU_TASK_PROFILE", "")
        if not log_dir:
            yield
            return
    wanted = activities(device)
    if not acquire_capture():
        raise RuntimeError("a profiler capture is already running")
    try:
        with _recording(wanted, os.path.join(
                log_dir, f"trace-{time.time_ns()}-{os.getpid()}"
                         f"-{wanted[-1]}.json")):
            yield
    finally:
        _capture_lock.release()


def annotate(name: str):
    """A named range on the trace's timeline (``record_function``)."""
    return torch.profiler.record_function(name)


def step_window(step: int, *, start: int, stop: int,
                log_dir: Optional[str] = None, device=None):
    """Trace only steps in [start, stop) — the usual capture pattern: skip
    compilation and warm-up, record a few steady-state steps, one trace a
    step. The ``log_dir`` gating matches :func:`trace`."""
    if start <= step < stop:
        return trace(log_dir, device)
    return nullcontext()


def device_memory_summary() -> str:
    """One line a CUDA device: the caching allocator's bytes in use against
    the device's total memory; empty without CUDA."""
    if not torch.cuda.is_available():
        return ""
    lines = []
    for index in range(torch.cuda.device_count()):
        in_use = torch.cuda.memory_stats(index).get(
            "allocated_bytes.all.current", 0)
        _free, total = torch.cuda.mem_get_info(index)
        lines.append(f"{torch.cuda.get_device_name(index)} {index}: "
                     f"{in_use / 1e9:.2f} GB in use of {total / 1e9:.2f} GB "
                     f"({in_use / total:.0%})")
    return "\n".join(lines)
