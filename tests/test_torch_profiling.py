"""The port's profiler hooks (``tpu_task_torch.ml.profiling``) as
``tests/test_ml_models.py::test_profiler_trace_writes_capture_files`` holds
the JAX package's: ``trace`` writes a capture under an explicit directory,
``annotate`` names a range in it, ``step_window`` traces only its steps,
the env-gated default touches nothing while ``TPU_TASK_PROFILE`` is unset
and traces into it when set; and ``trace`` refuses while a ``capture``
holds the process-global profiler."""

import json
import threading

import pytest
import torch

from tpu_task_torch.ml import profiling


def _names(path) -> set:
    return {event.get("name") for event in
            json.loads(path.read_text()).get("traceEvents", [])}


def test_trace_writes_capture_files_with_annotations(tmp_path):
    log_dir = tmp_path / "profiles"
    with profiling.trace(str(log_dir), device="cpu"):
        with profiling.annotate("unit-span"):
            (torch.ones(8, 8) * 2).sum()
    (trace,) = log_dir.glob("trace-*-cpu.json")
    assert "unit-span" in _names(trace)
    assert not profiling.busy()


def test_step_window_traces_only_its_steps(tmp_path):
    window = tmp_path / "window"
    for step in range(6):
        with profiling.step_window(step, start=2, stop=4,
                                   log_dir=str(window), device="cpu"):
            with profiling.annotate(f"step-{step}"):
                torch.ones(4).add_(1)
    traces = sorted(window.glob("trace-*.json"))
    assert len(traces) == 2
    names = set().union(*(_names(t) for t in traces))
    assert {"step-2", "step-3"} <= names
    assert not names & {"step-0", "step-1", "step-4", "step-5"}
    with profiling.step_window(5, start=10, stop=12,
                               log_dir=str(tmp_path / "none")):
        pass
    assert not (tmp_path / "none").exists()


def test_env_gated_default(tmp_path, monkeypatch):
    monkeypatch.delenv("TPU_TASK_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    before = sorted(p.name for p in tmp_path.iterdir())
    with profiling.trace():
        pass
    with profiling.step_window(0, start=0, stop=1):
        pass
    assert sorted(p.name for p in tmp_path.iterdir()) == before
    monkeypatch.setenv("TPU_TASK_PROFILE", str(tmp_path / "profiles-env"))
    with profiling.trace(device="cpu"):
        torch.ones(4).add_(1)
    assert list((tmp_path / "profiles-env").glob("trace-*-cpu.json"))


def test_trace_refuses_while_a_capture_runs(tmp_path):
    assert profiling.acquire_capture()
    try:
        with pytest.raises(RuntimeError, match="already running"):
            with profiling.trace(str(tmp_path / "t"), device="cpu"):
                pass
    finally:
        profiling._capture_lock.release()
    # And a capture on another thread refuses while a trace records.
    refused = []
    with profiling.trace(str(tmp_path / "t"), device="cpu"):
        worker = threading.Thread(target=lambda: refused.append(
            not profiling.acquire_capture()))
        worker.start()
        worker.join(timeout=30)
    assert refused == [True] and not profiling.busy()


def test_trace_wants_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.trace(str(tmp_path / "t")):
            pass
    assert not profiling.busy() and not (tmp_path / "t").exists()
    assert profiling.device_memory_summary() == ""
