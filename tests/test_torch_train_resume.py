"""A torch training task survives preemption.

- ``chip_smoke.TRAINER_SCRIPT`` (the task script chip_smoke runs on the
  card at the flagship's size) runs here on the CPU at a tiny size as its
  own process: SIGKILLed once its first ``LATEST_SHARDED`` is published,
  started again, it restores that step, continues the batch sequence
  (``epoch_batches(start_step=)``) and ends with the uninterrupted run's
  state bit for bit (the CPU's sums are deterministic).
- A torch MNIST task script runs through the JAX package's hermetic local
  control plane, as ``tests/test_lifecycle_local.py``'s preemption case
  runs a bash one: ``task.preempt(0)`` after its first checkpoint landed in
  the bucket (``AsyncCheckpointer(upload_remote="auto")``), and the
  respawned worker restores it, finishes and writes
  ``output/final_acc.txt``. That case spawns agent subprocesses, so it
  takes the cross-process lock of ``tests/conftest.py``'s
  ``AGENT_SUBPROCESS_MODULES`` in a fixture of its own."""

import fcntl
import os
import tempfile
import time
from pathlib import Path

import pytest
import torch

import chip_smoke
from tpu_task_torch.ml import checkpoint as ckpt
from tpu_task_torch.ml import train, tree
from tpu_task_torch.ml.models import transformer

REPO = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            d_ff=64)


def _final_state(workdir: Path, config: dict):
    cfg = transformer.TransformerConfig(dtype=torch.float32,
                                        **config["model"])
    template = train.init_state(torch.Generator().manual_seed(1), cfg,
                                device="cpu")
    return ckpt.restore_checkpoint_sharded(workdir / "checkpoints", template)


def test_killed_trainer_resumes_bit_for_bit(tmp_path):
    config = chip_smoke.trainer_config("cpu", TINY, "float32", batch=4,
                                       seq=16, steps=20, save_every=2)
    whole, killed = tmp_path / "whole", tmp_path / "killed"
    whole.mkdir()
    killed.mkdir()
    events, _, _ = chip_smoke.run_trainer(whole, config, "whole.log",
                                          timeout_s=120)
    assert [e["step"] for e in events if e["event"] == "step"] == \
        list(range(1, 21))
    first, _, killed_at = chip_smoke.run_trainer(
        killed, config, "first.log", kill_after_publish=True, timeout_s=120)
    # Killed inside its loop: steps were left to run.
    killed_after = max(e["step"] for e in first if e["event"] == "step")
    assert killed_at is not None and killed_at <= killed_after < 20
    assert not any(e["event"] == "done" for e in first)
    second, _, _ = chip_smoke.run_trainer(killed, config, "second.log",
                                          timeout_s=120)
    (restored,) = [e for e in second if e["event"] == "restored"]
    assert restored["step"] == killed_at
    assert [e["step"] for e in second if e["event"] == "step"] == \
        list(range(killed_at + 1, 21))
    a, b = _final_state(whole, config), _final_state(killed, config)
    assert a.step == b.step == 20
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y
    # The resumed run's losses are the uninterrupted run's, bit for bit.
    losses = {e["step"]: e["loss"] for e in events if e["event"] == "step"}
    assert all(losses[e["step"]] == e["loss"] for e in second
               if e["event"] == "step")


MNIST_TASK = """
import os, sys, time
sys.path.insert(0, os.environ["TPU_TASK_REPO"])
import torch
from tpu_task_torch.ml import AsyncCheckpointer, restore_checkpoint_sharded
from tpu_task_torch.ml import random
from tpu_task_torch.ml.data import epoch_batches
from tpu_task_torch.ml.models import mnist

x, y = mnist.synthetic_mnist(random.PRNGKey(0), n=1024, device="cpu")
params = mnist.init_mlp(random.PRNGKey(1), device="cpu")
state = {"params": params, "step": 0}
if os.path.exists("checkpoints/LATEST_SHARDED"):
    state = restore_checkpoint_sharded("checkpoints", state)
    print(f"resumed-from-step-{state['step']}", flush=True)
else:
    print("cold-start", flush=True)
params = {k: v.requires_grad_(True) for k, v in state["params"].items()}
batches = epoch_batches(x.numpy(), y.numpy(), 128, seed=0, epochs=4,
                        start_step=state["step"])
with AsyncCheckpointer("checkpoints", keep=2, upload_remote="auto") as cp:
    for step, (xb, yb) in enumerate(batches, state["step"] + 1):
        loss = mnist.loss_fn(params, torch.from_numpy(xb),
                             torch.from_numpy(yb))
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p -= 0.5 * g
        if step % 8 == 0:
            cp.save(step, {"params": params, "step": step})
        if step == 8 and "resumed" not in os.environ.get("RESUMED", ""):
            cp.wait()
            if not os.path.exists("resumed.marker"):
                print("checkpointed-step-8", flush=True)
                time.sleep(300)               # preempted during this sleep
acc = float(mnist.accuracy(params, x, y))
print(f"final acc {acc:.4f}", flush=True)
os.makedirs("output", exist_ok=True)
with open("output/final_acc.txt", "w") as f:
    f.write(f"{acc:.4f}\\n")
"""


@pytest.fixture
def agent_lock():
    """The lock ``tests/conftest.py`` takes for AGENT_SUBPROCESS_MODULES:
    agent subprocesses of two test processes starve each other."""
    path = os.path.join(tempfile.gettempdir(), "tpu-task-agent-tests.lock")
    with open(path, "a+") as handle:
        fcntl.flock(handle, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(handle, fcntl.LOCK_UN)


def test_torch_mnist_task_resumes_after_preemption(agent_lock, tmp_path,
                                                   monkeypatch):
    from tpu_task import task as task_factory
    from tpu_task.common.cloud import Cloud, Provider
    from tpu_task.common.identifier import Identifier
    from tpu_task.common.values import Environment, StatusCode
    from tpu_task.common.values import Task as TaskSpec
    from tpu_task.common.values import Variables

    monkeypatch.setenv("TPU_TASK_LOCAL_ROOT", str(tmp_path / "control-plane"))
    monkeypatch.setenv("TPU_TASK_LOCAL_LOG_PERIOD", "0.1")
    monkeypatch.setenv("TPU_TASK_LOCAL_DATA_PERIOD", "0.1")
    workdir = tmp_path / "work"
    workdir.mkdir()
    (workdir / "train.py").write_text(MNIST_TASK)
    spec = TaskSpec()
    spec.environment = Environment(
        script="#!/bin/bash\npython3 train.py\n",
        variables=Variables({"TPU_TASK_REPO": str(REPO)}),
        directory=str(workdir), directory_out="output")
    task = task_factory.new(Cloud(provider=Provider.LOCAL),
                            Identifier.deterministic("torch-preempt"), spec)

    def poll(predicate, timeout):
        deadline = time.time() + timeout
        while time.time() < deadline:
            task.read()
            if predicate():
                return
            time.sleep(0.2)
        raise AssertionError(f"condition not reached; status="
                             f"{task.status()} logs={task.logs()}")

    task.create()
    try:
        poll(lambda: "checkpointed-step-8" in "".join(task.logs()), 60)
        pointer = Path(task.group.bucket) / "data" / "checkpoints" / \
            "LATEST_SHARDED"
        assert pointer.exists()              # uploaded before the sync tick
        task.preempt(0)
        poll(lambda: task.status().get(StatusCode.SUCCEEDED, 0) >= 1, 60)
        logs = "".join(task.logs())
        assert "cold-start" in logs and "resumed-from-step-8" in logs
        assert "preempt" in [e.code for e in task.events()]
        task.delete()
        acc = float((workdir / "output" / "final_acc.txt").read_text())
        assert acc > 0.9
    finally:
        task.delete()
