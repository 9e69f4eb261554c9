"""The port's replica rolls its weights from a checkpoint directory
(``ReplicaServer(ckpt_dir=)``, ``python -m tpu_task_torch.serve.replica
--ckpt-dir``), on the CPU at the ``micro`` preset: each step published
after boot, by the JAX package's ``save_checkpoint`` or the port's, rolls
into the engine while requests keep streaming, and no stream loses a
token; a torn checkpoint is a skipped beat; a resumed record pinned to a
generation the engine has freed is restored from its checkpoint step. The
process rewrites ``endpoint.json`` with the new generation, and the JAX
package's ``Router`` keeps the replica's membership state across it."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np

from tpu_task.ml.checkpoint import save_checkpoint as jax_save_checkpoint
from tpu_task.serve.replica import build_engine as jax_build_engine
from tpu_task.serve.router import Router
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.checkpoint import save_checkpoint
from tpu_task_torch.ml.models import transformer as ttf
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.serve.replica import ReplicaServer
from torch_port_util import CPU

ROOT = Path(__file__).resolve().parents[1]


def _bumped_jax(params, step):
    return jax.tree.map(lambda a: np.asarray(a) + 0.01 * step, params)


def _wait(predicate, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def test_replica_rolls_published_steps_without_dropping_a_stream(tmp_path):
    server = ReplicaServer(preset="micro", device="cpu",
                           ckpt_dir=str(tmp_path), ckpt_poll_s=0.05).start()
    try:
        base = server.engine.params
        jax_params = jax_build_engine("micro").params
        rng = np.random.default_rng(3)
        rids, stop = [], threading.Event()

        def feed():
            while not stop.is_set():
                rids.append(server.submit(
                    {"prompt": rng.integers(0, 64, size=5).tolist(),
                     "max_new_tokens": 6}))
                time.sleep(0.02)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        try:
            for step in (1, 2, 3, 4):
                time.sleep(0.2)
                if step == 2:
                    # A torn file behind the pointer: a skipped beat.
                    good = (tmp_path / "ckpt-1.npz").read_bytes()
                    (tmp_path / "ckpt-2.npz").write_bytes(
                        good[:len(good) // 2])
                    (tmp_path / "LATEST").write_text(json.dumps(
                        {"step": 2, "file": "ckpt-2.npz"}))
                    _wait(lambda: server.obs.metrics.snapshot().get(
                        "replica.errors.ckpt_poll", {}).get("value", 0) > 0,
                        "the torn checkpoint was never read")
                    assert server.engine.generation == 1
                    continue
                if step % 2:
                    jax_save_checkpoint(tmp_path, step,
                                        _bumped_jax(jax_params, step))
                else:
                    save_checkpoint(tmp_path, step, ttf.map_params(
                        lambda v, s=step: v + 0.01 * s, base))
                _wait(lambda s=step: server.engine.generation == s,
                      f"the roll to generation {step} never landed")
        finally:
            stop.set()
            feeder.join(timeout=10)
        for rid in rids:
            _wait(lambda r=rid: server.stream(r, 0)["status"] == "done",
                  f"stream {rid} hung")
            assert len(server.stream(rid, 0)["tokens"]) == 6, rid
        assert len(rids) >= 20
        assert server.health()["generation"] == 4
        adapters = server.engine.stats()["adapters"]
        assert adapters["param_swaps"] == 3
        assert adapters["stale_generation_streams"] == 0
        assert set(server.engine._gen_params) == {4}
        assert [roll["step"] for roll in server.rolls] == [1, 3, 4]
        metrics = server.obs.metrics.snapshot()
        assert metrics["replica.param_rolls"]["value"] == 3
        assert metrics["engine.param_swaps"]["value"] == 3
        assert server.step_error is None and not server.draining

        # A record pinned to generation 1, which no stream holds any more:
        # restored from ckpt-1 and served under it.
        record = {"prompt": [3, 1, 4, 1, 5], "tokens": [9, 2], "key": [8, 9],
                  "max_new_tokens": 6, "generation": 1}
        rid = server.submit(record)
        _wait(lambda: server.stream(rid, 0)["status"] == "done",
              "the pinned record never finished")
        engine = server.engine
        alone = ServingEngine(
            ttf.params_from_jax(_bumped_jax(jax_params, 1), engine.cfg, CPU),
            engine.cfg, engine.scfg, rng=R.PRNGKey(0), device=CPU)
        mapping = alone.resume_inflight([{**record, "generation": 0}])
        assert server.stream(rid, 0)["tokens"] == alone.drain()[mapping[0]]
        assert set(engine._gen_params) == {4}
    finally:
        server.stop()


def test_replica_process_announces_each_rolled_generation(tmp_path):
    """``--ckpt-dir``: a step published after boot rolls in and
    ``endpoint.json`` names it under the same ``boot_id``; JAX's router
    takes that as a roll, not a reboot, and keeps the replica's load."""
    ckpts = tmp_path / "ckpts"
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               TPU_TASK_SERVE_LINGER="0.1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_task_torch.serve.replica", "--device",
         "cpu", "--preset", "micro", "--ckpt-dir", str(ckpts)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    endpoint = tmp_path / "endpoint.json"
    try:
        _wait(lambda: endpoint.exists() or proc.poll() is not None,
              "the replica never announced", timeout=120)
        assert proc.poll() is None, proc.communicate()
        first = json.loads(endpoint.read_text())
        assert first["generation"] == 0
        router = Router(seed=0)
        router.set_replicas({"r0": first})
        router._replicas["r0"].load = 5
        jax_save_checkpoint(ckpts, 3, _bumped_jax(
            jax_build_engine("micro").params, 3))
        _wait(lambda: json.loads(endpoint.read_text())["generation"] == 3,
              "endpoint.json never named generation 3")
        rolled = json.loads(endpoint.read_text())
        assert rolled["boot_id"] == first["boot_id"]
        router.set_replicas({"r0": rolled})
        assert router.replicas()["r0"]["generation"] == 3
        assert router._replicas["r0"].load == 5
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
