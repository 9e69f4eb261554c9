"""A gang's processes: the replica's ``--tp``/``--ep`` over HTTP beside the
JAX package's replica, and what happens to the followers when something
goes wrong.

``python -m tpu_task_torch.serve.replica --device cpu --preset moe --tp 2
--ep 2`` starts three follower processes of its own and serves, through
them, the streams JAX's replica serves at the same flags (greedy and keyed
sampled requests); killed outright, it loses its followers (their control
sockets close). ``tests/test_torch_replica_main.py`` stops gang replicas
with SIGTERM and finds no follower left. A follower that raises is
reported on rank 0 as a ``GangError`` carrying the follower's traceback,
and the gang is closed."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from tpu_task_torch.ml.parallel import gang
from torch_gang_util import alive, children, cpu_gang, rank_raises

ROOT = Path(__file__).resolve().parents[1]


def _replica(cwd, module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               TPU_TASK_SERVE_LINGER="0.1")
    return subprocess.Popen([sys.executable, "-m", module, *args],
                            cwd=str(cwd), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _announced(proc, cwd) -> dict:
    endpoint = cwd / "endpoint.json"
    deadline = time.monotonic() + 120
    while not endpoint.exists():
        assert proc.poll() is None, proc.communicate()
        assert time.monotonic() < deadline
        time.sleep(0.05)
    return json.loads(endpoint.read_text())


def _call(url, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    request = urllib.request.Request(url + path, data=data,
                                     method="GET" if body is None else "POST")
    with urllib.request.urlopen(request, timeout=60) as response:
        return json.loads(response.read())


def _streams(url, prompts) -> list:
    rids = [_call(url, "/submit", {
        "prompt": prompt, "max_new_tokens": 8,
        "temperature": 0.8 if i % 2 else 0.0, "key": [i, 21]})["rid"]
        for i, prompt in enumerate(prompts)]
    out = []
    for rid in rids:
        deadline = time.monotonic() + 120
        while True:
            got = _call(url, f"/poll?rid={rid}")
            if got["status"] == "done":
                out.append(got["tokens"])
                break
            assert time.monotonic() < deadline
            time.sleep(0.02)
    return out


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_replica_gang_serves_jax_streams_and_dies_with_its_followers(
        tmp_path):
    flags = ("--preset", "moe", "--tp", "2", "--ep", "2")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = _replica(tmp_path / "port", "tpu_task_torch.serve.replica",
                    "--device", "cpu", *flags)
    jax = _replica(tmp_path / "jax", "tpu_task.serve.replica", *flags)
    try:
        ours = _announced(port, tmp_path / "port")
        theirs = _announced(jax, tmp_path / "jax")
        followers = children(port.pid)
        assert len(followers) == 3
        prompts = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11, 12, 13, 14, 15],
                   [20, 21, 22]]
        assert _streams(ours["url"], prompts) == \
            _streams(theirs["url"], prompts)
        stats = _call(ours["url"], "/stats")
        assert (stats["tp"], stats["ep"]) == (2, 2)
        assert stats["step_graph"]["captures"] == 0
        # Killed outright, rank 0 takes its followers with it: their
        # control sockets close.
        port.kill()
        port.communicate(timeout=30)
        deadline = time.monotonic() + 30
        while any(alive(pid) for pid in followers):
            assert time.monotonic() < deadline, "a follower outlived rank 0"
            time.sleep(0.05)
    finally:
        _stop(jax)
        _stop(port)


def test_follower_failure_is_reported_with_its_traceback(tmp_path):
    with cpu_gang(tmp_path, 2) as mesh:
        procs = mesh.gang.procs
        assert mesh.gang.query(rank_raises, mesh, 5) == [0, 1]
        with pytest.raises(gang.GangError) as error:
            mesh.gang.query(rank_raises, mesh, 1)
        assert "gang follower rank 1 failed" in str(error.value)
        assert "planted failure on rank 1" in str(error.value)
        assert "Traceback" in str(error.value)
        assert mesh.gang.closed
        assert all(p.poll() is not None for p in procs)
        with pytest.raises(gang.GangError, match="closed"):
            mesh.gang.query(rank_raises, mesh, 5)
