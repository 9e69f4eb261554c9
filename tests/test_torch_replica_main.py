"""``python -m tpu_task_torch.serve.replica`` as a process, on the CPU
(``--device cpu --preset micro``): it announces ``endpoint.json`` with the
JAX replica's keys, serves over HTTP, drains on SIGTERM into
``inflight.json`` records that the JAX package's engine resumes with the
uninterrupted JAX streams, exits 0, and leaves ``obs/`` files that the
JAX package's ``read_spans``/``read_metrics`` read. What the port does not
have (an object-store bucket) exits non-zero at argv time naming its
ROADMAP item; ``--ckpt-dir``, the ``moe`` preset and ``--tp``/``--ep``
gangs are accepted."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_task.obs import read_metrics, read_spans
from tpu_task.serve.replica import build_engine as jax_build_engine
from tpu_task.storage.backends import LocalBackend as JaxLocalBackend
from torch_gang_util import alive, children

ROOT = Path(__file__).resolve().parents[1]


def _replica(cwd, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               TPU_TASK_SERVE_LINGER="0.1")
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_task_torch.serve.replica", *args],
        cwd=str(cwd), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _post(url, path, body):
    request = urllib.request.Request(url + path,
                                     data=json.dumps(body).encode(),
                                     method="POST")
    with urllib.request.urlopen(request, timeout=30) as response:
        return json.loads(response.read())


def test_replica_main_announces_drains_on_sigterm_and_exports_obs(tmp_path):
    proc = _replica(tmp_path, "--device", "cpu", "--preset", "micro",
                    "--serving", json.dumps({"slots": 1}))
    try:
        endpoint = tmp_path / "endpoint.json"
        deadline = time.monotonic() + 60
        while not endpoint.exists():
            assert proc.poll() is None, proc.communicate()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        announce = json.loads(endpoint.read_text())
        assert set(announce) == {"url", "boot_id", "preset", "pid",
                                 "generation"}
        assert announce["pid"] == proc.pid and announce["preset"] == "micro"
        assert announce["generation"] == 0
        rng = np.random.default_rng(12)
        prompts = [rng.integers(0, 64, size=6).tolist() for _ in range(4)]
        for i, prompt in enumerate(prompts):
            _post(announce["url"], "/submit", {
                "prompt": prompt, "max_new_tokens": 40,
                "temperature": 0.8 if i % 2 else 0.0, "key": [i, 77]})
        # One slot: at least three requests are still queued or mid-stream.
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    drained = json.loads((tmp_path / "inflight.json").read_text())
    assert drained["boot_id"] == announce["boot_id"]
    records = drained["inflight"]
    assert len(records) >= 3

    # JAX's engine resumes the port's records with the uninterrupted JAX
    # streams of the same requests and keys.
    reference = jax_build_engine("micro", serving={"slots": 1})
    want = {}
    for i, prompt in enumerate(prompts):
        rid = reference.submit(prompt, 40, temperature=0.8 if i % 2 else 0.0,
                               key=jnp.asarray(np.asarray([i, 77],
                                                          np.uint32)))
        want[rid] = reference.drain()[rid]
    resumed = jax_build_engine("micro", serving={"slots": 1})
    mapping = resumed.resume_inflight(records)
    got = resumed.drain()
    for record in records:
        assert got[mapping[record["rid"]]] == want[record["rid"]]

    spans = read_spans(JaxLocalBackend(str(tmp_path)))
    names = {span.name for span in spans}
    assert {"engine.queue", "engine.prefill", "engine.decode"} <= names
    assert any(span.status == "exported" for span in spans)
    assert all(span.source.startswith("replica:") for span in spans)
    metrics = read_metrics(JaxLocalBackend(str(tmp_path)))
    assert metrics["engine.ttft_s"]["count"] >= 1
    assert metrics["goodput.tokens_emitted"]["value"] > 0


@pytest.mark.parametrize("argv,item", [
    (["--kv-bucket", ":googlecloudstorage:bucket/kv"], "A11c"),
    # Ported: a tp x ep gang of ranks behind the one engine (ROADMAP A14's
    # serving half).
    (["--tp", "2"], None),
    (["--preset", "moe", "--ep", "2"], None),
    # Ported: the moe preset at one device.
    (["--preset", "moe"], None),
    # Ported: JAX's argv, accepted (the roll itself:
    # tests/test_torch_hot_swap_replica.py).
    (["--ckpt-dir", "ckpts"], None),
])
def test_replica_main_refuses_what_is_not_ported(tmp_path, argv, item):
    proc = _replica(tmp_path, "--device", "cpu", "--preset", "micro", *argv)
    if item is None:
        try:
            endpoint = tmp_path / "endpoint.json"
            deadline = time.monotonic() + 60
            while not endpoint.exists():
                assert proc.poll() is None, proc.communicate()
                assert time.monotonic() < deadline
                time.sleep(0.05)
            assert json.loads(endpoint.read_text())["generation"] == 0
            # A gang replica's followers (one per rank past the first)
            # stop with it.
            followers = children(proc.pid)
            width = int(argv[argv.index("--tp") + 1] if "--tp" in argv
                        else argv[argv.index("--ep") + 1] if "--ep" in argv
                        else 1)
            assert len(followers) == width - 1
            proc.send_signal(signal.SIGTERM)
            proc.communicate(timeout=60)
            assert proc.returncode == 0
            assert not any(alive(pid) for pid in followers)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        return
    _, err = proc.communicate(timeout=60)
    assert proc.returncode != 0
    assert item in err
    assert not (tmp_path / "endpoint.json").exists()
