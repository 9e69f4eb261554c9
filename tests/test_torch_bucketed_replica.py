"""A bucketed-prefill replica of the port beside a JAX one, on the CPU
(``micro``, ``--serving '{"prefill": "bucketed", "prefix_cache": false,
"prefill_buckets": [...]}'``):

- in process, the JAX package's ``Router`` over both replicas: mixed
  greedy and sampled streams equal one JAX bucketed engine fed the
  router's keys, and a prompt past the last bucket is refused by both
  replicas with the same status and body;
- ``python -m tpu_task_torch.serve.replica`` as a process with the
  bucketed serving dict answers with the JAX bucketed engine's stream."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from tpu_task.serve import Router
from tpu_task.serve.replica import ReplicaServer as JaxReplicaServer
from tpu_task.serve.replica import build_engine as jax_build_engine
from tpu_task.storage.http_util import default_pool
from tpu_task_torch.serve.replica import ReplicaServer
from test_torch_replica import call

ROOT = Path(__file__).resolve().parents[1]
SERVING = {"prefill": "bucketed", "prefix_cache": False,
           "prefill_buckets": [8, 16, 32, 48]}


def reference_stream(prompt, max_new, **kw):
    """One stream of a JAX bucketed engine on the micro preset."""
    engine = jax_build_engine("micro", serving=SERVING)
    rid = engine.submit(np.asarray(prompt), max_new, **kw)
    return list(engine.drain()[rid])


def test_bucketed_replicas_serve_the_jax_streams():
    rng = np.random.default_rng(8)
    jax_replica = JaxReplicaServer(preset="micro", serving=SERVING).start()
    port = ReplicaServer(preset="micro", serving=SERVING,
                         device="cpu").start()
    try:
        router = Router(seed=0)
        router.set_replicas({
            name: {"url": s.url, "boot_id": s.boot_id}
            for name, s in (("j", jax_replica), ("t", port))})
        fids = [router.submit(rng.integers(0, 64, size=int(n)), 10,
                              **({"temperature": 0.8, "top_p": 0.9}
                                 if i % 2 else {}))
                for i, n in enumerate(rng.integers(1, 39, size=8))]
        out = router.drain(deadline_s=60)
        for fid in fids:
            request = router.request(fid)
            assert out[fid] == reference_stream(
                request.prompt, request.max_new_tokens,
                temperature=request.temperature, top_p=request.top_p,
                key=jnp.asarray(np.asarray(request.key, np.uint32)))
        assert {router.request(fid).replica for fid in fids} == {"j", "t"}
        _, _, stats = call(port.url, "GET", "/stats")
        assert stats["prefills"] > 0 and stats["chunk_steps"] == 0
        # 48 tokens fit max_len with no room to decode; 49 pass the last
        # bucket: both replicas refuse each alike.
        for n in (48, 49):
            answers = [call(s.url, "POST", "/submit",
                            {"prompt": [1] * n, "max_new_tokens": 1})
                       for s in (jax_replica, port)]
            assert answers[0][0] == answers[1][0] == 400
            assert answers[0][2] == answers[1][2]
    finally:
        jax_replica.stop()
        port.stop()
        default_pool().purge(port=port.port)


def test_replica_main_serves_bucketed(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), TPU_TASK_SERVE_LINGER="0.1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_task_torch.serve.replica", "--device",
         "cpu", "--preset", "micro", "--serving", json.dumps(SERVING)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        endpoint = tmp_path / "endpoint.json"
        deadline = time.monotonic() + 60
        while not endpoint.exists():
            assert proc.poll() is None, proc.communicate()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        url = json.loads(endpoint.read_text())["url"]
        prompt = list(range(3, 33))
        status, _, body = call(url, "POST", "/submit",
                               {"prompt": prompt, "max_new_tokens": 12,
                                "temperature": 0.8, "key": [9, 4]})
        assert status == 200, body
        got = {"status": None}
        while got["status"] != "done":
            assert time.monotonic() < deadline + 60
            _, _, got = call(url, "GET", f"/stream?rid={body['rid']}"
                             "&offset=0&wait_ms=2000")
        assert got["tokens"] == reference_stream(
            prompt, 12, temperature=0.8, key=jnp.asarray([9, 4], jnp.uint32))
        _, _, stats = call(url, "GET", "/stats")
        assert (stats["prefills"], stats["chunk_steps"]) == (1, 0)
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
    assert proc.returncode == 0
