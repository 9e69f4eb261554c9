"""The port's HTTP replica (``tpu_task_torch.serve.replica.ReplicaServer``)
against the JAX package's on the same table of requests: each answers with
the same status code and the same JSON keys (valid, malformed, missing
field, unknown rid and path, draining, overloaded, ``/degrade``,
``/adapter``, ``/prefetch`` with a bad hash, a second ``/profile``), and
``/healthz``, ``/stats``, ``/export``, ``/obs`` and ``/metrics`` have the
same shape. Both replicas run the ``micro`` preset on the CPU, each on its
own ephemeral port, torn down in ``finally``."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tpu_task.serve.replica import ReplicaServer as JaxReplicaServer
from tpu_task.serve.replica import build_engine as jax_build_engine
from tpu_task_torch.obs import SLA_HEADER, TRACE_HEADER
from tpu_task_torch.serve.replica import ReplicaServer

#: Keys only the port's stats() has: the device, the graphs' counters,
#: the kernels' launch counts.
PORT_ONLY_STATS = {"device", "step_graph", "attention_launches"}


def call(url, method, path, data=None, headers=None):
    """(status, headers, body) of one request; body parsed as JSON unless
    it is the Prometheus text."""
    raw = None if data is None else (
        data if isinstance(data, bytes) else json.dumps(data).encode())
    request = urllib.request.Request(url + path, data=raw, method=method,
                                     headers=headers or {})
    try:
        with urllib.request.urlopen(request, timeout=30) as response:
            status, head, body = response.status, response.headers, \
                response.read()
    except urllib.error.HTTPError as error:
        status, head, body = error.code, error.headers, error.read()
    if head.get("Content-Type", "").startswith("text/plain"):
        return status, head, body.decode()
    return status, head, json.loads(body)


@pytest.fixture
def pair(tmp_path):
    """(JAX replica, port replica) on micro, started, torn down."""
    servers = []
    try:
        servers.append(JaxReplicaServer(
            preset="micro", profile_dir=str(tmp_path / "jax")).start())
        servers.append(ReplicaServer(
            preset="micro", device="cpu",
            profile_dir=str(tmp_path / "port")).start())
        yield servers
    finally:
        for server in servers:
            server.stop()


#: (method, path, body): the request table both replicas answer alike.
TABLE = [
    ("POST", "/submit", {"prompt": [1, 2, 3], "max_new_tokens": 4}),
    ("POST", "/submit", {"prompt": [1, 2, 3], "max_new_tokens": 4,
                         "temperature": 0.7, "key": [3, 4]}),
    ("POST", "/submit", {"prompt": [1], "max_new_tokens": 2,
                         "key": [1, 2, 3]}),
    ("POST", "/submit", {"prompt": [1], "max_new_tokens": 2,
                         "key": "not-a-key"}),
    ("POST", "/submit", {"prompt": [1, 2]}),
    ("POST", "/submit", {"max_new_tokens": 2}),
    ("POST", "/submit", {"prompt": [1, 2], "max_new_tokens": 2,
                         "tokens": [5]}),
    ("POST", "/submit", {"prompt": [1, 2], "max_new_tokens": 100}),
    ("POST", "/submit", b"{not json"),
    ("GET", "/poll?rid=999", None),
    ("GET", "/poll?rid=x", None),
    ("GET", "/poll", None),
    ("GET", "/stream?rid=999&offset=0", None),
    ("GET", "/nope", None),
    ("POST", "/nope", {}),
    ("POST", "/degrade", {"spec": False}),
    ("POST", "/degrade", {}),
    ("POST", "/adapter", {"adapter_id": "a", "layers": []}),
    ("POST", "/adapter", {}),
    ("POST", "/prefetch", {"hashes": ["zz-not-hex"]}),
    ("POST", "/prefetch", {"hashes": ["00" * 16]}),
    ("POST", "/prefetch", {}),
]


def test_replica_request_table_matches_jax(pair):
    answers = []
    for server in pair:
        rows = []
        for method, path, body in TABLE:
            status, _, reply = call(server.url, method, path, body)
            rows.append((method, path, status, sorted(reply)))
        answers.append(rows)
    assert answers[1] == answers[0]
    codes = {row[2] for row in answers[0]}
    # A non-integer rid on a GET is a 500 in both (the GET arm maps only a
    # missing rid to 404).
    assert codes == {200, 400, 404, 500}


def test_replica_refuses_out_of_vocab_prompts_where_jax_admits_them(pair):
    """The one answer that differs: the port's engine checks token ids at
    submission (a CUDA gather asserts where XLA clamps), so an
    out-of-vocabulary prompt is a 400 here, not a stream of clamped
    embeddings."""
    body = {"prompt": [99], "max_new_tokens": 2}
    assert call(pair[0].url, "POST", "/submit", body)[0] == 200
    status, _, reply = call(pair[1].url, "POST", "/submit", body)
    assert status == 400 and "[0, 64)" in reply["error"]


def test_replica_trace_and_sla_headers_reach_the_engine(pair):
    for server in pair:
        status, _, reply = call(
            server.url, "POST", "/submit",
            {"prompt": [4, 5, 6], "max_new_tokens": 3},
            {TRACE_HEADER: "feedbeef:cafe0001",
             SLA_HEADER: "premium;60000"})
        assert status == 200
        request = server.engine.request(reply["rid"])
        assert request.trace.to_header() == "feedbeef:cafe0001"
        assert request.slo_class == "premium" and request.deadline
        call(server.url, "GET",
             f"/stream?rid={reply['rid']}&offset=0&wait_ms=2000")


def test_replica_streams_and_shapes_match_jax(pair):
    replies = []
    for server in pair:
        _, _, sub = call(server.url, "POST", "/submit",
                         {"prompt": [7, 8, 9, 10], "max_new_tokens": 6,
                          "temperature": 0.9, "top_p": 0.8, "key": [7, 1]})
        tokens, status = [], "queued"
        while status != "done":
            _, _, part = call(
                server.url, "GET",
                f"/stream?rid={sub['rid']}&offset={len(tokens)}"
                f"&wait_ms=2000")
            assert part["offset"] == len(tokens)
            tokens += part["tokens"]
            status = part["status"]
        _, _, again = call(server.url, "GET",
                           f"/stream?rid={sub['rid']}&offset=2")
        assert again["tokens"] == tokens[2:]
        shapes = {}
        for path in ("/healthz", "/stats", "/export", "/obs",
                     f"/poll?rid={sub['rid']}"):
            status, _, body = call(server.url, "GET", path)
            assert status == 200
            shapes[path.split("?")[0]] = set(body)
        shapes["/stats"] -= PORT_ONLY_STATS
        _, head, text = call(server.url, "GET", "/metrics")
        assert head["Content-Type"].startswith("text/plain; version=0.0.4")
        assert "_engine_ttft_s_bucket{le=\"+Inf\"} " in text
        replies.append((tokens, shapes))
    assert replies[1] == replies[0]


def test_replica_draining_and_overloaded_answer_429_as_jax(tmp_path):
    servers = []
    try:
        for cls, kw in ((JaxReplicaServer, {}),
                        (ReplicaServer, {"device": "cpu"})):
            servers.append(cls(preset="micro", serving={"max_queue": 0},
                               **kw).start())
            servers.append(cls(preset="micro", drain_file=str(
                tmp_path / f"{cls.__module__}.json"), **kw).start())
        answers = []
        for full, draining in (servers[:2], servers[2:]):
            status, head, body = call(full.url, "POST", "/submit",
                                      {"prompt": [1], "max_new_tokens": 2})
            row = [(status, head.get("Retry-After"), sorted(body))]
            status, _, body = call(draining.url, "POST", "/drain", {})
            row.append((status, None, sorted(body)))
            status, head, body = call(draining.url, "POST", "/submit",
                                      {"prompt": [1], "max_new_tokens": 2})
            row.append((status, head.get("Retry-After"), sorted(body)))
            _, _, health = call(draining.url, "GET", "/healthz")
            row.append(health["draining"])
            answers.append(row)
        assert answers[1] == answers[0]
        assert answers[0][0][:2] == (429, "0") and \
            answers[0][2][:2] == (429, "0")
        for draining in servers[1::2]:
            with open(draining.drain_file) as handle:
                assert set(json.load(handle)) == {"boot_id", "inflight"}
    finally:
        for server in servers:
            server.stop()


def test_replica_second_profile_is_409_as_jax(pair):
    answers = []
    for server in pair:
        first = call(server.url, "GET", "/profile?ms=1500")
        second = call(server.url, "GET", "/profile?ms=100")
        answers.append([(first[0], sorted(first[2])),
                        (second[0], sorted(second[2]))])
        server._profile_thread.join(timeout=30)
        assert not server._profile_thread.is_alive()
    assert answers[1] == answers[0] == [(200, ["dir", "ms", "ok"]),
                                        (409, ["error"])]
    # Off the card the port's capture records the host alone and its
    # file says so.
    import os

    port_dir = call(pair[1].url, "GET", "/profile?ms=10")[2]["dir"]
    pair[1]._profile_thread.join(timeout=30)
    assert os.listdir(port_dir) == ["trace-cpu.json"]


def test_replica_profile_hands_the_step_loop_to_a_thread_it_traces(
        tmp_path):
    """Once the capture records, the step loop moves to a new thread at a
    step boundary (the profiler keeps the kernels of a thread that starts
    inside it), and the replica serves on, over and over: no error, no
    drain, and each request's stream is the one a replica that never
    profiled gives."""
    import threading

    body = {"prompt": [1, 2, 3], "max_new_tokens": 12, "temperature": 0.7,
            "key": [3, 4]}
    plain = ReplicaServer(preset="micro", device="cpu").start()
    server = ReplicaServer(preset="micro", device="cpu",
                           profile_dir=str(tmp_path)).start()
    try:
        rid = plain.submit(body)
        want = plain.stream(rid, 0, wait_ms=2000)
        while want["status"] != "done":
            want = plain.stream(rid, 0, wait_ms=2000)
        threads = [server._step_thread]
        for _ in range(3):
            rid = server.submit(body)
            assert call(server.url, "GET", "/profile?ms=50")[0] == 200
            got = server.stream(rid, 0, wait_ms=2000)
            while got["status"] != "done":
                got = server.stream(rid, 0, wait_ms=2000)
            assert got["tokens"] == want["tokens"]
            server._profile_thread.join(timeout=30)
            threads.append(server._step_thread)
        assert len({id(t) for t in threads}) == 4
        assert threads[-1].is_alive() and not any(
            t.is_alive() for t in threads[:-1])
        assert threading.active_count() < 64
        assert server.step_error is None and not server.draining
        assert call(server.url, "GET", "/healthz")[2]["ok"]
    finally:
        plain.stop()
        server.stop()


def test_replica_refuses_what_is_not_ported():
    # Meshes are ported (ROADMAP A14's serving half): a tp gang and the moe
    # preset's expert-parallel gang start, serve the JAX engine's streams
    # and stop their followers with the replica.
    assert ReplicaServer(preset="moe", device="cpu").engine.cfg.n_experts == 4
    prompt = np.arange(1, 7)
    for preset, tp, ep in (("micro", 2, 1), ("moe", 1, 2)):
        server = ReplicaServer(preset=preset, device="cpu", tp=tp, ep=ep)
        procs = server.engine.mesh.gang.procs
        try:
            server.start()
            rid = call(server.url, "POST", "/submit",
                       {"prompt": prompt.tolist(),
                        "max_new_tokens": 5})[2]["rid"]
            deadline = time.monotonic() + 60
            while True:
                done = call(server.url, "GET", f"/poll?rid={rid}")[2]
                if done["status"] == "done" or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
            reference = jax_build_engine(preset)
            want = reference.submit(prompt, 5)
            assert done["tokens"] == reference.drain()[want]
            stats = call(server.url, "GET", "/stats")[2]
            assert (stats["tp"], stats["ep"]) == (tp, ep)
        finally:
            server.stop()
        assert all(proc.poll() is not None for proc in procs)


def test_replica_fair_lock_excludes_under_many_threads():
    import sys
    import threading
    import time

    from tpu_task_torch.serve.replica import FairLock

    lock, total = FairLock(), [0]

    def add():
        for _ in range(300):
            with lock:
                value = total[0]
                time.sleep(0)
                total[0] = value + 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=add) for _ in range(16)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert total[0] == 16 * 300
    with pytest.raises(RuntimeError):
        lock.release()


def test_replica_busy_drains_mid_backlog(tmp_path):
    """A replica with a backlog answers ``/drain`` within a step or so,
    not once its queue is empty: the records hold the queued requests.
    (With ``threading.Lock`` the step loop takes the lock straight back
    after each step, and this drain exported nothing.)"""
    import numpy as np

    server = ReplicaServer(preset="tiny", device="cpu",
                           serving={"slots": 1},
                           drain_file=str(tmp_path / "inflight.json"))
    try:
        server.start()
        rng = np.random.default_rng(3)
        for i in range(8):
            call(server.url, "POST", "/submit",
                 {"prompt": rng.integers(0, 256, size=10).tolist(),
                  "max_new_tokens": 64, "key": [i, 1]})
        call(server.url, "GET", "/stream?rid=0&offset=0&wait_ms=2000")
        status, _, _ = call(server.url, "POST", "/drain", {})
        records = server.exported()
    finally:
        server.stop()
    assert status == 200
    assert len(records) >= 4
    assert sum(not record["tokens"] for record in records) >= 3


def test_replica_step_loop_failure_drains_and_is_recorded():
    """A step that raises drains the replica (the router fails its
    streams over) and leaves the traceback and an error count behind, so
    a caller can tell it from a drain it asked for."""
    import time

    server = ReplicaServer(preset="micro", device="cpu")

    def broken_step():
        raise RuntimeError("kernel launch failed")

    server.engine.step = broken_step
    try:
        server.start()
        status, _, _ = call(server.url, "POST", "/submit",
                            {"prompt": [1, 2], "max_new_tokens": 3})
        deadline = time.monotonic() + 30
        while not server.draining and time.monotonic() < deadline:
            time.sleep(0.01)
        _, _, health = call(server.url, "GET", "/healthz")
        _, _, obs = call(server.url, "GET", "/obs")
    finally:
        server.stop()
    assert status == 200 and health["draining"]
    assert "kernel launch failed" in server.step_error
    assert obs["metrics"]["replica.errors"]["value"] == 1
    assert [s["attrs"]["exc_type"] for s in obs["spans"]
            if s["status"] == "error"] == ["RuntimeError"]


def test_replica_listen_backlog_takes_a_burst_of_clients():
    """Sixteen or more clients connecting at once (a router's pump, a
    fleet of pollers) must all be taken in by the kernel while the accept
    thread is busy: socketserver's default backlog of 5 drops (or, on some
    hosts, resets) the rest. The server here never accepts, so every
    connection that completes is one the backlog held."""
    import socket

    server = ReplicaServer(preset="micro", device="cpu")
    sockets = []
    try:
        for _ in range(32):
            sockets.append(socket.create_connection(
                ("127.0.0.1", server.port), timeout=2.0))
    finally:
        for sock in sockets:
            sock.close()
        server.stop()
    assert len(sockets) == 32
