"""LoRA through the port's HTTP replica beside the JAX package's, on the
``micro`` preset at rank 4 on the CPU: ``POST /adapter`` answers JAX's
body and content hash; JAX's ``Router.register_adapter`` over one replica
of each package gets one hash; an adapter stream routed to either replica
is the same stream; ``/stats`` and ``/metrics`` carry JAX's adapter
keys."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from tpu_task.serve.replica import ReplicaServer as JaxReplicaServer
from tpu_task.serve.router import Router
from tpu_task.storage.http_util import default_pool
from tpu_task_torch.serve.replica import ReplicaServer

LORA = {"lora_rank": 4, "n_adapter_blocks": 9}
D_MODEL, N_LAYERS = 32, 2        # the micro preset


class TorchReplica(ReplicaServer):
    """The port's replica on the CPU, purging the JAX transport's sockets
    to its port when it stops."""

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)

    def stop(self) -> None:
        super().stop()
        default_pool().purge(port=self.port)


def call(url, method, path, data=None):
    raw = None if data is None else json.dumps(data).encode()
    request = urllib.request.Request(url + path, data=raw, method=method)
    try:
        with urllib.request.urlopen(request, timeout=30) as response:
            status, head, body = response.status, response.headers, \
                response.read()
    except urllib.error.HTTPError as error:
        status, head, body = error.code, error.headers, error.read()
    if head.get("Content-Type", "").startswith("text/plain"):
        return status, body.decode()
    return status, json.loads(body)


def layers(seed, rank=4):
    rng = np.random.default_rng(seed)
    return [{"a": rng.normal(size=(D_MODEL, rank)).tolist(),
             "b": rng.normal(size=(rank, D_MODEL)).tolist()}
            for _ in range(N_LAYERS)]


@pytest.fixture
def pair():
    """(JAX replica, port replica) on micro with LoRA on, torn down."""
    servers = []
    try:
        servers.append(JaxReplicaServer(preset="micro",
                                        serving=dict(LORA)).start())
        servers.append(TorchReplica(preset="micro",
                                    serving=dict(LORA)).start())
        yield servers
    finally:
        for server in servers:
            server.stop()


@pytest.mark.parametrize("body", [
    {"adapter_id": "a", "layers": layers(1)},
    {"adapter_id": "b", "layers": layers(2, rank=2), "scale": 0.5},
])
def test_adapter_endpoint_answers_jax_body_and_hash(pair, body):
    answers = [call(server.url, "POST", "/adapter", body) for server in pair]
    assert answers[1] == answers[0]
    status, reply = answers[0]
    assert status == 200 and reply["adapter_id"] == body["adapter_id"]
    assert len(reply["hash"]) == 32
    # A re-register of the same bytes answers the same hash; a bad body is
    # a 400 in both.
    assert [call(s.url, "POST", "/adapter", body) for s in pair] == answers
    bad = dict(body, layers=body["layers"][:1])
    assert [call(s.url, "POST", "/adapter", bad)[0] for s in pair] == \
        [400, 400]


def test_router_registers_one_hash_and_routes_adapter_streams(pair):
    """JAX's router broadcasts the adapter to both replicas and gets one
    hash; the same fleet request routed to the JAX replica and to the
    port's gives the same stream, which the adapter changes."""
    jax_replica, port_replica = pair
    members = {name: {"url": s.url, "boot_id": s.boot_id}
               for name, s in (("jax", jax_replica), ("port", port_replica))}
    router = Router(seed=0)
    router.set_replicas(members)
    hashes = router.register_adapter("tenant", layers(3), scale=1.5)
    assert set(hashes) == {"jax", "port"} and len(set(hashes.values())) == 1
    prompt = [5, 9, 2, 44, 17, 3]
    streams = {}
    for name in ("jax", "port"):
        router = Router(seed=0)
        router.set_replicas({name: members[name]})
        fids = [router.submit(prompt, 12, adapter_id="tenant"),
                router.submit(prompt, 12, adapter_id="tenant",
                              temperature=0.8),
                router.submit(prompt, 12)]
        router.drain(deadline_s=120)
        streams[name] = [router.result(f) for f in fids]
    assert streams["port"] == streams["jax"]
    assert all(len(s) == 12 for s in streams["port"])
    assert streams["port"][0] != streams["port"][2]


def test_stats_and_metrics_carry_jax_adapter_keys(pair):
    for server in pair:
        assert call(server.url, "POST", "/adapter",
                    {"adapter_id": "t", "layers": layers(4)})[0] == 200
        status, reply = call(server.url, "POST", "/submit",
                             {"prompt": [1, 2, 3], "max_new_tokens": 4,
                              "adapter_id": "t"})
        assert status == 200
        for _ in range(60):
            if call(server.url, "GET", f"/stream?rid={reply['rid']}"
                    "&offset=0&wait_ms=2000")[1]["status"] == "done":
                break
    stats = [call(s.url, "GET", "/stats")[1]["adapters"] for s in pair]
    assert stats[1] == stats[0]
    assert (stats[1]["registered"], stats[1]["resident"]) == (1, 1)
    series = []
    for server in pair:
        text = call(server.url, "GET", "/metrics")[1]
        series.append({line.split("{")[0].split(" ")[0]
                       for line in text.splitlines()
                       if line.startswith("tpu_task_adapters_")})
    assert series[1] == series[0]
    assert {"tpu_task_adapters_registered", "tpu_task_adapters_loads",
            "tpu_task_adapters_resident"} <= {
        name.removesuffix("_total") for name in series[1]}
