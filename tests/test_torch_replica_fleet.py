"""The JAX package's ``Router`` and ``ServeFleet`` driving the port's HTTP
replica beside a JAX replica, over loopback, on the CPU (``micro``):

- mixed greedy and sampled streams equal one uninterrupted JAX engine fed
  the router's keys;
- a hard kill of the torch replica mid-stream, and a graceful drain in
  each direction (torch → JAX, JAX → torch): the streams are the
  uninterrupted ones, and the router's dispatch spans and both packages'
  engine spans tile the token range of one trace;
- blocks one replica publishes through its ship thread are imported by
  the other's ``POST /prefetch``, in both directions;
- one ``ServeFleet`` whose ``InProcessServeDriver`` builds torch replicas,
  with a graceful kill through `InProcessServeDriver.kill`.

The router talks through the JAX package's pooled keep-alive transport,
so every torch replica purges that pool's sockets to its port when it
stops (the JAX replica does so itself): a later server on a reused
ephemeral port must not inherit a stale socket. Each test starts its own
replicas and stops them in ``finally``."""

import time

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_task.ml.serving.cache import chain_block_hashes
from tpu_task.scheduler import CapacityPool, GangScheduler, TenantQuota
from tpu_task.serve import (
    InProcessServeDriver,
    Router,
    ServeFleet,
    ServeSpec,
    wait_until,
)
from tpu_task.serve.kvfleet import FleetKvClient as JaxFleetKvClient
from tpu_task.serve.replica import ReplicaServer as JaxReplicaServer
from tpu_task.serve.replica import build_engine as jax_build_engine
from tpu_task.storage.backends import LocalBackend as JaxLocalBackend
from tpu_task.storage.http_util import default_pool
from tpu_task_torch.serve.kvfleet import FleetKvClient
from tpu_task_torch.serve.replica import ReplicaServer
from tpu_task_torch.storage.backends import LocalBackend


class TorchReplica(ReplicaServer):
    """The port's replica on the CPU, purging the JAX transport's sockets
    to its port when it stops."""

    def __init__(self, **kwargs):
        kwargs.setdefault("preset", "micro")
        super().__init__(device="cpu", **kwargs)

    def stop(self) -> None:
        super().stop()
        default_pool().purge(port=self.port)


def slow_steps(server, seconds: float = 0.005) -> None:
    """Stand-in engine step that first sleeps with the replica's lock let
    go, so a stream is still open when the test interrupts it (the micro
    preset decodes 24 tokens within a router pump or two) and the
    handlers' ``/stream`` polls get the lock between steps. The JAX
    replica's step loop takes its ``threading.Lock`` straight back after
    a step, so without the pause a waiting handler can miss it for the
    whole request."""
    inner = server.engine.step

    def step():
        server._lock.release()
        try:
            time.sleep(seconds)
        finally:
            server._lock.acquire()
        return inner()

    server.engine.step = step


@pytest.fixture
def servers():
    started = []
    try:
        yield started
    finally:
        for server in started:
            server.stop()


def _endpoints(**named):
    return {name: {"url": s.url, "boot_id": s.boot_id}
            for name, s in named.items()}


def _reference_streams(router, fids):
    """One uninterrupted JAX engine fed the same requests and keys."""
    engine = jax_build_engine("micro")
    rids = {}
    for fid in fids:
        request = router.request(fid)
        rids[fid] = engine.submit(
            request.prompt, request.max_new_tokens,
            temperature=request.temperature, top_p=request.top_p,
            eos_token=request.eos_token,
            key=jnp.asarray(np.asarray(request.key, np.uint32)))
    out = engine.drain()
    return {fid: out[rid] for fid, rid in rids.items()}


def _assert_trace_continuity(router, replicas, fid, n_tokens):
    """One trace end to end: every dispatch span is a child of the
    request's root; the dispatch spans' [token_start, token_end) tile
    [0, n_tokens) once; every engine span of the trace, in either
    package's replica, parent-links to one of those dispatch spans."""
    request = router.request(fid)
    trace_id = request.trace.trace_id
    dispatches = [span for span in router.obs.tracer.finished()
                  if span.name == "dispatch"
                  and span.attrs.get("fid") == fid]
    assert len(dispatches) >= 2, "no re-dispatch recorded"
    assert {span.trace_id for span in dispatches} == {trace_id}
    assert {span.parent_id for span in dispatches} == \
        {request.trace.span_id}
    covered = []
    for span in sorted((s for s in dispatches if "token_end" in s.attrs),
                       key=lambda s: s.attrs["token_start"]):
        covered.extend(range(span.attrs["token_start"],
                             span.attrs["token_end"]))
    assert covered == list(range(n_tokens))
    ids = {span.span_id for span in dispatches}
    engine_spans = [span for server in replicas
                    for span in server.obs.tracer.finished()
                    if span.trace_id == trace_id]
    assert engine_spans, "no replica-side spans joined the trace"
    assert all(span.parent_id in ids for span in engine_spans)
    return engine_spans


def test_replica_fleet_mixed_streams_equal_jax_reference(servers):
    rng = np.random.default_rng(5)
    servers += [JaxReplicaServer(preset="micro").start(),
                TorchReplica().start()]
    router = Router(seed=0)
    router.set_replicas(_endpoints(j=servers[0], t=servers[1]))
    fids = [router.submit(rng.integers(0, 64, size=int(n)), 12,
                          **({"temperature": 0.8, "top_p": 0.9}
                             if i % 2 else {}))
            for i, n in enumerate(rng.integers(3, 12, size=8))]
    out = router.drain(deadline_s=60)
    assert out == _reference_streams(router, fids)
    served = {router.request(fid).replica for fid in fids}
    assert served == {"j", "t"}


def test_replica_fleet_hard_kill_of_torch_replica_mid_stream(servers):
    """Deterministic: the torch replica steps slowly, and the predicate
    kills it at the first token any of its streams delivers."""
    rng = np.random.default_rng(6)
    servers += [JaxReplicaServer(preset="micro").start(),
                TorchReplica().start()]
    jax_replica, torch_replica = servers
    slow_steps(torch_replica)
    router = Router(seed=1, retries=0, timeout=5.0)
    router.set_replicas(_endpoints(t=torch_replica))
    fids = [router.submit(rng.integers(0, 64, size=8), 40,
                          temperature=0.8, top_p=0.9) for _ in range(4)]
    killed = []

    def first_token_then_kill():
        if any(router.request(fid).tokens for fid in fids):
            torch_replica.stop()          # hard: connection refused
            router.set_replicas(_endpoints(t=torch_replica, j=jax_replica))
            killed.append([len(router.request(f).tokens) for f in fids])
            return True
        return False

    assert wait_until(first_token_then_kill, 30, tick=router.pump, period=0)
    assert all(n < 40 for n in killed[0])
    out = router.drain(deadline_s=60)
    assert all(len(out[fid]) == 40 for fid in fids)
    assert out == _reference_streams(router, fids)
    assert router.redispatches >= len(fids)
    for fid in fids:
        assert router.request(fid).dispatches == 2
    victim = max(fids, key=lambda f: killed[0][fids.index(f)])
    _assert_trace_continuity(router, servers, victim, 40)


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_replica_fleet_graceful_drain_hands_off_across_packages(servers,
                                                                direction):
    rng = np.random.default_rng(7)
    servers += [JaxReplicaServer(preset="micro").start(),
                TorchReplica().start()]
    jax_replica, torch_replica = servers
    victim, sibling = (torch_replica, jax_replica) \
        if direction == "torch_to_jax" else (jax_replica, torch_replica)
    slow_steps(victim)
    router = Router(seed=2)
    router.set_replicas(_endpoints(v=victim))
    fid = router.submit(rng.integers(0, 64, size=8), 24, temperature=0.7,
                        top_p=0.95)
    exported = []

    def two_tokens_then_drain():
        if len(router.request(fid).tokens) >= 2:
            exported.extend(victim.begin_drain())
            router.set_replicas(_endpoints(v=victim, s=sibling))
            return True
        return False

    assert wait_until(two_tokens_then_drain, 30, tick=router.pump, period=0)
    record = next(r for r in exported if r["tokens"])
    assert record["key"] is not None and len(record["tokens"]) < 24
    out = router.drain(deadline_s=60)
    assert len(out[fid]) == 24
    assert router.request(fid).dispatches == 2
    assert out == _reference_streams(router, [fid])
    engine_spans = _assert_trace_continuity(router, servers, fid, 24)
    decodes = sorted((s for s in engine_spans if s.name == "engine.decode"),
                     key=lambda s: s.attrs["token_start"])
    assert [s.status for s in decodes] == ["exported", "ok"]
    assert [s.source.split(":")[0] for s in decodes] == ["replica"] * 2
    assert decodes[0].attrs["token_start"] == 0
    assert decodes[0].attrs["token_end"] == decodes[1].attrs["token_start"]


@pytest.mark.parametrize("publisher", ["torch", "jax"])
def test_replica_fleet_published_blocks_prefetch_across_packages(
        servers, tmp_path, publisher):
    bucket = str(tmp_path)
    torch_client = FleetKvClient(LocalBackend(bucket), "t",
                                 refresh_interval=0.0)
    jax_client = JaxFleetKvClient(JaxLocalBackend(bucket), "j",
                                  refresh_interval=0.0)
    servers += [TorchReplica(kv_client=torch_client, kv_publish_every=1,
                             serving={"prefix_cache": True}).start(),
                JaxReplicaServer(preset="micro", kv_client=jax_client,
                                 kv_publish_every=1,
                                 serving={"prefix_cache": True}).start()]
    pub, imp = servers if publisher == "torch" else servers[::-1]
    pub_client = torch_client if publisher == "torch" else jax_client
    prompt = np.random.default_rng(8).integers(0, 64, size=14)
    router = Router(seed=4)
    router.set_replicas(_endpoints(p=pub))
    fid = router.submit(prompt, 6)
    router.drain(deadline_s=60)
    chain = [h.hex() for h in chain_block_hashes(prompt, 4)]
    assert len(chain) == 3
    assert wait_until(
        lambda: set(chain) <= set(pub_client._published), 30, period=0.02)
    body = router._call(router._replicas["p"], "GET", "/stats")
    assert body["kvfleet"]["published_blocks"] >= 3
    router.set_replicas(_endpoints(i=imp))
    imported = router._call(router._replicas["i"], "POST", "/prefetch",
                            data={"hashes": chain})
    assert imported == {"imported": 3}
    again = router._call(router._replicas["i"], "POST", "/prefetch",
                         data={"hashes": chain})
    assert again == {"imported": 0}
    assert imp.stats()["kvfleet"]["prefetch_blocks"] == 3
    # The importer's stream over the prefetched prefix is the publisher's.
    fid2 = router.submit(prompt, 6)
    assert router.drain(deadline_s=60)[fid2] == router.result(fid)
    assert imp.stats()["prefix_cache"]["hit_requests"] == 1


def test_replica_fleet_tick_with_torch_replicas_and_graceful_kill(
        monkeypatch):
    monkeypatch.setenv("TPU_TASK_REQUEUE_BACKOFF_BASE", "0.05")
    monkeypatch.setenv("TPU_TASK_REQUEUE_BACKOFF_CAP", "0.2")
    built = []

    def factory(task):
        import json

        built.append(TorchReplica(
            preset=task.payload.get("preset", "tiny"),
            serving=json.loads(task.payload.get("serving") or "{}")))
        return built[-1]

    driver = InProcessServeDriver(replica_factory=factory)
    scheduler = GangScheduler(CapacityPool([32]),
                              {"svc": TenantQuota(chips=32, weight=1.0)},
                              driver)
    router = Router(seed=3)
    fleet = ServeFleet(scheduler, ServeSpec(service="chat", tenant="svc",
                                            replicas=2, preset="micro"),
                       router)
    try:
        fleet.launch()
        fleet.tick()
        assert len(router.replicas()) == 2 and len(built) == 2
        for server in built:
            slow_steps(server)
        rng = np.random.default_rng(9)
        fids = [router.submit(rng.integers(0, 64, size=8), 16,
                              **({"temperature": 0.8} if i % 2 else {}))
                for i in range(4)]
        assert wait_until(
            lambda: all(router.request(fid).tokens for fid in fids),
            30, tick=router.pump, period=0)
        victim = router.request(fids[0]).replica
        assert driver.kill(victim, graceful=True)
        out = router.drain(deadline_s=60, on_idle=fleet.tick)
        assert all(len(out[fid]) == 16 for fid in fids)
        assert out == _reference_streams(router, fids)
        assert router.redispatches > 0
    finally:
        for task_id in list(driver.running_ids()):
            driver._stop(task_id, graceful=False)
