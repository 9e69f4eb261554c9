"""The port's host KV tier on the paths beside the plain soak
(``tests/test_torch_tiering_engine.py``), against the JAX package's
tiered engine on the ``micro`` preset at fp32 on the CPU:

- speculative decoding (``spec_k`` 2, the target as its own draft) and a
  LoRA-mixed session wave (adapter sessions skip the prefix cache, and
  with it the tier, both ways), streams and tier counters equal JAX's;
- ``prefetch_chain`` with no fleet client promotes a demoted and evicted
  chain from host RAM, and the next admission is a pure prefix hit;
- a 3-block tier spills into a local bucket through the port's
  ``FleetKvClient``, and a JAX sibling engine imports the spilled chain
  with the streams of a fresh JAX engine;
- under the overlapped loop, the demote passes' host time lands in
  ``overlapped_host_s``, never in the host gap;
- a port replica with ``--serving '{"host_offload_blocks": 64}'`` answers
  ``/prefetch`` from host RAM and carries ``tiering`` in ``/stats`` and
  the JAX replica's ``tier.*`` names in ``/metrics``."""

import json
import time
import urllib.request

import numpy as np
import pytest

from tpu_task.serve.kvfleet import FleetKvClient as JaxFleetKvClient
from tpu_task.serve.replica import ReplicaServer as JaxReplicaServer
from tpu_task.storage.backends import LocalBackend as JaxLocalBackend
from tpu_task_torch.ml.serving.cache import chain_block_hashes
from tpu_task_torch.serve.kvfleet import FleetKvClient
from tpu_task_torch.serve.replica import ReplicaServer
from tpu_task_torch.storage.backends import LocalBackend
from torch_kvfleet_util import jax_fleet_engine, port_fleet_engine
from torch_tiering_util import (
    SOAK,
    assert_turns_equal,
    jax_engine,
    port_engine,
    run_sessions,
    sampled_odd,
    session_context,
)


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_spec_k2_with_the_tier_matches_jax(sampled):
    kw = dict(n_sessions=6, turns=3)
    if sampled:
        kw["kwargs"] = sampled_odd
    got = run_sessions(port_fleet_engine("micro", **SOAK, spec_k=2), **kw)
    want = run_sessions(jax_fleet_engine("micro", **SOAK, spec_k=2), **kw)
    assert_turns_equal(got, want)
    tiering = got[-1][1]["tiering"]
    assert tiering["demoted_blocks"] > 0 and tiering["promoted_blocks"] > 0


RANK = 4


def _adapter(seed: int):
    rng = np.random.default_rng(seed)
    return [{"a": rng.normal(size=(32, RANK)),
             "b": rng.normal(size=(RANK, 32))} for _ in range(2)]


def test_lora_mixed_sessions_with_the_tier_match_jax():
    """Sessions 1 and 4 decode under adapters, the rest under the base
    model: the adapter streams neither read nor seed the prefix cache,
    so only base sessions demote and promote."""
    knobs = dict(SOAK, lora_rank=RANK, n_adapter_blocks=9)
    engines = [port_engine(**knobs), jax_engine(**knobs)]
    for engine in engines:
        engine.register_adapter("t1", _adapter(1), scale=1.5)
        engine.register_adapter("t4", _adapter(4), scale=0.5)

    def kwargs(s, t):
        return {"adapter_id": f"t{s}"} if s in (1, 4) else {}

    got, want = (run_sessions(e, n_sessions=8, kwargs=kwargs)
                 for e in engines)
    assert_turns_equal(got, want)
    assert engines[0].stats()["adapters"] == engines[1].stats()["adapters"]
    tiering = got[-1][1]["tiering"]
    assert tiering["demoted_blocks"] > 0 and tiering["promoted_blocks"] > 0
    # The adapter sessions' prompts were never cached, so never demoted.
    for s in (1, 4):
        first = chain_block_hashes(session_context(s), 4)[0]
        assert first not in engines[0]._host_tier
        assert not engines[0]._pcache.has(first)


def _churn_and_prefetch(engine):
    prompt = np.arange(2, 14, dtype=np.int32)
    rid = engine.submit(prompt, max_new_tokens=4)
    first = list(engine.drain()[rid])
    run_sessions(engine, n_sessions=6, turns=2)
    hashes = chain_block_hashes(prompt, engine.scfg.block_size)
    missing = [h for h in hashes if not engine._pcache.has(h)]
    n = engine.prefetch_chain(hashes)
    hit = all(engine._pcache.has(h) for h in hashes)
    before = engine.prefix_hit_requests
    rid = engine.submit(prompt, max_new_tokens=4)
    again = list(engine.drain()[rid])
    return dict(first=first, again=again, missing=len(missing), imported=n,
                hit=hit, prefix_hit=engine.prefix_hit_requests - before,
                tiering=engine.stats()["tiering"])


def test_prefetch_chain_promotes_host_to_device_with_no_fleet():
    """``tests/test_kv_tiering.py``'s prefetch case: churn until the
    prompt's chain is demoted and evicted from the pool, then a prefetch
    hint brings it back from host RAM, and the next admission of the
    prompt is a pure local prefix hit with the first stream."""
    knobs = dict(SOAK, host_offload_blocks=64)
    got = _churn_and_prefetch(port_engine(**knobs))
    want = _churn_and_prefetch(jax_engine(**knobs))
    assert got == want
    assert got["missing"] > 0 and got["imported"] > 0 and got["hit"]
    assert got["prefix_hit"] == 1 and got["again"] == got["first"]
    assert got["tiering"]["promoted_blocks"] >= got["imported"]


def test_spill_lands_in_the_bucket_and_a_jax_sibling_imports_it(tmp_path):
    client = FleetKvClient(LocalBackend(str(tmp_path)), "ra",
                           refresh_interval=0.0)
    engine = port_engine(kv_client=client, **dict(
        SOAK, host_offload_blocks=3))
    run_sessions(engine, n_sessions=8, turns=2)
    tiering = engine.stats()["tiering"]
    assert tiering["host_spilled_blocks"] > 0, tiering
    assert tiering["host_dropped_blocks"] == 0
    assert tiering["host_resident_blocks"] == 3
    assert client.published_blocks > 0
    # A cold JAX sibling on the same bucket imports the spilled chain of
    # session 0's first prompt, with a fresh JAX engine's stream.
    sibling = jax_engine(kv_client=JaxFleetKvClient(
        JaxLocalBackend(str(tmp_path)), "rb", refresh_interval=0.0),
        n_blocks=64, max_len=64)
    fresh = jax_engine(n_blocks=64, max_len=64)
    prompt = np.arange(1, 9, dtype=np.int32)
    outs = []
    for e in (sibling, fresh):
        rid = e.submit(prompt, max_new_tokens=4)
        outs.append(list(e.drain()[rid]))
    assert outs[0] == outs[1]
    assert sibling.fleet_hit_blocks > 0


def test_overlapped_demotion_lands_in_the_covered_window():
    """Each demote pass and force that moves blocks is slowed by 20 ms:
    all of it shows up as overlapped host time, none as host gap."""
    engine = port_engine(**dict(SOAK, overlap=True))
    slowed = []
    for name in ("_demote_pass", "_finalize_demotions"):
        inner = getattr(engine, name)

        def slow(inner=inner, name=name):
            before = (engine.demoted_blocks, len(engine._pending_demotions))
            inner()
            if (engine.demoted_blocks,
                    len(engine._pending_demotions)) != before:
                time.sleep(0.02)
                slowed.append(name)

        setattr(engine, name, slow)
    run_sessions(engine, n_sessions=6, turns=2)
    goodput = engine.stats()["goodput"]
    added = 0.02 * len(slowed)
    assert {"_demote_pass", "_finalize_demotions"} <= set(slowed)
    assert goodput["overlapped_host_s"] >= added
    assert goodput["host_s"] < added / 4


def _call(url, method, path, data=None):
    raw = None if data is None else json.dumps(data).encode()
    request = urllib.request.Request(url + path, data=raw, method=method)
    with urllib.request.urlopen(request, timeout=30) as response:
        body = response.read()
        if response.headers.get("Content-Type", "").startswith("text/plain"):
            return body.decode()
        return json.loads(body)


def _generate(url, prompt, max_new):
    rid = _call(url, "POST", "/submit", {"prompt": [int(t) for t in prompt],
                                         "max_new_tokens": max_new})["rid"]
    tokens = []
    while True:
        out = _call(url, "GET", f"/stream?rid={rid}&offset={len(tokens)}"
                    "&wait_ms=500")
        tokens += out["tokens"]
        if out["status"] == "done":
            return tokens


def _tier_names(text: str) -> set:
    return {line.split("{")[0].split(" ")[0] for line in text.splitlines()
            if line.startswith("tpu_task_tier_")}


def test_replica_prefetches_from_host_ram_and_exports_tier_metrics():
    """Both packages' replicas with ``host_offload_blocks`` 64 on an
    18-block pool: after churn, ``/prefetch`` of a demoted and evicted
    chain imports it from host RAM (no ``--kv-bucket``), the streams
    agree, ``/stats`` carries ``tiering`` and ``/metrics`` the same
    ``tier.*`` names."""
    serving = {"n_blocks": 18, "max_len": 64, "host_offload_blocks": 64}
    results = []
    servers = []
    try:
        servers.append(ReplicaServer(preset="micro", device="cpu",
                                     serving=serving).start())
        servers.append(JaxReplicaServer(preset="micro",
                                        serving=serving).start())
        for server in servers:
            prompt = np.arange(2, 14)
            first = _generate(server.url, prompt, 4)
            for s in range(6):
                _generate(server.url, np.arange(20 + 5 * s, 32 + 5 * s), 4)
            hashes = [h.hex() for h in chain_block_hashes(prompt, 4)]
            imported = _call(server.url, "POST", "/prefetch",
                             {"hashes": hashes})["imported"]
            again = _generate(server.url, prompt, 4)
            stats = _call(server.url, "GET", "/stats")
            results.append(dict(first=first, again=again, imported=imported,
                                tiering=stats["tiering"],
                                names=_tier_names(_call(server.url, "GET",
                                                        "/metrics"))))
    finally:
        for server in servers:
            server.stop()
    port, jax = results
    assert port["imported"] > 0 and port["again"] == port["first"]
    assert port["first"] == jax["first"] and port["again"] == jax["again"]
    assert port["imported"] == jax["imported"]
    assert port["tiering"]["enabled"]
    assert port["tiering"].keys() == jax["tiering"].keys()
    assert port["tiering"]["promoted_blocks"] >= port["imported"]
    assert port["names"] == jax["names"]
    assert {"tpu_task_tier_demoted_blocks", "tpu_task_tier_promoted_blocks",
            "tpu_task_tier_host_resident_blocks"} <= {
        name.removesuffix("_total") for name in port["names"]}
