"""Paged LoRA adapters in the port's serving engine against the JAX
package's engine, at fp32 on the CPU, on ``tests/test_lora.py``'s GQA
``TINY`` config with the JAX weights (``params_from_jax``), rank 4.

The 8-adapter mixed wave (a base stream beside eight tenants) runs through
both packages: greedy and keyed sampled, fp32 and int8 pools, ``micro_k``
4 and ``spec_k`` 2 (the target as its own draft). Every stream equals the
JAX engine's token for token and the port's own dedicated single-adapter
engine's, the base stream equals a LoRA-free engine's, and
``stats()["adapters"]`` equals the JAX engine's. Also: JAX's validation
messages, LRU eviction and reload through a fleet bucket (within the port
and across the packages, both ways), the prefix-cache rule, export and
resume across the packages, and a weight roll with an adapter stream in
flight."""

import pathlib
import tempfile

import jax
import numpy as np
import pytest

from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task.serve.kvfleet import FleetKvClient as JaxFleetKvClient
from tpu_task.storage.backends import LocalBackend as JaxLocalBackend
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.serve.kvfleet import FleetKvClient
from tpu_task_torch.storage.backends import LocalBackend
from torch_port_util import CPU, port_model, share_jax_programs

TINY = jtf.TransformerConfig(
    vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8, d_ff=64,
    dtype=jax.numpy.float32, n_kv_heads=2)
RANK = 4
N_ADAPTERS = 8
MAX_NEW = 10
#: The (kv_dtype, micro_k, spec_k) cases of the mixed wave.
CASES = [(None, 1, 0), ("int8", 1, 0), (None, 4, 0), (None, 1, 2)]


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port cfg, port params) and a second generation of
    each, drawn from another key."""
    jparams = jtf.init(jax.random.PRNGKey(0), TINY)
    jnew = jtf.init(jax.random.PRNGKey(9), TINY)
    cfg, params = port_model(TINY, jparams)
    _, new = port_model(TINY, jnew)
    return dict(jax=jparams, jax_new=jnew, cfg=cfg, port=params,
                port_new=new)


def _knobs(**over):
    knobs = dict(slots=10, block_size=4, n_blocks=96, max_len=48,
                 lora_rank=RANK, n_adapter_blocks=40)
    knobs.update(over)
    return knobs


def jax_engine(w, params=None, client=None, seed=2, **over):
    knobs = _knobs(**over)
    spec = knobs.get("spec_k", 0) > 0
    params = w["jax"] if params is None else params
    return share_jax_programs(JaxServingEngine(
        params, TINY, JaxServingConfig(**knobs, decode_impl="xla"),
        rng=jax.random.PRNGKey(seed), kv_fleet=client,
        draft_params=params if spec else None,
        draft_cfg=TINY if spec else None))


def port_engine(w, params=None, client=None, seed=2, **over):
    knobs = _knobs(**over)
    spec = knobs.get("spec_k", 0) > 0
    params = w["port"] if params is None else params
    return ServingEngine(
        params, w["cfg"], ServingConfig(**knobs, decode_impl="reference"),
        rng=R.PRNGKey(seed), device=CPU, kv_fleet=client,
        draft_params=params if spec else None,
        draft_cfg=w["cfg"] if spec else None)


def adapter(seed, rank=RANK):
    """Full-scale normal A/B pairs, strong enough to flip the tiny model's
    argmax (``tests/test_lora.py``'s ``_adapter``)."""
    rng = np.random.default_rng(seed)
    return [{"a": rng.normal(size=(TINY.d_model, rank)),
             "b": rng.normal(size=(rank, TINY.d_model))}
            for _ in range(TINY.n_layers)]


ADAPTERS = {f"tenant-{i}": adapter(100 + i) for i in range(N_ADAPTERS)}


def mixed_wave(sampled: bool):
    """(adapter id or None, prompt, submit kwargs): the base stream, then
    one request a tenant."""
    rng = np.random.default_rng(17)
    wave = []
    for i, aid in enumerate([None] + list(ADAPTERS)):
        kw = ({"temperature": 0.8, "top_p": 0.9, "key": [300 + i, 5]}
              if sampled else {})
        wave.append((aid, rng.integers(0, 64, size=5 + i % 3), kw))
    return wave


def run_wave(engine, wave, adapters=ADAPTERS, scale=1.5):
    for aid, layers in adapters.items():
        engine.register_adapter(aid, layers, scale=scale)
    rids = [engine.submit(prompt, MAX_NEW, adapter_id=aid, **kw)
            for aid, prompt, kw in wave]
    out = engine.drain()
    return [list(out[r]) for r in rids]


def _run(engine, prompt, n, **kw):
    rid = engine.submit(prompt, n, **kw)
    return list(engine.drain()[rid])


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv_dtype,micro_k,spec_k", CASES)
def test_mixed_wave_matches_jax_and_dedicated_engines(
        weights, kv_dtype, micro_k, spec_k, sampled):
    over = dict(kv_dtype=kv_dtype, micro_k=micro_k, spec_k=spec_k)
    wave = mixed_wave(sampled)
    jeng = jax_engine(weights, **over)
    port = port_engine(weights, **over)
    want = run_wave(jeng, wave)
    got = run_wave(port, wave)
    assert got == want
    assert all(len(s) == MAX_NEW for s in got)
    ps, js = port.stats()["adapters"], jeng.stats()["adapters"]
    assert ps == js
    assert (ps["registered"], ps["resident"], ps["loads"]) == (8, 8, 8)
    # Each stream equals a dedicated engine holding its adapter alone;
    # the base stream's is a LoRA-free engine.
    for (aid, prompt, kw), stream in zip(wave, got):
        if aid is None:
            alone = port_engine(weights, lora_rank=0, n_adapter_blocks=0,
                                **over)
        else:
            alone = port_engine(weights, **over)
            alone.register_adapter(aid, ADAPTERS[aid], scale=1.5)
        assert _run(alone, prompt, MAX_NEW, adapter_id=aid, **kw) == \
            stream, f"stream for {aid!r} diverged"
    # The adapters bite.
    assert any(s != got[0] for s in got[1:])


def test_adapterless_stream_equals_lora_free_engine(weights):
    """A LoRA engine serving base traffic alone, with an adapter resident
    in the pool, gives the LoRA-free engine's streams (the drop rule runs
    the same program), in both packages."""
    prompt = np.random.default_rng(1).integers(0, 64, size=6)
    sampled = dict(temperature=0.9, key=[4, 4])
    plain = port_engine(weights, lora_rank=0, n_adapter_blocks=0, seed=1)
    for make in (port_engine, jax_engine):
        lora = make(weights, seed=1)
        lora.register_adapter("tenant-a", adapter(11))
        lora.submit(prompt, 2, adapter_id="tenant-a")   # makes it resident
        lora.drain()
        assert lora.stats()["adapters"]["resident"] == 1
        for kw in ({}, sampled):
            assert _run(lora, prompt, 12, **kw) == _run(plain, prompt, 12,
                                                         **kw)


def test_validation_errors_equal_jax(weights):
    messages = {}

    def expect(name, fn, match):
        with pytest.raises(ValueError, match=match) as info:
            fn()
        messages.setdefault(name, []).append(str(info.value))

    for make in (port_engine, jax_engine):
        plain = make(weights, lora_rank=0, n_adapter_blocks=0, seed=3)
        expect("register", lambda: plain.register_adapter("t", adapter(1)),
               "lora_rank")
        expect("submit", lambda: plain.submit([1, 2], 4, adapter_id="t"),
               "lora_rank")
        eng = make(weights, seed=3)
        expect("ghost", lambda: eng.submit([1, 2], 4, adapter_id="ghost"),
               "unknown adapter")
        expect("short", lambda: eng.register_adapter(
            "short", adapter(1)[:1]), "layers")
        expect("rank", lambda: eng.register_adapter(
            "wide", adapter(1, rank=RANK + 1)), "exceeds the pool rank")
        expect("host_copy", lambda: eng.register_adapter(
            "c", adapter(22), host_copy=False), "host_copy")
        layers = adapter(4)
        assert eng.register_adapter("t", layers) == \
            eng.register_adapter("t", layers)
        assert eng.stats()["adapters"]["registered"] == 1
        small = make(weights, n_adapter_blocks=2, seed=3)
        expect("pool", lambda: small.register_adapter("t", layers),
               "raise n_adapter_blocks")
        # Other weights under an id a stream decodes under.
        eng.submit([1, 2, 3], 4, adapter_id="t")
        eng.step()
        expect("busy", lambda: eng.register_adapter("t", adapter(5)),
               "re-registered")
    for name, (port_msg, jax_msg) in messages.items():
        assert port_msg == jax_msg, name


def _evict_reload(engine, client, prompt):
    """``tests/test_lora.py``'s pool of one resident adapter: "a" runs,
    "b" evicts it, "a" reloads from the bucket."""
    ha = engine.register_adapter("a", adapter(20), host_copy=False)
    engine.register_adapter("b", adapter(21), host_copy=False)
    assert client.fetch_adapter(ha) is not None
    streams = [_run(engine, prompt, 8, adapter_id=aid)
               for aid in ("a", "b", "a")]
    return ha, streams


@pytest.mark.parametrize("micro_k", [1, 4])
def test_evict_and_reload_through_a_bucket(weights, micro_k):
    prompt = np.random.default_rng(4).integers(0, 64, size=6)
    runs = {}
    errors = []
    for name, make, client_cls, backend_cls in (
            ("port", port_engine, FleetKvClient, LocalBackend),
            ("jax", jax_engine, JaxFleetKvClient, JaxLocalBackend)):
        root = tempfile.mkdtemp()
        client = client_cls(backend_cls(root), "r0", refresh_interval=0.0)
        eng = make(weights, client=client, n_adapter_blocks=3, seed=4,
                   micro_k=micro_k)
        pool = getattr(eng, "_lora_pool")
        ha, streams = _evict_reload(eng, client, prompt)
        runs[name] = (ha, streams, eng.stats()["adapters"])
        if name == "port":
            # The pool is written in place, never rebound.
            assert eng._lora_pool is pool
            assert client.bytes_fetched > 0 and client.bytes_shipped > 0
        # With its bucket object gone, the evicted "b" refuses to load.
        for path in pathlib.Path(root).glob("**/adapters/*"):
            path.unlink()
        eng.submit(prompt, 4, adapter_id="b")
        with pytest.raises(RuntimeError, match="unavailable") as info:
            eng.step()
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    (ha, streams, stats), (jha, jstreams, jstats) = runs["port"], runs["jax"]
    assert ha == jha and streams == jstreams
    assert streams[2] == streams[0] != streams[1]
    assert stats == jstats
    assert stats["loads"] >= 3 and stats["evictions"] >= 2
    assert stats["resident"] == 1


@pytest.mark.parametrize("shipper", ["jax", "port"])
def test_adapter_reloads_across_the_packages(weights, shipper):
    """One package's engine ships the adapters (``host_copy=False``) into
    a bucket directory; the other package's engine, bound to the same
    directory, registers the same adapters (the bytes are there: nothing
    moves) and loads them from that bucket, with the same streams and
    counts as the shipper."""
    root = tempfile.mkdtemp()
    prompt = np.random.default_rng(5).integers(0, 64, size=7)
    clients = {
        "jax": JaxFleetKvClient(JaxLocalBackend(root), "j",
                                refresh_interval=0.0),
        "port": FleetKvClient(LocalBackend(root), "p", refresh_interval=0.0)}
    makes = {"jax": jax_engine, "port": port_engine}
    loader = "port" if shipper == "jax" else "jax"
    runs = {}
    for name in (shipper, loader):
        eng = makes[name](weights, client=clients[name],
                          n_adapter_blocks=3, seed=5)
        runs[name] = (_evict_reload(eng, clients[name], prompt),
                      eng.stats()["adapters"])
    assert clients[shipper].bytes_shipped > 0
    assert clients[loader].bytes_shipped == 0
    assert clients[loader].bytes_fetched > 0
    assert runs["port"] == runs["jax"]


def test_adapter_requests_skip_the_prefix_cache(weights):
    prompt = np.random.default_rng(6).integers(0, 64, size=12)
    got = {}
    for name, make in (("port", port_engine), ("jax", jax_engine)):
        eng = make(weights, seed=5)
        eng.register_adapter("t", adapter(30), scale=2.0)
        tuned = _run(eng, prompt, 8, adapter_id="t")
        base = _run(eng, prompt, 8)                     # after the tuned run
        ref = make(weights, prefix_cache=False, seed=5)
        assert base == _run(ref, prompt, 8)             # not poisoned
        assert tuned != base
        got[name] = (tuned, base, eng.stats()["prefix_cache"]["hit_requests"])
    assert got["port"] == got["jax"]
    assert got["port"][2] == 0


def _export_adapter_stream(engine):
    layers = adapter(40)
    engine.register_adapter("t", layers, scale=1.5)
    prompt = np.random.default_rng(8).integers(0, 64, size=6)
    rids = [engine.submit(prompt, 10, adapter_id="t"),
            engine.submit(prompt[:4], 9, adapter_id="t", temperature=0.9,
                          key=[8, 1]),
            engine.submit(prompt[1:], 8)]
    while min(len(engine._requests[r].tokens) for r in rids) < 4:
        engine.step()
    records = engine.export_inflight()
    out = engine.drain()
    return records, {r: list(out[r]) for r in rids}, layers


@pytest.mark.parametrize("exporter", ["jax", "port"])
def test_export_resume_crosses_the_packages(weights, exporter):
    makes = {"jax": jax_engine, "port": port_engine}
    importer = "port" if exporter == "jax" else "jax"
    records, streams, layers = _export_adapter_stream(
        makes[exporter](weights, seed=8))
    assert {r.get("adapter_id") for r in records} == {"t", None}
    other = makes[importer](weights, seed=8)
    other.register_adapter("t", layers, scale=1.5)
    mapping = other.resume_inflight(records)
    out = other.drain()
    assert {rid: list(out[mapping[rid]]) for rid in mapping} == \
        {r["rid"]: streams[r["rid"]] for r in records}
    # The importer must hold the adapter, and a LoRA-free one refuses.
    pinned = [r for r in records if r.get("adapter_id")]
    for name, match in (("register_adapter on the importer", "bare"),
                        ("lora_rank 0", "plain")):
        messages = []
        for make in (port_engine, jax_engine):
            eng = (make(weights, seed=8) if match == "bare" else
                   make(weights, lora_rank=0, n_adapter_blocks=0, seed=8))
            with pytest.raises(ValueError, match=name) as info:
                eng.resume_inflight(pinned)
            messages.append(str(info.value))
        assert messages[0] == messages[1]


def _roll(engine, new_params):
    """An adapter stream and a base stream until each holds 3 tokens, a
    roll to generation 7, then an adapter stream under the new weights
    and a sampled one under another tenant."""
    rng = np.random.default_rng(12)
    engine.register_adapter("t", adapter(50), scale=1.5)
    engine.register_adapter("u", adapter(51))
    old, new = rng.integers(0, 64, size=6), rng.integers(0, 64, size=7)
    rids = [engine.submit(old, 12, adapter_id="t"), engine.submit(old, 10)]
    while min(len(engine._requests[r].tokens) for r in rids) < 3:
        engine.step()
    engine.adopt_params(new_params, generation=7)
    rids += [engine.submit(new, 8, adapter_id="t"),
             engine.submit(new[:5], 9, adapter_id="u", temperature=0.7,
                           key=[7, 8])]
    out = engine.drain()
    return [list(out[r]) for r in rids]


@pytest.mark.parametrize("micro_k", [1, 4])
def test_roll_with_adapter_streams_matches_jax(weights, micro_k):
    port = port_engine(weights, micro_k=micro_k, seed=6)
    jeng = jax_engine(weights, micro_k=micro_k, seed=6)
    got = _roll(port, weights["port_new"])
    assert got == _roll(jeng, weights["jax_new"])
    assert [len(s) for s in got] == [12, 10, 8, 9]
    assert port.stats()["adapters"] == jeng.stats()["adapters"]
    assert set(port._gen_params) == {7}
