"""The port's serving engine on mixture-of-experts configs against the
JAX package's engine, at fp32 on the CPU, from the same weights.

Two models: the ``moe`` replica preset (4 experts, top-1, on its second
layer) and a top-2 config whose every layer is a 4-expert MoE layer. One
wave (greedy requests, two of them sharing a prefix, and keyed sampled
ones) runs through both packages on each route: K 1 and 4, int8, int4
and fp8 pools, ``spec_k`` 2 with the model as its own MoE draft, the
overlapped loop, a two-adapter LoRA wave, a host KV tier under a pool too
small for the wave (run twice, so that demoted blocks come back), and a
weight roll with streams of both generations in the slots, and blocks a
JAX MoE engine published imported through the fleet KV seam. Greedy streams are equal token for token, sampled
ones key for key, and every value both ``stats()`` compute is equal.
Also: a torch replica on the ``moe`` preset answers a request with JAX's
engine's stream."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task.serve.kvfleet import FleetKvClient as JaxFleetKvClient
from tpu_task.serve.replica import build_engine as jax_build_engine
from tpu_task.storage.backends import LocalBackend as JaxLocalBackend
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.serve.kvfleet import FleetKvClient
from tpu_task_torch.serve.replica import ReplicaServer
from tpu_task_torch.storage.backends import LocalBackend
from torch_port_util import CPU, jax_model, port_model, share_jax_programs

#: Every layer a 4-expert top-2 MoE layer.
TOP2 = jtf.TransformerConfig(
    vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8, d_ff=48,
    n_kv_heads=2, dtype=jnp.float32, moe_every=1, n_experts=4, moe_top_k=2)
KNOBS = dict(slots=4, block_size=4, n_blocks=64, max_len=48)
#: (ServingConfig overrides) per route.
ROUTES = {
    "k1": {},
    "k4": {"micro_k": 4},
    "int8": {"kv_dtype": "int8"},
    "int4": {"kv_dtype": "int4"},
    "fp8": {"kv_dtype": "fp8"},
    "spec2": {"spec_k": 2},
    "overlap": {"overlap": True},
}
IMPL_KEYS = {"decode_impl", "draft_decode_impl"}
RANK = 4


@pytest.fixture(scope="module")
def models():
    """name → (JAX cfg, JAX params, port cfg, port params)."""
    out = {}
    jcfg, jparams = jax_model("moe")
    out["preset"] = (jcfg, jparams, *port_model(jcfg, jparams))
    jparams = jtf.init(jax.random.PRNGKey(1), TOP2)
    out["top2"] = (TOP2, jparams, *port_model(TOP2, jparams))
    return out


def _engines(model, over, bucket=None):
    """(JAX engine, port engine) of ``model`` with ``over``; with
    ``bucket``, each holds a fleet client on that directory."""
    jcfg, jparams, cfg, params = model
    knobs = {**KNOBS, **over}
    spec = knobs.get("spec_k", 0) > 0
    clients = (None, None) if bucket is None else (
        JaxFleetKvClient(JaxLocalBackend(bucket), "j", refresh_interval=0.0),
        FleetKvClient(LocalBackend(bucket), "p", refresh_interval=0.0))
    jax_engine = share_jax_programs(JaxServingEngine(
        jparams, jcfg, JaxServingConfig(**knobs, decode_impl="xla"),
        rng=jax.random.PRNGKey(3), kv_fleet=clients[0],
        draft_params=jparams if spec else None,
        draft_cfg=jcfg if spec else None))
    port = ServingEngine(params, cfg, ServingConfig(**knobs),
                         rng=R.PRNGKey(3), device=CPU, kv_fleet=clients[1],
                         draft_params=params if spec else None,
                         draft_cfg=cfg if spec else None)
    return jax_engine, port


def _wave(engine, adapters=()):
    """Greedy and keyed-sampled requests; with ``adapters``, request i
    decodes under adapter i % (len + 1) (the last share: the base)."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 64, size=8)
    prompts = [np.concatenate([shared, rng.integers(0, 64, size=3)]),
               rng.integers(0, 64, size=6), shared,
               rng.integers(0, 64, size=13), rng.integers(0, 64, size=3),
               np.concatenate([shared, rng.integers(0, 64, size=5)])]
    ids = list(adapters) + [None]
    rids = []
    for i, prompt in enumerate(prompts):
        kw = ({"temperature": 0.9, "top_p": 0.95, "key": [40 + i, 7]}
              if i % 2 else {})
        if adapters:
            kw["adapter_id"] = ids[i % len(ids)]
        rids.append(engine.submit(prompt, 10, **kw))
    out = engine.drain(max_steps=5000)
    return [list(out[r]) for r in rids]


def _shared_values(jax_stats: dict, port_stats: dict):
    keys = set(jax_stats) - IMPL_KEYS
    return ({k: jax_stats[k] for k in keys},
            {k: port_stats[k] for k in keys})


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("model", ["preset", "top2"])
def test_moe_engine_streams_and_stats_equal_jax(models, model, route):
    jax_engine, port = _engines(models[model], ROUTES[route])
    want = _wave(jax_engine)
    assert _wave(port) == want
    assert all(len(s) == 10 for s in want)
    jax_stats, port_stats = _shared_values(jax_engine.stats(), port.stats())
    assert port_stats == jax_stats
    if route == "spec2":
        assert port_stats["spec"]["proposed"] > 0
    if route == "k4":
        assert port.stats()["micro_steps"] > 0


def _adapter(seed):
    rng = np.random.default_rng(seed)
    return [{"a": rng.normal(size=(32, RANK)), "b": rng.normal(size=(RANK, 32))}
            for _ in range(2)]


@pytest.mark.parametrize("model", ["preset", "top2"])
def test_moe_lora_wave_equals_jax(models, model):
    """Two adapters and base streams in one batch over MoE layers: the
    adapter branch wraps the MoE block as it wraps a dense one."""
    jax_engine, port = _engines(
        models[model], {"lora_rank": RANK, "n_adapter_blocks": 9})
    adapters = {"a": _adapter(1), "b": _adapter(2)}
    for engine in (jax_engine, port):
        for aid, layers in adapters.items():
            engine.register_adapter(aid, layers, scale=1.5)
    want = _wave(jax_engine, adapters)
    got = _wave(port, adapters)
    assert got == want
    # The adapters change the streams: request 0 (adapter a) and request 2
    # (the base) share their prompt's first 8 tokens only, so compare the
    # base against a LoRA-free engine instead.
    base = _wave(_engines(models[model], {})[1])
    assert got[2] == base[2] and got[0] != base[0]
    jax_stats, port_stats = _shared_values(jax_engine.stats(), port.stats())
    assert port_stats == jax_stats


@pytest.mark.parametrize("model", ["preset", "top2"])
def test_moe_host_tier_equals_jax(models, model):
    """A host KV tier on a 14-block pool, the wave twice: the second
    promotes what the first demoted. Streams and ``stats()`` equal
    JAX's."""
    jax_engine, port = _engines(models[model], {
        "n_blocks": 14, "host_offload_blocks": 64})
    want = [_wave(jax_engine), _wave(jax_engine)]
    assert [_wave(port), _wave(port)] == want
    jax_stats, port_stats = _shared_values(jax_engine.stats(), port.stats())
    assert port_stats == jax_stats
    tiering = port_stats["tiering"]
    assert tiering["demoted_blocks"] > 0 and tiering["promoted_blocks"] > 0


@pytest.mark.parametrize("model", ["preset", "top2"])
def test_moe_weight_roll_equals_jax(models, model):
    """Two streams (greedy, sampled) under the first weights, a roll to
    new MoE weights once each holds 3 tokens, two new streams (the slots
    hold all four, so no stream waits in the queue across the roll): the
    old streams finish under their weights, and streams and ``stats()``
    equal JAX's."""
    jcfg = models[model][0]
    jnew = jtf.init(jax.random.PRNGKey(9), jcfg)
    _, new = port_model(jcfg, jnew)
    jax_engine, port = _engines(models[model], {})
    streams = {}
    for engine, params in ((jax_engine, jnew), (port, new)):
        rids = [engine.submit(np.arange(3, 12), 9),
                engine.submit(np.arange(5, 10), 8, temperature=0.9,
                              key=[5, 6])]
        while min(len(engine.request(r).tokens) for r in rids) < 3:
            engine.step()
        engine.adopt_params(params, generation=1)
        rids += [engine.submit(np.arange(2, 9), 7),
                 engine.submit(np.arange(7, 13), 6, temperature=0.7,
                               key=[7, 8])]
        out = engine.drain(max_steps=5000)
        streams[engine is port] = [list(out[r]) for r in rids]
    assert streams[True] == streams[False]
    jax_stats, port_stats = _shared_values(jax_engine.stats(), port.stats())
    assert port_stats == jax_stats
    assert port_stats["adapters"]["param_swaps"] == 1


@pytest.mark.parametrize("model", ["preset", "top2"])
def test_moe_fleet_seam_equals_jax(models, model, tmp_path):
    """A JAX MoE engine publishes its hot blocks into a bucket; a JAX and
    a port MoE engine on that bucket import them for the same wave: the
    same blocks imported, streams equal token for token."""
    publisher, _ = _engines(models[model], {}, str(tmp_path))
    _wave(publisher)
    assert publisher._fleet.publish(publisher, limit=100) > 0
    jax_engine, port = _engines(models[model], {}, str(tmp_path))
    assert _wave(port) == _wave(jax_engine)
    hits = [e.stats()["kvfleet"]["hit_blocks"] for e in (jax_engine, port)]
    assert hits[0] == hits[1] > 0


def test_moe_replica_answers_a_request():
    """A torch replica on the moe preset (the JAX package's weights, bit
    for bit: tests/test_torch_preset_weights.py) answers over HTTP with
    JAX's engine's stream, greedy and keyed sampled."""
    from test_torch_replica import call

    prompts = [([5, 9, 2, 33, 7], {}),
               ([1, 2, 3], {"temperature": 0.8, "key": [3, 4]})]
    ref = jax_build_engine("moe", serving={"decode_impl": "xla"})
    want = []
    for prompt, kw in prompts:
        rid = ref.submit(np.asarray(prompt), 8, **{
            k: (np.asarray(v, np.uint32) if k == "key" else v)
            for k, v in kw.items()})
        want.append(list(ref.drain()[rid]))
    server = ReplicaServer(preset="moe", device="cpu").start()
    try:
        for (prompt, kw), stream in zip(prompts, want):
            status, _, body = call(server.url, "POST", "/submit",
                                   {"prompt": prompt, "max_new_tokens": 8,
                                    **kw})
            assert status == 200, body
            deadline = time.monotonic() + 60
            got = {"status": None}
            while got["status"] != "done":
                assert time.monotonic() < deadline
                _, _, got = call(server.url, "GET",
                                 f"/stream?rid={body['rid']}&offset=0"
                                 "&wait_ms=2000")
            assert got["tokens"] == stream
    finally:
        server.stop()
