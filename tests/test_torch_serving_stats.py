"""``stats()`` parity of the port's serving engine with the JAX package's:
every key of JAX's ``stats()`` is in the port's, at every depth, and after
the same wave every value both engines compute is equal — the schedule
counters, the KV byte figures, the prefix-cache, spec, kvfleet, tiering
and adapter groups. Only the attention's name differs (``"xla"`` against
the plain version's ``"reference"``), and the port adds keys of its own
(``device``, ``step_graph``, ``attention_launches``, ``goodput``)."""

import tempfile

import jax
import numpy as np
import pytest

from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task.serve.kvfleet import FleetKvClient as JaxFleetKvClient
from tpu_task.serve.replica import build_engine as jax_build_engine
from tpu_task.storage.backends import LocalBackend as JaxLocalBackend
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.serve.kvfleet import FleetKvClient
from tpu_task_torch.serve.replica import build_engine
from tpu_task_torch.storage.backends import LocalBackend
from torch_port_util import CPU, serving_knobs, share_jax_programs

#: Keys whose values name the implementation, not a count.
IMPL_KEYS = {"decode_impl", "draft_decode_impl"}
PORT_ONLY = {"device", "step_graph", "attention_launches", "goodput"}

CONFIGS = {
    "default": {},
    "int8_tight_pool": {"kv_dtype": "int8", "n_blocks": 14},
    "int4": {"kv_dtype": "int4"},
    "micro_k4": {"micro_k": 4},
    "spec_k2": {"spec_k": 2},
    "prefill_slots2": {"prefill_slots": 2},
}


def _engines(preset, over, fleet):
    """(JAX engine, port engine) from each package's preset weights, with
    a fleet client each (own buckets) when ``fleet``."""
    knobs = serving_knobs(preset, **over)
    spec = knobs.get("spec_k", 0) > 0
    jb, pb = jax_build_engine(preset), build_engine(preset, device="cpu")
    jclient = pclient = None
    if fleet:
        jclient = JaxFleetKvClient(JaxLocalBackend(tempfile.mkdtemp()), "j",
                                   refresh_interval=0.0)
        pclient = FleetKvClient(LocalBackend(tempfile.mkdtemp()), "p",
                                refresh_interval=0.0)
    jax_engine = share_jax_programs(JaxServingEngine(
        jb.params, jb.cfg, JaxServingConfig(**{**knobs, "decode_impl": "xla"}),
        rng=jax.random.PRNGKey(0), kv_fleet=jclient,
        draft_params=jb.params if spec else None,
        draft_cfg=jb.cfg if spec else None))
    port = ServingEngine(pb.params, pb.cfg, ServingConfig(**knobs),
                         rng=R.PRNGKey(0), device=CPU, kv_fleet=pclient,
                         draft_params=pb.params if spec else None,
                         draft_cfg=pb.cfg if spec else None)
    return (jax_engine, jclient), (port, pclient)


def _wave(engine, bs):
    """Greedy requests, three sharing a two-block prefix, and one
    keyed-sampled request."""
    rng = np.random.default_rng(8)
    vocab = engine.cfg.vocab_size
    shared = rng.integers(0, vocab, size=2 * bs)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, size=3)]),
               rng.integers(0, vocab, size=bs + 2), shared,
               np.concatenate([shared, rng.integers(0, vocab, size=bs)]),
               rng.integers(0, vocab, size=4)]
    rids = [engine.submit(p, 9, **({"temperature": 0.8, "key": [3, 4]}
                                    if i == 1 else {}))
            for i, p in enumerate(prompts)]
    out = engine.drain(max_steps=5000)
    return [out[r] for r in rids]


def _key_tree(tree) -> dict:
    return {k: _key_tree(v) if isinstance(v, dict) else None
            for k, v in tree.items()}


def _missing(want: dict, have: dict, path=()) -> list:
    out = []
    for key, sub in want.items():
        if key not in have:
            out.append("/".join(path + (key,)))
        elif sub is not None:
            out += _missing(sub, have[key] or {}, path + (key,))
    return out


def _shared_values(jax_stats: dict, port_stats: dict) -> tuple:
    """Every value of JAX's ``stats()`` but the implementation names, and
    the port's values under the same keys."""
    keys = set(jax_stats) - IMPL_KEYS
    return ({k: jax_stats[k] for k in keys},
            {k: port_stats[k] for k in keys})


@pytest.mark.parametrize("fleet", [False, True], ids=["local", "kvfleet"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_stats_key_tree_contains_jax(config, fleet):
    (jax_engine, _), (port, _) = _engines("micro", CONFIGS[config], fleet)
    assert _missing(_key_tree(jax_engine.stats()),
                    _key_tree(port.stats())) == []
    _wave(jax_engine, 4), _wave(port, 4)
    jax_stats, port_stats = jax_engine.stats(), port.stats()
    assert _missing(_key_tree(jax_stats), _key_tree(port_stats)) == []
    assert set(port_stats) - set(jax_stats) == PORT_ONLY


@pytest.mark.parametrize("preset", ["micro", "tiny"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_stats_counters_equal_jax_after_the_same_wave(preset, config):
    """The same wave through both engines, each with a fleet client that
    publishes its hot blocks afterwards: equal streams, and every value
    both ``stats()`` compute is equal, before and after the publish."""
    bs = serving_knobs(preset)["block_size"]
    (jax_engine, jclient), (port, pclient) = _engines(
        preset, CONFIGS[config], True)
    assert _wave(port, bs) == _wave(jax_engine, bs)
    want, got = _shared_values(jax_engine.stats(), port.stats())
    assert got == want
    assert pclient.publish(port, limit=1000) == jclient.publish(
        jax_engine, limit=1000) > 0
    want, got = _shared_values(jax_engine.stats(), port.stats())
    assert got == want
    assert got["kvfleet"]["bytes_shipped"] > 0
    if config == "int8_tight_pool":
        assert got["recompute_preemptions"] > 0


def test_stats_report_what_is_not_ported_as_off():
    # The overlapped loop is ported (ROADMAP A5): a default engine reports
    # it off and unflushed, as JAX's does (tests/test_torch_overlap_*.py
    # hold an overlapped engine's values).
    stats = build_engine("micro", device="cpu").stats()
    assert (stats["tp"], stats["ep"], stats["overlap"],
            stats["overlap_flushes"], stats["generation"]) == (1, 1, False,
                                                               0, 0)
    assert stats["tiering"]["enabled"] is False
    assert stats["kvfleet"]["enabled"] is False
    # LoRA is ported (ROADMAP A7): off at lora_rank 0, and a LoRA engine's
    # adapter group equals JAX's after the same registrations and wave.
    assert stats["adapters"]["enabled"] is False
    lora = {"lora_rank": 4, "n_adapter_blocks": 9}
    engines = (jax_build_engine("micro", serving=lora),
               build_engine("micro", serving=lora, device="cpu"))
    rng = np.random.default_rng(2)
    layers = [{"a": rng.normal(size=(32, 2)), "b": rng.normal(size=(2, 32))}
              for _ in range(2)]
    groups = []
    for engine in engines:
        engine.register_adapter("t", layers, scale=0.5)
        engine.register_adapter("u", layers[::-1])
        engine.submit([1, 2, 3, 4, 5], 6, adapter_id="t")
        engine.submit([6, 7, 8], 4)
        engine.drain()
        groups.append(engine.stats()["adapters"])
    assert groups[1] == groups[0]
    assert groups[1]["enabled"] is True
    assert (groups[1]["registered"], groups[1]["resident"],
            groups[1]["loads"]) == (2, 1, 1)
    assert stats["kv_pool_bytes_per_shard"] == stats["kv_pool_bytes"]
