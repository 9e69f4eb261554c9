"""The fleet KV tests' engines and wave (``tests/test_torch_kvfleet.py``,
``tests/test_torch_kvfleet_cross.py``): each package's engine of a
preset, built from that package's own preset weights (equal bit for bit)
with the same serving knobs and base key; a wave of greedy and keyed
sampled requests, two sharing a three-block prefix; and what an importer
of that wave should count."""

import jax
import numpy as np

from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task.serve.replica import build_engine as jax_build_engine
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.serving import cache as tcache
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.serve.replica import build_engine
from torch_port_util import CPU, serving_knobs, share_jax_programs

KV_DTYPES = [None, "int8", "fp8", "int4"]


def jax_fleet_engine(preset, client=None, **over):
    jb = jax_build_engine(preset)
    knobs = serving_knobs(preset, **over)
    spec = knobs.get("spec_k", 0) > 0
    return share_jax_programs(JaxServingEngine(
        jb.params, jb.cfg,
        JaxServingConfig(**{**knobs, "decode_impl": "xla"}),
        rng=jax.random.PRNGKey(0), kv_fleet=client,
        draft_params=jb.params if spec else None,
        draft_cfg=jb.cfg if spec else None))


def port_fleet_engine(preset, client=None, **over):
    pb = build_engine(preset, device="cpu")
    knobs = serving_knobs(preset, **over)
    spec = knobs.get("spec_k", 0) > 0
    return ServingEngine(pb.params, pb.cfg, ServingConfig(**knobs),
                         rng=R.PRNGKey(0), device=CPU, kv_fleet=client,
                         draft_params=pb.params if spec else None,
                         draft_cfg=pb.cfg if spec else None)


def fleet_wave(vocab, bs, seed=3, sampled=True):
    """Greedy and (unless ``sampled`` is False) keyed-sampled requests;
    two share a three-block prefix, and one prompt is exactly two blocks
    (its import ends in a copy)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=3 * bs)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, size=2)]),
               rng.integers(0, vocab, size=2 * bs + 3),
               np.concatenate([shared, rng.integers(0, vocab, size=bs + 1)]),
               rng.integers(0, vocab, size=2 * bs),
               rng.integers(0, vocab, size=5)]
    wave = []
    for i, p in enumerate(prompts):
        kw = ({"temperature": 0.9, "top_p": 0.85, "key": [40 + i, 9]}
              if sampled and i % 2 else {})
        wave.append((p.astype(np.int32), 8, kw))
    return wave


def run_wave(engine, wave):
    rids = [engine.submit(p, n, **kw) for p, n, kw in wave]
    out = engine.drain(max_steps=5000)
    return [out[r] for r in rids]


def fleet_counters(engine) -> dict:
    fleet = engine.stats()["kvfleet"]
    return {k: fleet[k] for k in ("hit_blocks", "miss_blocks",
                                  "import_requests", "prefetch_blocks")}


def publish_all(client, engine) -> int:
    return client.publish(engine, limit=10_000)


def expected_imports(wave, bs) -> dict:
    """The ``kvfleet`` counters of an importer of ``wave`` from a bucket
    that holds every full prompt block: a block that an earlier request of
    the wave already brought into the local cache is a local hit."""
    local, hits, requests = set(), 0, 0
    for prompt, _, _ in wave:
        chain = tcache.chain_block_hashes(prompt, bs)
        have = 0
        while have < len(chain) and chain[have] in local:
            have += 1
        hits += len(chain) - have
        requests += len(chain) > have
        local.update(chain)
    return dict(hit_blocks=hits, miss_blocks=0, import_requests=requests,
                prefetch_blocks=0)
