"""The bucketed-prefill engine tests' engines and wave
(``tests/test_torch_bucketed_engine.py``,
``tests/test_torch_bucketed_quant.py``): each package's bucketed engine of
a preset from the same weights and base key, and one wave of greedy and
keyed-sampled requests."""

import jax
import numpy as np

from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from torch_port_util import (CPU, jax_model, port_model, serving_knobs,
                             share_jax_programs)

PRESETS = ("tiny", "micro", "moe")
IMPL_KEYS = {"decode_impl", "draft_decode_impl"}
#: The bucketed knobs over each preset's serving knobs: the largest bucket
#: is the preset's max_len.
BUCKETED = {"tiny": dict(prefill="bucketed", prefix_cache=False,
                         prefill_buckets=(16, 32, 64, 128)),
            "micro": dict(prefill="bucketed", prefix_cache=False,
                          prefill_buckets=(8, 16, 32, 48))}
BUCKETED["moe"] = BUCKETED["micro"]
#: The wave's new tokens a request: the fourth asks for one.
WAVE_NEW = [6, 6, 6, 1, 6, 6, 6, 6]


def preset_models() -> dict:
    """preset → (JAX cfg, JAX params, port cfg, port params)."""
    out = {}
    for preset in PRESETS:
        jcfg, jparams = jax_model(preset)
        out[preset] = (jcfg, jparams, *port_model(jcfg, jparams))
    return out


def engines(model, preset, over, seed=4):
    """(JAX engine, port engine) of ``model`` with the bucketed knobs of
    ``preset`` and ``over``; a ``spec_k`` engine drafts with itself."""
    jcfg, jparams, cfg, params = model
    knobs = serving_knobs(preset, **BUCKETED[preset], **over)
    spec = knobs.get("spec_k", 0) > 0
    jax_engine = share_jax_programs(JaxServingEngine(
        jparams, jcfg, JaxServingConfig(**knobs, decode_impl="xla"),
        rng=jax.random.PRNGKey(seed), draft_params=jparams if spec else None,
        draft_cfg=jcfg if spec else None))
    port = ServingEngine(params, cfg, ServingConfig(**knobs),
                         rng=R.PRNGKey(seed), device=CPU,
                         draft_params=params if spec else None,
                         draft_cfg=cfg if spec else None)
    return jax_engine, port


def wave(engine):
    """Eight requests on a four-slot engine: greedy and keyed-sampled (every
    second one, a nucleus on every fourth), prompts of 1 token, of the
    largest bucket less the new tokens, and between; the fourth asks for
    one token (it finishes at its admission). Returns the streams in
    submission order."""
    rng = np.random.default_rng(21)
    vocab = engine.cfg.vocab_size
    largest = engine.scfg.prefill_buckets[-1]
    lengths = [5, 1, 13, 8, largest - 6, 3, 17, 9]
    rids = []
    for i, (n, new) in enumerate(zip(lengths, WAVE_NEW)):
        kw = ({"temperature": 0.9, "key": [60 + i, 3],
               **({"top_p": 0.9} if i % 4 == 1 else {})}
              if i % 2 else {})
        rids.append(engine.submit(rng.integers(0, vocab, size=n), new, **kw))
    out = engine.drain(max_steps=5000)
    return [list(out[r]) for r in rids]


def check_against_jax(jax_engine, port) -> dict:
    """The wave through both engines: equal streams, every value both
    ``stats()`` compute equal, one prefill an admission and no chunk step.
    Returns the port's shared stats."""
    want = wave(jax_engine)
    got = wave(port)
    assert got == want
    assert [len(s) for s in got] == WAVE_NEW
    jax_stats, port_stats = jax_engine.stats(), port.stats()
    keys = set(jax_stats) - IMPL_KEYS
    ps = {k: port_stats[k] for k in keys}
    assert ps == {k: jax_stats[k] for k in keys}
    # A preempted request is admitted, so prefilled, once more.
    assert ps["prefills"] == len(WAVE_NEW) + ps["recompute_preemptions"]
    assert ps["chunk_steps"] == 0 and ps["prefill_chunks"] == 0
    return ps
