"""Engine presets and the engine builder of one serving replica — the
counterpart of ``tpu_task/serve/replica.py``'s ``MODEL_PRESETS``,
``SERVING_PRESETS`` and ``build_engine``. The HTTP ``ReplicaServer`` comes
with the serve-integration slice (ROADMAP A11)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from tpu_task_torch.device import resolve_device
from tpu_task_torch.ml import random as jrandom
from tpu_task_torch.ml.models import transformer
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine

__all__ = ["MODEL_PRESETS", "SERVING_PRESETS", "build_engine"]

#: (TransformerConfig kwargs, init seed) per preset name — the JAX
#: package's presets, so the same name serves the same geometry.
MODEL_PRESETS: Dict[str, dict] = {
    "tiny": dict(seed=0, vocab_size=256, d_model=128, n_layers=2, n_heads=8,
                 d_head=16, d_ff=256, n_kv_heads=4),
    "micro": dict(seed=0, vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                  d_head=8, d_ff=64, n_kv_heads=2),
}

#: ServingConfig defaults per preset — overridable via ``serving=``.
SERVING_PRESETS: Dict[str, dict] = {
    "tiny": dict(slots=4, block_size=8, n_blocks=96, max_len=128),
    "micro": dict(slots=4, block_size=4, n_blocks=64, max_len=48),
}


def build_engine(preset: str = "tiny", serving: Optional[dict] = None,
                 rng_seed: int = 0, device=None,
                 kv_client=None) -> ServingEngine:
    """A ServingEngine from a preset name: same name → same weights, same
    config, same streams, in any process and in either package. Weights
    are the JAX package's, bit for bit: ``init_from_key`` draws them at
    fp32 from ``PRNGKey(seed)`` of the preset's seed on the CPU (so they
    are the same on every device) and the engine moves them to ``device``
    — CUDA unless the caller passes ``device="cpu"``. ``kv_client`` a
    :class:`~tpu_task_torch.serve.kvfleet.FleetKvClient` for fleet-wide
    prefix-cache sharing (None = replica-local cache only)."""
    device = resolve_device(device)
    if preset not in MODEL_PRESETS:
        raise ValueError(
            f"unknown model preset {preset!r}; have {sorted(MODEL_PRESETS)}")
    spec = dict(MODEL_PRESETS[preset])
    seed = spec.pop("seed")
    cfg = transformer.TransformerConfig(dtype=torch.float32, **spec)
    params = transformer.init_from_key(jrandom.PRNGKey(seed), cfg)
    knobs = dict(SERVING_PRESETS[preset])
    knobs.update(serving or {})
    return ServingEngine(params, cfg, ServingConfig(**knobs),
                         rng=jrandom.PRNGKey(rng_seed), device=device,
                         kv_fleet=kv_client)
