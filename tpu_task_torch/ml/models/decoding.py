"""KV-cache autoregressive decoding — the counterpart of
``tpu_task/ml/models/decoding.py``.

The dense cache is a fixed-capacity ``(batch, max_len, kv_heads, d_head)``
buffer per layer (slot j = position j, not a ring). Where the JAX package
returned an updated cache from each call, the port writes the cache in
place. ``start`` is always a Python int here, so the overflow guard always
runs; PyTorch executes eagerly and the decode loop is a Python loop."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from tpu_task_torch.device import resolve_device
from tpu_task_torch.ml import random as jrandom
from tpu_task_torch.ml.models.transformer import (
    Params,
    TransformerConfig,
    _block,
    _rmsnorm,
    embed_lookup,
)
from tpu_task_torch.ml.ops.attention import NEG_INF, gqa_cached_attention

Cache = List[Dict[str, torch.Tensor]]


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device) -> Cache:
    """Per-layer zeroed k/v caches of shape (batch, max_len, kv_heads,
    d_head) — at kv-head width, the point of GQA at decode time."""
    shape = (batch, max_len, cfg.kv_heads, cfg.d_head)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_layers)]


def forward_with_cache(params: Params, cfg: TransformerConfig,
                       tokens: torch.Tensor, caches: Cache,
                       start: int) -> torch.Tensor:
    """Run ``tokens`` (batch, s) at absolute positions [start, start + s)
    through the model, writing their k/v into ``caches`` in place. Returns
    the last position's logits (batch, vocab) float32. Raises ValueError
    when ``start + s`` exceeds the cache's ``max_len``."""
    s = tokens.shape[1]
    max_len = caches[0]["k"].shape[1] if caches else 0
    if start < 0 or start + s > max_len:
        raise ValueError(
            f"cache overflow: start {start} + tokens {s} > max_len "
            f"{max_len} (the cache is a fixed buffer, not a ring)")
    positions = torch.arange(start, start + s, device=tokens.device)
    x = embed_lookup(params["embed"], tokens)
    for layer, cache in zip(params["layers"], caches):
        def attn_fn(q, k, v, cache=cache):
            cache["k"][:, start:start + s] = k
            cache["v"][:, start:start + s] = v
            return gqa_cached_attention(q, cache["k"], cache["v"], positions)

        x, _aux = _block(x, layer, cfg, attn_fn, positions=positions)
    x = _rmsnorm(x, params["final_norm"])
    return (x[:, -1] @ params["unembed"]).to(torch.float32)


def _top_p_filter(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus filtering: keep the smallest probability mass >= top_p,
    everything else to NEG_INF. ``top_p`` is a scalar or a (batch,)
    tensor of per-row thresholds."""
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device)
    if top_p.dim():
        top_p = top_p[:, None]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.to(torch.float32), dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    # Keep every token whose PRECEDING mass is still under top_p: the
    # argmax's preceding mass is 0, so at least one token survives.
    keep = (cumulative - probs) < top_p
    threshold = torch.where(keep, sorted_logits,
                            torch.full_like(sorted_logits, float("inf")))
    threshold = threshold.min(dim=-1, keepdim=True).values
    return torch.where(logits >= threshold, logits,
                       torch.full_like(logits, NEG_INF))


def generate(params: Params, cfg: TransformerConfig, prompt: torch.Tensor,
             max_new_tokens: int, *, temperature: float = 0.0,
             top_p: Optional[float] = None,
             eos_token: Optional[int] = None,
             rng: Optional[jrandom.KeyLike] = None,
             max_len: Optional[int] = None, device=None) -> torch.Tensor:
    """Autoregressive generation: prompt (batch, prompt_len) int →
    (batch, max_new_tokens) int64, on ``device`` (CUDA unless the caller
    passes ``device="cpu"``). Temperature 0 is greedy; otherwise
    Gumbel-max sampling with the JAX key schedule (``rng`` is a raw (2,)
    key; token i draws with ``split(rng, max_new_tokens)[i]``), optionally
    nucleus-filtered to ``top_p`` after tempering. A row that emits
    ``eos_token`` keeps emitting it."""
    device = resolve_device(device)
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if temperature > 0 and rng is None:
        raise ValueError("sampling (temperature > 0) needs an rng key")
    if top_p is not None and not 0 < top_p <= 1:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_p is not None and temperature == 0:
        raise ValueError("top_p needs temperature > 0 (greedy ignores it)")
    prompt = torch.as_tensor(prompt, device=device).to(torch.int64)
    batch, prompt_len = prompt.shape
    total = (prompt_len + max_new_tokens) if max_len is None else max_len
    if total < prompt_len + max_new_tokens:
        raise ValueError(f"max_len {total} < prompt {prompt_len} + "
                         f"new {max_new_tokens}")

    keys = (jrandom.split(jrandom.as_key(rng, device), max_new_tokens)
            if rng is not None else None)

    def pick(logits, i):
        if temperature == 0:
            return torch.argmax(logits, dim=-1)
        # Temper first, then take the nucleus of the tempered distribution.
        logits = logits / temperature
        if top_p is not None:
            logits = _top_p_filter(logits, top_p)
        return jrandom.categorical(keys[i], logits)

    caches = init_cache(cfg, batch, total, device)
    with torch.no_grad():
        logits = forward_with_cache(params, cfg, prompt, caches, 0)
        token = pick(logits, 0)
        out = [token]
        done = (torch.zeros(batch, dtype=torch.bool, device=device)
                if eos_token is None else token == eos_token)
        for i in range(1, max_new_tokens):
            logits = forward_with_cache(params, cfg, token[:, None], caches,
                                        prompt_len + i - 1)
            token = pick(logits, i)
            if eos_token is not None:
                token = torch.where(done, torch.full_like(token, eos_token),
                                    token)
                done = done | (token == eos_token)
            out.append(token)
    return torch.stack(out, dim=1)
