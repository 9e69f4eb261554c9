"""The flagship decoder-only transformer in torch — the counterpart of
``tpu_task/ml/models/transformer.py`` (forward only).

Parameters are a plain nested dict with the JAX package's layout and key
names (``embed``, ``unembed``, ``final_norm``, ``layers[i][wq|wk|...]``),
so a JAX checkpoint crosses over as numpy through :func:`params_from_jax`.
The JAX model keeps float32 parameters and casts each one to ``cfg.dtype``
where it is used; the port stores every parameter in ``cfg.dtype`` once at
load, which yields exactly the values of that cast.

Mixture-of-experts layers (``moe_every > 0``) are not ported yet (ROADMAP
A13) and raise."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_task_torch.ml.ops.attention import expand_kv_heads, mha_reference

Params = Dict[str, Any]


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_head: int = 64
    d_ff: int = 1408
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    n_kv_heads: Optional[int] = None
    moe_every: int = 0
    n_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        if self.moe_every > 0:
            raise NotImplementedError(
                "mixture-of-experts layers (moe_every > 0) are not ported "
                "yet: ROADMAP A13")

    @property
    def d_attn(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_heads(self) -> int:
        kv = self.n_heads if self.n_kv_heads is None else self.n_kv_heads
        if kv < 1:
            raise ValueError(f"n_kv_heads must be >= 1, got {kv}")
        if self.n_heads % kv:
            raise ValueError(f"n_heads {self.n_heads} not divisible by "
                             f"n_kv_heads {kv}")
        return kv

    @property
    def d_kv(self) -> int:
        return self.kv_heads * self.d_head


# -- parameters ----------------------------------------------------------------

def _layer_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    return {
        "attn_norm": (cfg.d_model,),
        "wq": (cfg.d_model, cfg.d_attn),
        "wk": (cfg.d_model, cfg.d_kv),
        "wv": (cfg.d_model, cfg.d_kv),
        "wo": (cfg.d_attn, cfg.d_model),
        "mlp_norm": (cfg.d_model,),
        "w_gate": (cfg.d_model, cfg.d_ff),
        "w_up": (cfg.d_model, cfg.d_ff),
        "w_down": (cfg.d_ff, cfg.d_model),
    }


def init(generator: torch.Generator, cfg: TransformerConfig) -> Params:
    """Random weights with the JAX ``init``'s shapes and scales (normal
    draws times d_model^-0.5, d_ff^-0.5 for ``w_down``, 1.0 for the
    embedding; norms at 1), drawn on the generator's device and stored in
    ``cfg.dtype``. The values differ from JAX's: tests that compare the two
    load JAX's weights through :func:`params_from_jax` instead."""
    device = generator.device
    scale = cfg.d_model ** -0.5

    def dense(shape, s):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * s).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=cfg.dtype)

    params: Params = {
        "embed": dense((cfg.vocab_size, cfg.d_model), 1.0),
        "unembed": dense((cfg.d_model, cfg.vocab_size), scale),
        "final_norm": ones((cfg.d_model,)),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        layer = {}
        for name, shape in _layer_shapes(cfg).items():
            if name.endswith("norm"):
                layer[name] = ones(shape)
            else:
                layer[name] = dense(
                    shape, cfg.d_ff ** -0.5 if name == "w_down" else scale)
        params["layers"].append(layer)
    return params


def params_from_jax(tree: Mapping[str, Any], cfg: TransformerConfig,
                    device=None) -> Params:
    """The JAX param tree (leaves as numpy arrays — ``jax.tree.map(
    np.asarray, params)``) as the port's params, each leaf stored in
    ``cfg.dtype`` on ``device``. Shapes are checked against ``cfg``."""
    def leaf(value, shape, name):
        arr = np.asarray(value)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, config wants {shape}")
        return torch.tensor(arr.astype(np.float32), device=device).to(
            cfg.dtype)

    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['layers'])} layers, config "
                         f"wants {cfg.n_layers}")
    shapes = _layer_shapes(cfg)
    return {
        "embed": leaf(tree["embed"], (cfg.vocab_size, cfg.d_model), "embed"),
        "unembed": leaf(tree["unembed"], (cfg.d_model, cfg.vocab_size),
                        "unembed"),
        "final_norm": leaf(tree["final_norm"], (cfg.d_model,), "final_norm"),
        "layers": [{name: leaf(layer[name], shape, f"layers[{i}].{name}")
                    for name, shape in shapes.items()}
                   for i, layer in enumerate(tree["layers"])],
    }


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """The reverse of :func:`params_from_jax`: float32 numpy leaves in the
    JAX tree layout (bf16 weights widen exactly)."""
    def leaf(t):
        return t.detach().to("cpu", torch.float32).numpy()

    return {
        "embed": leaf(params["embed"]),
        "unembed": leaf(params["unembed"]),
        "final_norm": leaf(params["final_norm"]),
        "layers": [{k: leaf(v) for k, v in layer.items()}
                   for layer in params["layers"]],
    }


def params_to(params: Params, device) -> Params:
    """The same params on ``device`` (no copy for leaves already there)."""
    return {
        **{k: v.to(device) for k, v in params.items() if k != "layers"},
        "layers": [{k: v.to(device) for k, v in layer.items()}
                   for layer in params["layers"]],
    }


# -- forward -------------------------------------------------------------------

def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding gather (the forward of the JAX custom-VJP lookup)."""
    return table[tokens]


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale.to(x.dtype)


def _rope(x: torch.Tensor, theta: float,
          positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotary embedding over (batch, seq, heads, head_dim). ``positions``
    (seq,) rotates every row at the same offsets, (batch, seq) per row."""
    _, seq, _, d = x.shape
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions is None:
        positions = torch.arange(seq, device=x.device)
    angles = positions.to(torch.float32)[..., None] * freqs
    if angles.dim() == 2:                    # (seq, half): shared offsets
        cos = torch.cos(angles)[None, :, None, :]
        sin = torch.sin(angles)[None, :, None, :]
    else:                                    # (batch, seq, half): per-row
        cos = torch.cos(angles)[:, :, None, :]
        sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _block(x: torch.Tensor, layer: Params, cfg: TransformerConfig,
           attn_fn: AttnFn,
           positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One transformer block (dense FFN). ``attn_fn(q, k, v)`` receives k/v
    at kv-head width; the cached decode paths pass a closure that writes
    the cache and attends it, so every projection, norm and residual is
    this one function on every path."""
    b, s, _ = x.shape
    h = _rmsnorm(x, layer["attn_norm"])
    q = (h @ layer["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = (h @ layer["wk"]).reshape(b, s, cfg.kv_heads, cfg.d_head)
    v = (h @ layer["wv"]).reshape(b, s, cfg.kv_heads, cfg.d_head)
    q = _rope(q, cfg.rope_theta, positions)
    k = _rope(k, cfg.rope_theta, positions)
    attn = attn_fn(q, k, v)
    x = x + attn.reshape(b, s, cfg.d_attn) @ layer["wo"]
    h = _rmsnorm(x, layer["mlp_norm"])
    gate = F.silu(h @ layer["w_gate"])
    up = h @ layer["w_up"]
    return x + (gate * up) @ layer["w_down"]


def apply_features(params: Params, cfg: TransformerConfig,
                   tokens: torch.Tensor,
                   attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
    """tokens (batch, seq) → final-norm features (batch, seq, d_model)."""
    if attn_fn is None:
        def attn_fn(q, k, v):
            return mha_reference(q, expand_kv_heads(k, cfg.n_heads),
                                 expand_kv_heads(v, cfg.n_heads), True)
    x = embed_lookup(params["embed"], tokens)
    for layer in params["layers"]:
        x = _block(x, layer, cfg, attn_fn)
    return _rmsnorm(x, params["final_norm"])


def apply(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
          attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
    """tokens (batch, seq) → logits (batch, seq, vocab) float32."""
    x = apply_features(params, cfg, tokens, attn_fn=attn_fn)
    return (x @ params["unembed"]).to(torch.float32)
