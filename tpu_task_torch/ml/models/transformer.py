"""The flagship decoder-only transformer in torch — the counterpart of
``tpu_task/ml/models/transformer.py``: the forward, the training loss
(:func:`loss_fn` with the fused vocab-streaming cross-entropy) and the
gradients of both.

Parameters are a plain nested dict with the JAX package's layout and key
names (``embed``, ``unembed``, ``final_norm``, ``layers[i][wq|wk|...]``),
so a JAX checkpoint crosses over as numpy through :func:`params_from_jax`.
As in the JAX model, every weight is cast to ``cfg.dtype`` where it is
used. The stored type is ``param_dtype``: ``cfg.dtype`` by default (the
serving path, where the cast is then a no-op), float32 master weights for
training (``train.init_state`` asks for them).

Mixture-of-experts layers (``moe_every > 0``) hold ``router``, ``w_in``
and ``w_out`` in place of the dense FFN's three weights and run the dense
dispatch of :mod:`~tpu_task_torch.ml.models.moe` (an ``moe_fn`` may stand
in for it, as in the JAX model); their load-balancing loss joins the
training loss at ``moe_aux_weight``.

Over a mesh (the serving gang of :mod:`~tpu_task_torch.ml.parallel.gang`)
each rank holds its block of every weight under :func:`param_pspecs`, the
JAX package's logical axes through the shared rules: attention heads and
the FFN's hidden dim over ``tp``, the vocab of ``embed`` and ``unembed``
over ``tp``, experts over ``ep``. :func:`_block` then runs its rank's
heads and hidden columns and completes ``wo`` and ``w_down`` (or the MoE
FFN) with one all-reduce over ``tp`` each; :func:`sharded_embed` is a
masked lookup plus an all-reduce and :func:`sharded_logits` all-gathers
the logits.

The sharded train step (``train.make_train_step(cfg, mesh=...)``) runs
the same functions on each rank's rows of the batch, its params the
rank's float32 blocks under the same specs (:func:`loss_fn` with
``mesh`` and ``pspecs``). Just before a layer runs, each weight is cast
and all-gathered over ``fsdp`` (ZeRO-3; the gradient comes back
reduce-scattered in float32), the vocab-sharded ``unembed`` is gathered
whole for the fused cross-entropy, and the ``tp`` products keep their
own heads and columns: the replicated activation enters them through
:func:`~tpu_task_torch.ml.parallel.collectives.sum_grads` and leaves
through the all-reduce, Megatron-LM's pair. The collectives and their
gradients are :mod:`~tpu_task_torch.ml.parallel.collectives`'.

Sequence sharding (an ``activation_spec`` whose second entry names the
``sp`` axis, ``train.make_sp_train_step``) gives each rank a contiguous
chunk of every row: :func:`loss_fn` and :func:`apply_features_with_aux`
take the chunk's global ``positions`` for the rotary embedding, and the
step's ``attn_fn`` (a ring or Ulysses) crosses the chunks."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_task_torch.ml import random as jrandom
from tpu_task_torch.ml.models import moe
from tpu_task_torch.ml.ops.attention import (
    dot_product_attention,
    expand_kv_heads,
)
from tpu_task_torch.ml.parallel import collectives
from tpu_task_torch.ml.parallel.sharding import (
    logical_tree_pspecs,
    mesh_axis_size,
    entry_axes,
    mesh_batch_axes,
)

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

    @property
    def d_attn(self) -> int:
        return self.n_heads * self.d_head

    def is_moe_layer(self, index: int) -> bool:
        """Whether layer ``index`` is a MoE layer: every ``moe_every``-th
        (layers moe_every - 1, 2 moe_every - 1, ...)."""
        if self.moe_every <= 0:
            return False
        if self.n_experts < 2:
            raise ValueError(f"moe_every={self.moe_every} needs n_experts "
                             f">= 2, got {self.n_experts}")
        return (index + 1) % self.moe_every == 0

    @property
    def moe_cfg(self) -> moe.MoEConfig:
        return moe.MoEConfig(
            d_model=self.d_model, d_ff=self.d_ff, n_experts=self.n_experts,
            capacity_factor=self.moe_capacity_factor, top_k=self.moe_top_k)

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

def _layer_shapes(cfg: TransformerConfig, index: int) -> Dict[str, tuple]:
    """Layer ``index``'s weights in their draw order: the attention
    projections and norms, then the dense FFN's ``w_gate``, ``w_up``,
    ``w_down`` or a MoE layer's ``router``, ``w_in``, ``w_out``."""
    shapes = {
        "attn_norm": (cfg.d_model,),
        "wq": (cfg.d_model, cfg.d_attn),
        "wk": (cfg.d_model, cfg.d_kv),
        "wv": (cfg.d_model, cfg.d_kv),
        "wo": (cfg.d_attn, cfg.d_model),
        "mlp_norm": (cfg.d_model,),
    }
    if cfg.is_moe_layer(index):
        shapes.update(
            router=(cfg.d_model, cfg.n_experts),
            w_in=(cfg.n_experts, cfg.d_model, cfg.d_ff),
            w_out=(cfg.n_experts, cfg.d_ff, cfg.d_model))
    else:
        shapes.update(w_gate=(cfg.d_model, cfg.d_ff),
                      w_up=(cfg.d_model, cfg.d_ff),
                      w_down=(cfg.d_ff, cfg.d_model))
    return shapes


#: Weights drawn at d_ff^-0.5 (the FFN's output projections); every other
#: weight but the embedding is drawn at d_model^-0.5.
_FF_OUT = ("w_down", "w_out")


def _build_params(cfg: TransformerConfig, dense: Callable,
                  ones: Callable) -> Params:
    """The param tree of the JAX ``init``: ``dense(shape, scale)`` for each
    weight in its draw order (embed, unembed, then per layer wq, wk, wv,
    wo and the three FFN weights of :func:`_layer_shapes`; a MoE layer
    takes the dense FFN's three keys), scale d_model^-0.5 (d_ff^-0.5 for
    ``w_down`` and ``w_out``, 1.0 for the embedding), and ``ones(shape)``
    for the norms."""
    scale = cfg.d_model ** -0.5
    params: Params = {
        "embed": dense((cfg.vocab_size, cfg.d_model), 1.0),
        "unembed": dense((cfg.d_model, cfg.vocab_size), scale),
        "final_norm": ones((cfg.d_model,)),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        layer = {}
        for name, shape in _layer_shapes(cfg, i).items():
            if name.endswith("norm"):
                layer[name] = ones(shape)
            else:
                layer[name] = dense(
                    shape, cfg.d_ff ** -0.5 if name in _FF_OUT else scale)
        params["layers"].append(layer)
    return params


def init(generator: torch.Generator, cfg: TransformerConfig,
         param_dtype: Optional[torch.dtype] = None) -> Params:
    """Random weights with the JAX ``init``'s shapes and scales, drawn from
    ``torch.randn`` on the generator's device and stored in
    ``param_dtype`` (default ``cfg.dtype``). The values differ from JAX's;
    :func:`init_from_key` draws JAX's own."""
    device = generator.device
    dtype = cfg.dtype if param_dtype is None else param_dtype

    def dense(shape, s):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * s).to(dtype)

    return _build_params(cfg, dense, lambda shape: torch.ones(
        shape, device=device, dtype=dtype))


def init_from_key(key, cfg: TransformerConfig) -> Params:
    """The JAX package's ``init(key, cfg)``, bit for bit: the same
    ``split(key, 2 + 7 * n_layers)`` in the same draw order, each weight a
    float32 :func:`~tpu_task_torch.ml.random.normal` draw times its scale,
    every leaf float32 on the CPU. Threefry on the host is slow at the
    flagship's 189 M parameters, which :func:`init` draws instead."""
    keys = iter(jrandom.split(jrandom.as_key(key, "cpu"),
                              2 + 7 * cfg.n_layers))

    def dense(shape, s):
        return jrandom.normal(next(keys), shape) * torch.tensor(
            s, dtype=torch.float32)

    return _build_params(cfg, dense, lambda shape: torch.ones(
        shape, dtype=torch.float32))


def params_from_jax(tree: Mapping[str, Any], cfg: TransformerConfig,
                    device=None,
                    param_dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX param tree (leaves as numpy arrays — ``jax.tree.map(
    np.asarray, params)``) as the port's params, each leaf stored in
    ``param_dtype`` (default ``cfg.dtype``) on ``device``. Shapes are
    checked against ``cfg``."""
    dtype = cfg.dtype if param_dtype is None else param_dtype

    def leaf(value, shape, name):
        arr = np.asarray(value)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, config wants {shape}")
        return torch.tensor(arr.astype(np.float32), device=device).to(dtype)

    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['layers'])} layers, config "
                         f"wants {cfg.n_layers}")
    return {
        "embed": leaf(tree["embed"], (cfg.vocab_size, cfg.d_model), "embed"),
        "unembed": leaf(tree["unembed"], (cfg.d_model, cfg.vocab_size),
                        "unembed"),
        "final_norm": leaf(tree["final_norm"], (cfg.d_model,), "final_norm"),
        "layers": [{name: leaf(_leaf_of(layer, name, i), shape,
                               f"layers[{i}].{name}")
                     for name, shape in _layer_shapes(cfg, i).items()}
                   for i, layer in enumerate(tree["layers"])],
    }


def _leaf_of(layer: Mapping[str, Any], name: str, index: int):
    if name not in layer:
        raise ValueError(
            f"layers[{index}] has no {name}: the config wants "
            f"{'a MoE' if name in ('router', 'w_in', 'w_out') else 'a dense'}"
            f" FFN there, the tree holds {sorted(layer)}")
    return layer[name]


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


def param_logical_axes(cfg: TransformerConfig) -> Params:
    """Each weight's logical axes, the JAX model's table."""
    attn = {
        "attn_norm": ("norm",),
        "wq": ("embed", "heads"),
        "wk": ("embed", "heads"),
        "wv": ("embed", "heads"),
        "wo": ("heads", "embed"),
        "mlp_norm": ("norm",),
    }
    dense_ffn = {
        "w_gate": ("embed", "mlp"),
        "w_up": ("embed", "mlp"),
        "w_down": ("mlp", "embed"),
    }
    moe_ffn = moe.param_logical_axes()
    return {
        "embed": ("vocab", "embed"),
        "unembed": ("embed", "vocab"),
        "final_norm": ("norm",),
        "layers": [
            {**attn, **(moe_ffn if cfg.is_moe_layer(i) else dense_ffn)}
            for i in range(cfg.n_layers)
        ],
    }


def param_pspecs(cfg: TransformerConfig, mesh=None, rules=None) -> Params:
    """PartitionSpecs for every parameter, resolved from the logical-axis
    annotations through the shared partition rules: the serving engine's
    weight placement reads THIS."""
    return logical_tree_pspecs(param_logical_axes(cfg), mesh=mesh,
                               rules=rules)


def map_params(fn: Callable, params: Params) -> Params:
    """A params-shaped tree of ``fn`` over each leaf."""
    return {
        **{k: fn(v) for k, v in params.items() if k != "layers"},
        "layers": [{k: fn(v) for k, v in layer.items()}
                   for layer in params["layers"]],
    }


def params_to(params: Params, device) -> Params:
    """The same params on ``device`` (no copy for leaves already there)."""
    return map_params(lambda v: v.to(device), params)


# -- forward -------------------------------------------------------------------

class _EmbedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape = table.shape
        ctx.table_dtype = table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        d_table = torch.zeros(ctx.table_shape, dtype=torch.float32,
                              device=g.device)
        d_table.index_add_(0, tokens.reshape(-1),
                           g.reshape(-1, g.shape[-1]).to(torch.float32))
        return d_table.to(ctx.table_dtype), None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding gather whose table gradient accumulates in float32 and
    rounds once to the table's type — the JAX custom-VJP lookup, whose
    one-hot contraction sums in f32 (``preferred_element_type``); here an
    ``index_add_`` into f32 zeros."""
    return _EmbedLookup.apply(table, tokens)


def sharded_embed(table: torch.Tensor, tokens: torch.Tensor,
                  mesh=None) -> torch.Tensor:
    """:func:`embed_lookup` of a table whose vocab rows shard over the
    mesh's ``tp`` axis: each rank looks up the tokens in its row range
    (zeros elsewhere) and one all-reduce sums the ranks' rows, each token
    found on exactly one rank, so the sum is exact. The gradient reaches
    each rank's rows alone, summed in float32 as :func:`embed_lookup`'s."""
    if mesh_axis_size(mesh, "tp") == 1:
        return embed_lookup(table, tokens)
    rows = table.shape[0]
    local = tokens - mesh.axis_index("tp") * rows
    mine = (local >= 0) & (local < rows)
    found = embed_lookup(table, local.clamp(0, rows - 1))
    found = torch.where(mine[..., None], found, torch.zeros_like(found))
    return collectives.all_reduce(mesh, found, "tp")


def sharded_logits(features: torch.Tensor, unembed: torch.Tensor,
                   mesh=None) -> torch.Tensor:
    """float32 logits ``features @ unembed`` over the whole vocab, from
    an ``unembed`` whose vocab columns shard over ``tp``: each rank's
    columns, all-gathered in rank order."""
    logits = (features @ unembed).to(torch.float32)
    return collectives.all_gather(mesh, logits, "tp", dim=-1)


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


def expand_kv(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, s, kv_heads, d) → (b, s, n_heads, d); the shared GQA expansion
    rule — see :func:`tpu_task_torch.ml.ops.attention.expand_kv_heads`."""
    return expand_kv_heads(kv, n_heads)


MoeFn = Callable[[Params, torch.Tensor], Any]


def default_moe_fn(cfg: TransformerConfig) -> MoeFn:
    """The dense-dispatch MoE FFN, ``(layer, h) -> (out, aux)``: the
    single-device path every step takes when no ``moe_fn`` is given."""
    mcfg = cfg.moe_cfg

    def fn(layer, h):
        return moe.apply_dense(layer, mcfg, h)

    return fn


def _block(x: torch.Tensor, layer: Params, cfg: TransformerConfig,
           attn_fn: AttnFn, positions: Optional[torch.Tensor] = None,
           moe_fn: Optional[MoeFn] = None, mesh=None):
    """One transformer block → (x, aux). ``attn_fn(q, k, v)`` receives k/v
    at kv-head width; the cached decode paths pass a closure that writes
    the cache and attends it, so every projection, norm and residual is
    this one function on every path. Each attention and dense-FFN weight
    is cast to ``cfg.dtype`` where it is used; a MoE layer (one that holds
    a ``router``) runs ``moe_fn`` (default :func:`default_moe_fn`) on its
    stored weights and adds its output cast to the residual's type.
    ``aux`` is the layer's router loss, a float32 zero for a dense
    layer.

    With a ``mesh`` whose ``tp`` axis is wider than 1 the layer holds its
    rank's block (:func:`param_pspecs`): ``n_heads / tp`` query and
    ``kv_heads / tp`` kv heads (a kv head's query group stays on its
    rank) and ``d_ff / tp`` hidden columns, so ``wo`` and ``w_down`` give
    partial sums that one all-reduce over ``tp`` completes. A MoE layer
    on the dense dispatch is completed the same way; a given ``moe_fn``
    (the expert-parallel dispatch, or the train step's over gathered
    weights) completes its own. Under autograd the normed activation
    enters the rank's products through ``sum_grads``, so its gradient sums
    the ranks' heads and columns."""
    b, s, _ = x.shape
    dt = cfg.dtype
    tp = mesh_axis_size(mesh, "tp")
    heads, kv_heads = cfg.n_heads // tp, cfg.kv_heads // tp
    h = collectives.sum_grads(mesh, _rmsnorm(x, layer["attn_norm"]), "tp")
    q = (h @ layer["wq"].to(dt)).reshape(b, s, heads, cfg.d_head)
    k = (h @ layer["wk"].to(dt)).reshape(b, s, kv_heads, cfg.d_head)
    v = (h @ layer["wv"].to(dt)).reshape(b, s, kv_heads, cfg.d_head)
    q = _rope(q, cfg.rope_theta, positions)
    k = _rope(k, cfg.rope_theta, positions)
    attn = attn_fn(q, k, v)
    x = x + collectives.all_reduce(
        mesh, attn.reshape(b, s, heads * cfg.d_head) @ layer["wo"].to(dt),
        "tp")
    h = _rmsnorm(x, layer["mlp_norm"])
    if "router" in layer:
        if moe_fn is None:
            out, aux = default_moe_fn(cfg)(layer, h)
            out = collectives.all_reduce(mesh, out, "tp")
        else:
            out, aux = moe_fn(layer, h)
        return x + out.to(x.dtype), aux.to(torch.float32)
    h = collectives.sum_grads(mesh, h, "tp")
    gate = F.silu(h @ layer["w_gate"].to(dt))
    up = h @ layer["w_up"].to(dt)
    return (x + collectives.all_reduce(
                mesh, (gate * up) @ layer["w_down"].to(dt), "tp"),
            torch.zeros((), dtype=torch.float32, device=x.device))


#: A MoE layer's weights: used in their stored type (the MoE module's
#: promotion rule), and by the expert-parallel dispatch on the rank's own
#: experts.
_MOE_WEIGHTS = ("router", "w_in", "w_out")


def _used(w: torch.Tensor, spec, mesh, dtype: torch.dtype,
          keep=()) -> torch.Tensor:
    """``w``, this rank's block under ``spec``, as the sharded step uses
    it: cast to ``dtype`` and all-gathered over every mesh axis of
    ``spec`` outside ``keep``, just before its use. The gradient comes
    back summed over the axes the batch shards over (``fsdp``: each rank
    saw its own rows) and sliced over the others (``tp``: each rank saw
    the same rows through the whole weight)."""
    batch = mesh_batch_axes(mesh)
    gathers = [(axis, dim, axis in batch)
               for dim, entry in enumerate(spec or ())
               for axis in reversed(entry_axes(entry)) if axis not in keep]
    return collectives.gather_cast(mesh, w, gathers, dtype)


def _layer_for_step(layer: Params, specs: Params, cfg: TransformerConfig,
                    mesh, expert_axis: Optional[str]) -> Params:
    """A layer's weights as the sharded step's :func:`_block` takes them:
    the attention and dense-FFN weights in ``cfg.dtype`` gathered over
    every axis but ``tp`` (the block runs its own heads and columns), the
    MoE weights in their stored type gathered over every axis but
    ``expert_axis`` (the expert-parallel dispatch runs its own experts;
    without it the dense dispatch runs every expert, the same on each
    ``tp`` rank)."""
    out = {}
    for name, w in layer.items():
        if name in _MOE_WEIGHTS:
            out[name] = _used(w, specs[name], mesh, w.dtype,
                              keep=(expert_axis,) if expert_axis else ())
        elif name.endswith("norm"):
            out[name] = _used(w, specs[name], mesh, w.dtype)
        else:
            out[name] = _used(w, specs[name], mesh, cfg.dtype, keep=("tp",))
    return out


def apply_features_with_aux(params: Params, cfg: TransformerConfig,
                            tokens: torch.Tensor,
                            attn_fn: Optional[AttnFn] = None,
                            moe_fn: Optional[MoeFn] = None, *, mesh=None,
                            pspecs: Optional[Params] = None,
                            expert_axis: Optional[str] = None,
                            positions: Optional[torch.Tensor] = None):
    """tokens (batch, seq) → (final-norm features (batch, seq, d_model),
    the mean router loss over the MoE layers, a float32 zero for an
    all-dense config). The default attention is
    :func:`dot_product_attention` over expanded kv heads: the flash
    kernels wherever its routing rule admits the shape. ``positions``
    (seq,): the tokens' positions for the rotary embedding (default
    0..seq-1; a rank's sequence chunk passes its global ones).

    With ``pspecs`` (the specs of ``params``, each leaf this rank's block
    on ``mesh``) ``tokens`` are this rank's rows and each weight is
    gathered just before its layer runs (:func:`_layer_for_step`); the
    MoE layers take ``moe_fn``, or the dense dispatch over their gathered
    weights."""
    if attn_fn is None:
        def attn_fn(q, k, v):
            heads = q.shape[2]
            return dot_product_attention(q, expand_kv(k, heads),
                                         expand_kv(v, heads), True)
    if pspecs is None:
        x = embed_lookup(params["embed"].to(cfg.dtype), tokens)
    else:
        x = sharded_embed(_used(params["embed"], pspecs["embed"], mesh,
                                cfg.dtype, keep=("tp",)), tokens, mesh)
        if moe_fn is None:
            moe_fn = default_moe_fn(cfg)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_moe = 0
    for i, layer in enumerate(params["layers"]):
        if pspecs is not None:
            layer = _layer_for_step(layer, pspecs["layers"][i], cfg, mesh,
                                    expert_axis)
        x, aux = _block(x, layer, cfg, attn_fn, positions=positions,
                        moe_fn=moe_fn, mesh=mesh)
        if "router" in layer:
            aux_sum = aux_sum + aux
            n_moe += 1
    return _rmsnorm(x, params["final_norm"]), aux_sum / max(1, n_moe)


def apply_features(params: Params, cfg: TransformerConfig,
                   tokens: torch.Tensor, attn_fn: Optional[AttnFn] = None,
                   moe_fn: Optional[MoeFn] = None) -> torch.Tensor:
    """tokens (batch, seq) → final-norm features (batch, seq, d_model);
    :func:`apply_features_with_aux` without the router loss."""
    return apply_features_with_aux(params, cfg, tokens, attn_fn=attn_fn,
                                   moe_fn=moe_fn)[0]


def apply(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
          attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
    """tokens (batch, seq) → logits (batch, seq, vocab) float32."""
    x = apply_features(params, cfg, tokens, attn_fn=attn_fn)
    return (x @ params["unembed"].to(cfg.dtype)).to(torch.float32)


# -- loss ----------------------------------------------------------------------

#: Vocab-block floor for the fused cross-entropy: each step of its loop holds
#: one (tokens, block) logit tile instead of the full (tokens, vocab) matrix.
XENT_VOCAB_BLOCK = 4096

#: Auto-block budget: the largest f32 logit tile one step may hold. The
#: block grows to this budget (fewer, larger steps) and shrinks at long
#: context, where bounding the tile is the point.
XENT_TILE_BYTES = 1 << 30


def _auto_xent_block(n_tokens: int, vocab: int) -> int:
    """Largest 4096-multiple block whose (n_tokens, block) f32 tile fits
    the budget, clamped to [XENT_VOCAB_BLOCK, padded vocab]."""
    block = (XENT_TILE_BYTES // (4 * max(1, n_tokens))) // 4096 * 4096
    vocab_ceil = -(-vocab // 4096) * 4096
    return max(XENT_VOCAB_BLOCK, min(block, vocab_ceil))


def _pad_vocab(unembed: torch.Tensor, block: int):
    """Pad the vocab axis up to a block multiple (pad columns are masked
    to -inf, so they never contribute)."""
    vocab = unembed.shape[1]
    pad = (-vocab) % block
    if pad:
        unembed = F.pad(unembed, (0, pad))
    return unembed, vocab


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with a float32 result, as JAX's ``preferred_element_type``:
    bf16 operands multiply exactly and sum in f32. On the card that is one
    bf16 product with an f32 output (``torch.mm``'s ``out_dtype``); on the
    CPU, where that overload does not exist, the operands widen first,
    which is exact."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _masked_logits(features: torch.Tensor, u_block: torch.Tensor,
                   start: int, block: int, vocab: int) -> torch.Tensor:
    """One (T, block) f32 logit tile with pad columns at -inf."""
    z = _mm_f32(features, u_block)
    if start + block > vocab:
        col = start + torch.arange(block, device=z.device)
        z = z.masked_fill(col[None, :] >= vocab, float("-inf"))
    return z


def _target_slot(targets: torch.Tensor, start: int, block: int):
    in_block = (targets >= start) & (targets < start + block)
    return in_block, (targets - start).clamp(0, block - 1)


class _FusedXent(torch.autograd.Function):
    """Mean next-token cross-entropy streamed over vocab blocks: the
    forward keeps an online logsumexp and the target logit, the backward
    recomputes each block's softmax tile from the saved lse."""

    @staticmethod
    def forward(ctx, features, unembed, targets, block: int):
        n = features.shape[0]
        padded, vocab = _pad_vocab(unembed, block)
        dev = features.device
        m = torch.full((n,), float("-inf"), device=dev)
        l = torch.zeros((n,), device=dev)
        t_logit = torch.zeros((n,), device=dev)
        for start in range(0, padded.shape[1], block):
            z = _masked_logits(features, padded[:, start:start + block],
                               start, block, vocab)
            m_new = torch.maximum(m, z.amax(dim=-1))
            l = l * torch.exp(m - m_new) + torch.exp(
                z - m_new[:, None]).sum(dim=-1)
            in_block, local = _target_slot(targets, start, block)
            t_logit = torch.where(in_block, z.gather(1, local[:, None])[:, 0],
                                  t_logit)
            m = m_new
        lse = m + torch.log(l)
        ctx.save_for_backward(features, unembed, targets, lse)
        ctx.block = block
        return (lse - t_logit).mean()

    @staticmethod
    def backward(ctx, g):
        features, unembed, targets, lse = ctx.saved_tensors
        block = ctx.block
        n = features.shape[0]
        padded, vocab = _pad_vocab(unembed, block)
        scale = g.to(torch.float32) / n
        # Operands go in the features' type (bf16 on the train path, one
        # tensor-core pass); the sums stay f32, as in the JAX backward.
        operand = features.dtype
        rows = torch.arange(n, device=features.device)
        d_features = torch.zeros(features.shape, dtype=torch.float32,
                                 device=features.device)
        d_blocks = []
        for start in range(0, padded.shape[1], block):
            u_block = padded[:, start:start + block]
            z = _masked_logits(features, u_block, start, block, vocab)
            p = torch.exp(z - lse[:, None])   # pad columns: exp(-inf) = 0
            in_block, local = _target_slot(targets, start, block)
            p.index_put_((rows, local), -in_block.to(p.dtype),
                         accumulate=True)     # p - onehot
            ds = (p * scale).to(operand)
            d_features += _mm_f32(ds, u_block.t().to(operand))
            d_blocks.append(_mm_f32(features.t().to(operand), ds))
        d_unembed = torch.cat(d_blocks, dim=1)[:, :unembed.shape[1]]
        return (d_features.to(features.dtype), d_unembed.to(unembed.dtype),
                None, None)


def fused_xent(features: torch.Tensor, unembed: torch.Tensor,
               targets: torch.Tensor, block: Optional[int] = None,
               token_shards: int = 1) -> torch.Tensor:
    """Mean next-token cross-entropy without materializing (tokens,
    vocab) logits beyond one tile. features (T, d), unembed (d, V),
    targets (T,) int64. ``block=None`` sizes the tile to XENT_TILE_BYTES
    (the whole vocab at the flagship's 8192 tokens). ``token_shards``:
    the ways JAX's global token dim shards over a mesh; the tile is sized
    for one shard's tokens, as JAX sizes it (the loss is unchanged)."""
    if block is None:
        block = _auto_xent_block(
            max(1, features.shape[0] // max(1, token_shards)),
            unembed.shape[1])
    return _FusedXent.apply(features, unembed, targets, block)


def activation_batch_axes(activation_spec) -> tuple:
    """The batch axes an ``activation_spec`` (a PartitionSpec over
    (batch, seq, d_model), or anything with a ``.spec``, as JAX's
    NamedSharding) names: its first entry. On a rank the activations are
    its own rows already, so that entry asks for nothing more, and a
    second entry (the sequence axis: each rank its chunk, cut by
    ``train.make_sp_train_step``) neither; an entry on the model dim has
    no counterpart and raises."""
    spec = tuple(getattr(activation_spec, "spec", activation_spec))
    if any(entry is not None for entry in spec[2:]):
        raise NotImplementedError(
            f"activation_spec {spec} shards the model dim, which the port "
            "does not do")
    return entry_axes(spec[0]) if spec else ()


def loss_fn(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
            attn_fn: Optional[AttnFn] = None, fused: bool = True,
            activation_spec=None, moe_fn=None, token_shards: int = 1, *,
            mesh=None, pspecs: Optional[Params] = None,
            expert_axis: Optional[str] = None,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross-entropy over tokens (batch, seq). ``fused=True``
    streams the unembed and softmax over vocab blocks (:func:`fused_xent`);
    ``fused=False`` is the monolithic reference path. A config with MoE
    layers adds ``cfg.moe_aux_weight`` times their mean router loss;
    ``moe_fn`` replaces their dense dispatch, as in the JAX model.

    With ``pspecs`` it is one rank's loss of the sharded step: ``params``
    the rank's blocks on ``mesh``, ``tokens`` its rows, the mean over its
    own tokens (:func:`apply_features_with_aux`; the vocab-sharded
    ``unembed`` is all-gathered whole for the fused cross-entropy).
    ``positions`` (seq - 1,): the input tokens' positions, a rank's
    sequence chunk's global ones (default 0..seq-2)."""
    if activation_spec is not None:
        if not fused:
            raise ValueError("activation_spec requires the fused loss path")
        activation_batch_axes(activation_spec)
    tokens = tokens.long()
    targets = tokens[:, 1:]
    features, aux = apply_features_with_aux(
        params, cfg, tokens[:, :-1], attn_fn=attn_fn, moe_fn=moe_fn,
        mesh=mesh, pspecs=pspecs, expert_axis=expert_axis,
        positions=positions)
    b, s, d = features.shape
    if pspecs is None:
        unembed = params["unembed"].to(cfg.dtype)
    else:
        unembed = _used(params["unembed"], pspecs["unembed"], mesh,
                        cfg.dtype)
    if fused:
        xent = fused_xent(features.reshape(b * s, d), unembed,
                          targets.reshape(-1), token_shards=token_shards)
    else:
        logits = (features @ unembed).to(torch.float32)
        logp = F.log_softmax(logits, dim=-1)
        xent = -logp.gather(-1, targets[..., None])[..., 0].mean()
    return xent + cfg.moe_aux_weight * aux
