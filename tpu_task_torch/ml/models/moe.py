"""The mixture-of-experts FFN in torch — the counterpart of
``tpu_task/ml/models/moe.py``: :class:`MoEConfig`, :func:`init`, the top-k
router (:func:`_route`), the load-balancing loss (:func:`_aux_from_stats`),
the dense dispatch (:func:`apply_dense`) and the expert-parallel one
(:func:`apply_sharded`).

The dense dispatch is the JAX package's, einsum for einsum: a one-hot
dispatch matrix places each token in its experts' rows of an (experts,
tokens, d) buffer, two batched products run every expert over the whole
buffer, and a gate-weighted sum over the experts combines them. Every
shape is static and nothing reads the device from the host, so the
dispatch runs inside the serving engine's CUDA graphs and its overlapped
dispatch. Each expert computes over every token (zeros where it was not
chosen), ``n_experts / top_k`` times the routed work.

Three rules keep it equal to the JAX package's:

- **Ties.** ``lax.top_k`` takes the lower expert index among equal
  probabilities; ``torch.topk`` promises no order, so the experts come
  from a stable descending sort.
- **Promotion.** The router and expert weights are used in their stored
  type, as JAX uses them (the dense FFN casts to ``cfg.dtype``, this does
  not): float32 master weights under bf16 activations compute the logits,
  the expert products and the combine in float32, and the block casts
  back only where it adds the residual.
- **Jitter.** ``rng`` adds ``router_noise`` times
  :func:`~tpu_task_torch.ml.random.normal` to the logits, JAX's draw bit
  for bit when the logits are float32 (other types draw in float32 and
  round). No single-device step passes one.

The expert-parallel dispatch runs on a mesh of ranks (a serving gang's,
:mod:`~tpu_task_torch.ml.parallel.gang`, or the sharded train step's):
each rank routes its piece of the tokens, places them by capacity,
exchanges them with one all_to_all over ``ep`` each way and runs its own
experts between, the JAX package's ``shard_map`` body written for one
rank. Its collectives carry gradients
(:mod:`~tpu_task_torch.ml.parallel.collectives`): an all_to_all goes back
as the reverse exchange and the statistics' all-reduces as all-reduces,
so the train step back-propagates through it on each rank's own
tokens."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from tpu_task_torch.ml import random as jrandom

Stats = Tuple[torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class MoEConfig:
    d_model: int = 64
    d_ff: int = 128
    n_experts: int = 4
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    # Experts consulted per token: 1 keeps the switch gate (the winning
    # probability), more renormalize the chosen gates to sum to 1.
    top_k: int = 1
    # Read by the expert-parallel dispatch's capacity drop only; the dense
    # dispatch has no capacity limit and drops nothing.
    dropped_identity: bool = False


def init(generator: torch.Generator, cfg: MoEConfig) -> Dict[str, Any]:
    """float32 ``router`` (d_model, n_experts), ``w_in`` (n_experts,
    d_model, d_ff) and ``w_out`` (n_experts, d_ff, d_model), drawn from
    ``torch.randn`` on the generator's device at JAX's scales (d_model^-0.5,
    d_model^-0.5, d_ff^-0.5)."""
    def dense(shape, scale):
        return torch.randn(shape, generator=generator,
                           device=generator.device) * scale

    scale_in = cfg.d_model ** -0.5
    return {
        "router": dense((cfg.d_model, cfg.n_experts), scale_in),
        "w_in": dense((cfg.n_experts, cfg.d_model, cfg.d_ff), scale_in),
        "w_out": dense((cfg.n_experts, cfg.d_ff, cfg.d_model),
                       cfg.d_ff ** -0.5),
    }


def _promoted(*tensors: torch.Tensor) -> torch.dtype:
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


def _one_hot(index: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot(index, n, dtype=dtype)``: a comparison, so no
    bounds check reads the device."""
    classes = torch.arange(n, device=index.device)
    return (index[..., None] == classes).to(dtype)


def _route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
           rng=None) -> Tuple[torch.Tensor, torch.Tensor, Stats]:
    """Top-k routing of tokens (t, d): (expert index (t, k) int64, gate
    (t, k) float32) and the load statistics (assigned fraction, mean
    router probability), each (n_experts,) float32, that the aux loss is
    built from."""
    dtype = _promoted(x, router)
    logits = x.to(dtype) @ router.to(dtype)            # (t, n_experts)
    if cfg.router_noise > 0 and rng is not None:
        noise = jrandom.normal(jrandom.as_key(rng, logits.device),
                               tuple(logits.shape))
        logits = logits + cfg.router_noise * noise.to(dtype)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    # Stable: equal probabilities keep ascending expert order, lax.top_k's.
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    expert_index = order[:, :cfg.top_k]
    gate = torch.gather(probs, 1, expert_index)
    if cfg.top_k > 1:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    assigned = _one_hot(expert_index, cfg.n_experts,
                        torch.float32).sum(dim=1).mean(dim=0)
    density_proxy = probs.mean(dim=0)
    return expert_index, gate, (assigned, density_proxy)


def _aux_from_stats(stats: Stats, cfg: MoEConfig) -> torch.Tensor:
    assigned, density_proxy = stats
    return cfg.n_experts * torch.sum(assigned * density_proxy) / cfg.top_k


def apply_dense(params: Dict[str, Any], cfg: MoEConfig, x: torch.Tensor,
                rng=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) → (the gate-weighted expert mixture (b, s, d) in the
    promoted type of x and the weights, the aux loss as a float32
    scalar). No capacity limit: every token reaches its top-k experts."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    expert_index, gate, stats = _route(tokens, params["router"], cfg, rng)
    aux = _aux_from_stats(stats, cfg)
    # The top-k experts of a token are distinct, so the k one-hots are
    # disjoint: one 0/1 dispatch matrix feeds one pass of every expert,
    # and the gate weights separate the slots again in the combine.
    one_hot = _one_hot(expert_index, cfg.n_experts, x.dtype)   # (t, k, e)
    dispatch = one_hot.sum(dim=1)                               # (t, e)
    weights = (one_hot * gate.to(x.dtype)[..., None]).sum(dim=1)
    # (experts, tokens, d): each expert's tokens, zeros elsewhere.
    dispatched = dispatch.t()[:, :, None] * tokens[None]
    w_in, w_out = params["w_in"], params["w_out"]
    dt = _promoted(dispatched, w_in)
    hidden = F.silu(torch.bmm(dispatched.to(dt), w_in.to(dt)))  # (e, t, f)
    dt = _promoted(hidden, w_out)
    out = torch.bmm(hidden.to(dt), w_out.to(dt))                # (e, t, d)
    # einsum("etd,te->td"): exact products summed in float32, rounded once.
    dt = _promoted(out, weights)
    combined = (out.to(torch.float32)
                * weights.t().to(torch.float32)[:, :, None]).sum(dim=0)
    return combined.to(dt).reshape(b, s, d), aux


def param_logical_axes() -> Dict[str, Tuple]:
    return {
        "router": ("embed", None),
        "w_in": ("expert", "embed", "mlp"),
        "w_out": ("expert", "mlp", "embed"),
    }


def _line(mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(pieces, this rank's piece) of a dim sharded over ``axes``,
    row-major over them."""
    pieces, index = 1, 0
    for axis in axes:
        n = int(dict(mesh.shape).get(axis, 1))
        pieces, index = pieces * n, index * n + mesh.axis_index(axis)
    return pieces, index


def apply_sharded(params: Dict[str, Any], cfg: MoEConfig, x: torch.Tensor,
                  mesh, axis_name: str = "ep", rng=None, batch_axes=None,
                  tp_axis=None, capacity=None, whole: bool = True):
    """Expert-parallel forward on one rank of a mesh: ``x`` (b, s, d) is
    the whole batch (every rank holds it), ``params`` the rank's block
    (``w_in`` (n_experts / ep, d, d_ff / tp), ``w_out`` (n_experts / ep,
    d_ff / tp, d), the router whole). The rank takes its contiguous piece
    of the batch dim over ``batch_axes`` (default ``(axis_name,)``), routes
    it, places each assignment in its expert's capacity buffer in arrival
    order (slot-major, so primary slots win), exchanges the buffers with
    one all_to_all over ``axis_name``, runs its experts, completes their
    partial sums over ``tp_axis`` (when given) with one all-reduce,
    returns the tokens with a second all_to_all and combines them by
    gate. The pieces are all-gathered back over ``batch_axes``, so every
    rank returns the whole (b, s, d) output, and the load statistics are
    averaged over those axes before their product: the aux loss is the
    dense one. ``capacity`` overrides ``capacity_factor``: the serving
    dispatch passes its per-rank token count, which makes it dropless.
    An assignment past capacity contributes zero, or, with
    ``dropped_identity``, its token.

    ``whole=False`` (the train step): ``x`` is already this rank's piece
    of the batch, and the output is that piece's, with no all-gather; the
    capacity is sized for the piece's tokens, as JAX's ``shard_map`` body
    sizes it."""
    if batch_axes is None:
        batch_axes = (axis_name,)
    n_shards = int(dict(mesh.shape)[axis_name])
    if cfg.n_experts % n_shards:
        raise ValueError(f"n_experts {cfg.n_experts} not divisible by "
                         f"ep={n_shards}")
    if tp_axis is not None and cfg.d_ff % int(dict(mesh.shape)[tp_axis]):
        raise ValueError(f"d_ff {cfg.d_ff} not divisible by "
                         f"{tp_axis}={dict(mesh.shape)[tp_axis]}")
    from tpu_task_torch.ml.parallel import collectives

    experts_per_shard = cfg.n_experts // n_shards
    x_local = x
    if whole:
        pieces, piece = _line(mesh, tuple(batch_axes))
        if x.shape[0] % pieces:
            raise ValueError(f"batch {x.shape[0]} does not divide over "
                             f"{tuple(batch_axes)} ({pieces})")
        step = x.shape[0] // pieces
        x_local = x[piece * step:(piece + 1) * step]
    b, s, d = x_local.shape
    tokens = x_local.reshape(b * s, d)
    n_tokens = tokens.shape[0]
    shard_rng = rng
    if shard_rng is not None:
        for ax in batch_axes:
            shard_rng = jrandom.fold_in(jrandom.as_key(shard_rng),
                                        mesh.axis_index(ax))
    expert_index, gate, stats = _route(tokens, params["router"], cfg,
                                       shard_rng)
    cap = capacity if capacity is not None else max(
        1, int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts))
    flat_expert = expert_index.t().reshape(-1)        # (k * n_tokens,)
    flat_gate = gate.t().reshape(-1)
    flat_tokens = tokens.repeat(cfg.top_k, 1)
    one_hot = _one_hot(flat_expert, cfg.n_experts, torch.int64)
    position = (torch.cumsum(one_hot, dim=0) * one_hot).sum(dim=-1) - 1
    keep = position < cap
    safe_pos = torch.where(keep, position, torch.zeros_like(position))
    buffer = torch.zeros((cfg.n_experts, cap, d), dtype=x.dtype,
                         device=x.device)
    buffer.index_put_((flat_expert, safe_pos),
                      flat_tokens * keep[:, None].to(tokens.dtype),
                      accumulate=True)
    grouped = buffer.reshape(n_shards, experts_per_shard, cap, d)
    exchanged = collectives.all_to_all(mesh, grouped, axis_name)
    w_in, w_out = params["w_in"], params["w_out"]
    dt = _promoted(exchanged, w_in)
    hidden = F.silu(torch.einsum("xecd,edf->xecf", exchanged.to(dt),
                                 w_in.to(dt)))
    dt = _promoted(hidden, w_out)
    out = torch.einsum("xecf,efd->xecd", hidden.to(dt), w_out.to(dt))
    if tp_axis is not None:
        out = collectives.all_reduce(mesh, out, tp_axis)
    returned = collectives.all_to_all(mesh, out, axis_name).reshape(
        cfg.n_experts, cap, d)
    delivered = returned[flat_expert, safe_pos]
    if cfg.dropped_identity:
        slot_out = torch.where(keep[:, None], delivered,
                               flat_tokens.to(delivered.dtype))
    else:
        slot_out = delivered * keep[:, None].to(tokens.dtype)
    combined = (slot_out * flat_gate[:, None].to(tokens.dtype)).reshape(
        cfg.top_k, n_tokens, d).sum(dim=0)
    for ax in dict.fromkeys((*batch_axes, axis_name)):
        size = int(dict(mesh.shape).get(ax, 1))
        stats = tuple(collectives.all_reduce(mesh, st, ax, conjugate=True)
                      / size for st in stats)
    aux = _aux_from_stats(stats, cfg)
    out = combined.reshape(b, s, d)
    if whole:
        for ax in reversed(tuple(batch_axes)):
            out = collectives.all_gather(mesh, out, ax, dim=0)
    return out, aux


__all__ = ["MoEConfig", "apply_dense", "apply_sharded", "init",
           "param_logical_axes"]
