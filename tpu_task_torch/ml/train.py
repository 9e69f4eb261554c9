"""The single-device training step for the flagship transformer — the
counterpart of ``tpu_task/ml/train.py``'s ``TrainState``,
``make_optimizer``, ``init_state`` and ``make_train_step``.

The JAX step is one jitted function that donates its state buffers, so
XLA updates parameters and moments in place. PyTorch runs eagerly and the
port updates the state's tensors in place instead: a step returns the same
tensors it was given, changed. Parameters are float32 master weights; the
model casts each to ``cfg.dtype`` where it is used.

The state flattens to the JAX ``TrainState``'s leaves in their order
(``step``, the params with dict keys sorted, AdamW's ``count``, ``mu``,
``nu``; optax's empty states hold none), so a checkpoint of either package
restores into the other (``tpu_task_torch.ml.checkpoint``).

A config with mixture-of-experts layers trains through the same step: its
loss adds the router loss, and its MoE layers run the dense dispatch (or
the ``moe_fn`` the caller passes). The sharded steps (a ``mesh``, pipeline,
expert and sequence parallelism) are not ported yet (ROADMAP A14) and
raise."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from tpu_task_torch.device import resolve_device
from tpu_task_torch.ml.models import transformer

Params = transformer.Params


class TrainState(NamedTuple):
    """``step`` and ``opt_state["count"]`` are Python ints; a checkpoint
    writes each as JAX's int32 0-d leaf. ``opt_state`` is ``{"count",
    "mu", "nu"}`` with ``mu`` and ``nu`` shaped like ``params``."""
    step: int
    params: Params
    opt_state: Any


def _leaves(params: Params) -> List[torch.Tensor]:
    """Every tensor of a params-shaped tree in ``jax.tree.leaves`` order:
    dict keys sorted (``embed``, ``final_norm``, the layers, ``unembed``)."""
    out = [params["embed"], params["final_norm"]]
    for layer in params["layers"]:
        out.extend(layer[name] for name in sorted(layer))
    out.append(params["unembed"])
    return out


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (``optax.global_norm``),
    as a float32 scalar on the tensors' device."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


#: ``train.make_optimizer``'s constants: clip at global norm 1.0, then
#: AdamW with b1 0.9, b2 0.95, eps 1e-8.
MAX_NORM, B1, B2, EPS = 1.0, 0.9, 0.95, 1e-8


class AdamW:
    """``optax.chain(clip_by_global_norm(MAX_NORM), adamw(lr, B1, B2, EPS,
    weight_decay=weight_decay))``, written out over lists of tensors and
    applied in place.

    - Clipping is optax's rule: gradients stay as they are while their
      global norm is below MAX_NORM and are scaled by MAX_NORM / norm
      otherwise (``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6
      instead).
    - The update is optax's ``scale_by_adam`` (bias-corrected moments,
      eps outside the square root) plus decoupled weight decay on every
      leaf, norms and embeddings included (optax's unmasked default), times
      -lr."""

    def __init__(self, lr: float = 3e-4, weight_decay: float = 0.01):
        self.lr, self.weight_decay = lr, weight_decay

    def init(self, params: Params) -> Dict[str, Any]:
        return {"count": 0,
                "mu": transformer.map_params(torch.zeros_like, params),
                "nu": transformer.map_params(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], opt_state: Dict[str, Any],
               params: Params) -> torch.Tensor:
        """Apply one step to ``params`` and ``opt_state`` in place;
        ``grads`` in :func:`_leaves` order (they are clipped in place).
        Returns their global norm before clipping."""
        leaves = _leaves(params)
        norm = global_norm(grads)
        keep = norm < MAX_NORM
        count = opt_state["count"] + 1
        opt_state["count"] = count
        c1 = 1.0 - B1 ** count
        c2 = 1.0 - B2 ** count
        for p, g, mu, nu in zip(leaves, grads, _leaves(opt_state["mu"]),
                                _leaves(opt_state["nu"])):
            g.copy_(torch.where(keep, g, g / norm * MAX_NORM))
            mu.mul_(B1).add_((1.0 - B1) * g)
            nu.mul_(B2).add_((1.0 - B2) * g.square())
            upd = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
            upd.add_(self.weight_decay * p)
            p.add_(-self.lr * upd)
        return norm


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01) -> AdamW:
    """Global-norm clipping, then AdamW — ``train.make_optimizer`` of the
    JAX package."""
    return AdamW(lr=lr, weight_decay=weight_decay)


def init_state(generator: torch.Generator,
               cfg: transformer.TransformerConfig, optimizer=None,
               device=None) -> TrainState:
    """Float32 master weights drawn from ``generator`` (on its device),
    moved to ``device`` — CUDA unless the caller passes ``device="cpu"``
    — with zeroed optimizer moments."""
    device = resolve_device(device)
    optimizer = optimizer or make_optimizer()
    params = transformer.params_to(
        transformer.init(generator, cfg, param_dtype=torch.float32), device)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def state_from_jax(tree, cfg: transformer.TransformerConfig,
                   device=None) -> TrainState:
    """The JAX ``TrainState`` (leaves as numpy arrays: ``jax.tree.map(
    np.asarray, state)``) of ``make_optimizer``'s chain as the port's state
    on ``device`` (CUDA unless the caller passes ``device="cpu"``): step,
    float32 params, AdamW's count and both moments. The moments sit at
    ``opt_state[1][0]``, the ``ScaleByAdamState`` after the clip's empty
    state."""
    device = resolve_device(device)
    adam = tree.opt_state[1][0]

    def tensors(value) -> Params:
        return transformer.params_from_jax(value, cfg, device,
                                           param_dtype=torch.float32)

    return TrainState(step=int(tree.step), params=tensors(tree.params),
                      opt_state={"count": int(adam.count),
                                 "mu": tensors(adam.mu),
                                 "nu": tensors(adam.nu)})


def state_to_numpy(state: TrainState) -> TrainState:
    """The state with numpy leaves, the ints as int32 0-d arrays:
    ``jax.tree.leaves`` of it are the JAX ``TrainState``'s leaves in their
    order, so ``jax.tree.unflatten(jax.tree.structure(jax_state),
    jax.tree.leaves(state_to_numpy(state)))`` is a JAX state."""
    opt = state.opt_state
    return TrainState(
        step=np.asarray(state.step, np.int32),
        params=transformer.params_to_numpy(state.params),
        opt_state={"count": np.asarray(opt["count"], np.int32),
                   "mu": transformer.params_to_numpy(opt["mu"]),
                   "nu": transformer.params_to_numpy(opt["nu"])})


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP A14")


def make_train_step(cfg: transformer.TransformerConfig, optimizer=None,
                    mesh=None, attn_fn=None, activation_spec=None,
                    accum_steps: int = 1, moe_fn=None
                    ) -> Callable[[TrainState, torch.Tensor],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The (state, tokens) → (state, {"loss", "grad_norm"}) step: loss and
    gradients through :func:`transformer.loss_fn`, then one optimizer
    update, in place. ``grad_norm`` is the global norm before clipping.
    Metrics stay on the device as float32 scalars (reading them waits for
    the step).

    ``accum_steps > 1`` splits the batch into that many equal
    microbatches, runs them one after another and sums their gradients
    before the one update: the loss is a token mean over equal microbatches,
    so the mean of their gradients is the full batch's gradient.

    A MoE config's loss includes ``cfg.moe_aux_weight`` times the router
    loss; ``moe_fn(layer, h) -> (out, aux)`` replaces the dense dispatch
    of its MoE layers, as in the JAX step."""
    if mesh is not None:
        _not_ported("the sharded train step (mesh=...)")
    if activation_spec is not None:
        _not_ported("activation_spec (sequence-parallel sharding)")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    optimizer = optimizer or make_optimizer()

    def loss_and_grads(params: Params, tokens: torch.Tensor):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            batch = tokens.shape[0]
            if batch % accum_steps:
                raise ValueError(f"batch {batch} not divisible by "
                                 f"accum_steps {accum_steps}")
            loss_sum, grad_sum = None, None
            for micro in tokens.chunk(accum_steps):
                loss = transformer.loss_fn(params, cfg, micro,
                                           attn_fn=attn_fn, moe_fn=moe_fn)
                # A leaf the loss does not reach (a MoE layer's weights
                # under a moe_fn that ignores them) gets a zero gradient,
                # as under jax.grad.
                grads = torch.autograd.grad(loss, leaves,
                                            materialize_grads=True)
                loss = loss.detach()
                if grad_sum is None:
                    loss_sum, grad_sum = loss, list(grads)
                else:
                    loss_sum = loss_sum + loss
                    for acc, g in zip(grad_sum, grads):
                        acc.add_(g)
            if accum_steps > 1:
                scale = 1.0 / accum_steps
                loss_sum = loss_sum * scale
                for g in grad_sum:
                    g.mul_(scale)
            return loss_sum, grad_sum
        finally:
            for p in leaves:
                p.requires_grad_(False)

    def step(state: TrainState, tokens: torch.Tensor):
        loss, grads = loss_and_grads(state.params, tokens)
        gnorm = optimizer.update(grads, state.opt_state, state.params)
        return (TrainState(step=state.step + 1, params=state.params,
                           opt_state=state.opt_state),
                {"loss": loss.float(), "grad_norm": gnorm})

    return step


def make_pp_train_step(*args, **kwargs):
    _not_ported("the pipeline-parallel train step")


def make_moe_train_step(*args, **kwargs):
    _not_ported("the expert-parallel MoE train step")


def make_sp_train_step(*args, **kwargs):
    _not_ported("the sequence-parallel train step")
