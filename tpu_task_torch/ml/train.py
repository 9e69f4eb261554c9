"""The training step for the flagship transformer, on one device and
sharded over a mesh of ranks — the counterpart of
``tpu_task/ml/train.py``'s ``TrainState``, ``make_optimizer``,
``init_state``, ``state_pspecs``, ``shard_state``, ``make_train_step``,
``make_moe_train_step``, ``make_sp_train_step`` and the pipeline half
(``pp_stack_params`` to ``make_pp_train_step``).

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
the ``moe_fn`` the caller passes).

**Sharded over a mesh** (``dp``, ``fsdp``, ``tp``; ``ep`` for
:func:`make_moe_train_step`) the step is SPMD: one process a mesh
position, every rank running the same script after
``distributed_init_from_env()`` and ``make_mesh``. Each rank holds its
block of every leaf (:func:`shard_state`, under :func:`state_pspecs`,
JAX's spec tree) and takes its rows of the batch (``mesh.local_batch``:
the batch axes' piece; ``tp`` ranks share rows). It back-propagates its
rows' mean loss over the number of batch pieces through the model's
gathers and ``tp`` pair, all-reduces each gradient in float32 over the
batch axes its leaf is not sharded on, and takes the global norm as the
sum of each leaf's squares over the axes it is sharded on, and only
those; every rank then applies the same elementwise AdamW to its blocks.
The loss is the mean of the pieces' token means: JAX's global token mean.

**Sequence-parallel** (:func:`make_sp_train_step`, an ``sp`` axis beside
any of those) each rank also cuts its contiguous window of every row's
sequence (``mesh.sequence_piece``), rotated at its global positions, and
attention crosses the windows through the zigzag ring or Ulysses
(``ml/parallel``). The params replicate over ``sp``, so ``sp`` joins the
axes that gradients and the loss reduce over.

**Pipeline-parallel** (:func:`make_pp_train_step`, a ``pp`` axis beside
any batch axes) the layers stack into P stages (:func:`pp_stack_params`:
``{"embed", "final_norm", "unembed", "stages"}``, each ``stages`` leaf
``(P, layers_per_stage, ...)``), each rank holds its stage's block and
the replicated embedding and head (:func:`shard_pp_state`), and the step
runs the 1F1B schedule of ``ml/parallel/pipeline.py`` over its rows."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpu_task_torch.device import resolve_device
from tpu_task_torch.ml.models import transformer
from tpu_task_torch.ml.ops.attention import dot_product_attention
from tpu_task_torch.ml.parallel import collectives
from tpu_task_torch.ml.parallel.mesh import batch_shard, sequence_piece
from tpu_task_torch.ml.parallel.sharding import (
    PartitionSpec,
    _map,
    entry_axes,
    logical_to_mesh_axes,
    mesh_axis_size,
    mesh_batch_axes,
    shard_leaf,
    spec_axes,
    spec_leaves,
)
from tpu_task_torch.ml.tree import leaves, tree_map

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
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], opt_state: Dict[str, Any],
               params: Params, norm: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """Apply one step to ``params`` and ``opt_state`` in place;
        ``grads`` in the order of ``params``' leaves (``jax.tree.leaves``
        order; :func:`_leaves` for the model's tree), clipped in place.
        ``norm``: their global norm when the caller has it (a sharded
        step's, over the whole arrays: :func:`sharded_global_norm`).
        Returns the global norm before clipping."""
        if norm is None:
            norm = global_norm(grads)
        keep = norm < MAX_NORM
        count = opt_state["count"] + 1
        opt_state["count"] = count
        c1 = 1.0 - B1 ** count
        c2 = 1.0 - B2 ** count
        for p, g, mu, nu in zip(leaves(params), grads,
                                leaves(opt_state["mu"]),
                                leaves(opt_state["nu"])):
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
    state. A pipeline state (params with ``stages``, JAX's
    ``init_pp_state`` layout) stays in that layout."""
    device = resolve_device(device)
    adam = tree.opt_state[1][0]

    def tensors(value) -> Params:
        if "stages" in value:
            n_stages = len(next(iter(value["stages"].values())))
            return pp_stack_params(tensors(pp_unstack_params(value)),
                                   n_stages)
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
    jax.tree.leaves(state_to_numpy(state)))`` is a JAX state (a pipeline
    state's too)."""
    def arrays(params: Params):
        if "stages" in params:
            return tree_map(lambda t: t.detach().to(
                "cpu", torch.float32).numpy(), params)
        return transformer.params_to_numpy(params)

    opt = state.opt_state
    return TrainState(
        step=np.asarray(state.step, np.int32), params=arrays(state.params),
        opt_state={"count": np.asarray(opt["count"], np.int32),
                   "mu": arrays(opt["mu"]), "nu": arrays(opt["nu"])})


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP A14")


# -- sharded state -------------------------------------------------------------

def _opt_specs_like(p_specs: Params, opt_state) -> Any:
    """Each optimizer-state leaf's spec: the param spec whose tree path is
    the longest suffix of the leaf's path (``mu/layers/0/wq`` takes
    ``layers/0/wq``'s), when the leaf has at least that spec's dims; else
    replicated (the count). JAX's suffix rule, so two same-shaped params
    with other layouts never swap."""
    param_paths = {}
    _map(lambda path, spec: param_paths.setdefault(path, spec), p_specs,
         lambda x: isinstance(x, PartitionSpec))

    def spec_for(path, leaf):
        for start in range(len(path)):
            spec = param_paths.get(path[start:])
            if spec is not None and np.ndim(leaf) >= len(spec):
                return spec
        return PartitionSpec()

    return _map(spec_for, opt_state, lambda x: False)


def state_pspecs(state: TrainState, cfg: transformer.TransformerConfig,
                 mesh) -> TrainState:
    """PartitionSpecs for a TrainState: ``step`` replicated, the params by
    the model's rules, the AdamW moments following the params and the
    count replicated. Its ``spec_leaves`` are ``jax.tree.leaves`` of JAX's
    ``state_pspecs``, leaf for leaf."""
    p_specs = transformer.param_pspecs(cfg, mesh=mesh)
    return TrainState(step=PartitionSpec(), params=p_specs,
                      opt_state=_opt_specs_like(p_specs, state.opt_state))


def shard_state(state: TrainState, cfg: transformer.TransformerConfig,
                mesh) -> Tuple[TrainState, TrainState]:
    """(this rank's blocks of the whole ``state``, on the mesh's device;
    the spec tree): JAX's ``shard_state`` for one mesh position. The
    ints stay ints."""
    specs = state_pspecs(state, cfg, mesh)
    return _cut_state(state, specs, mesh), specs


def _cut_state(state: TrainState, specs: TrainState, mesh) -> TrainState:
    """This rank's block of each tensor of ``state`` under ``specs``."""
    def walk(tree, spec_tree):
        if isinstance(spec_tree, PartitionSpec):
            if isinstance(tree, torch.Tensor):
                return shard_leaf(tree, spec_tree, mesh)
            return tree
        if isinstance(tree, dict):
            return {k: walk(v, spec_tree[k]) for k, v in tree.items()}
        if isinstance(tree, TrainState):
            return TrainState(*(walk(v, sp)
                                for v, sp in zip(tree, spec_tree)))
        return type(tree)(walk(v, sp) for v, sp in zip(tree, spec_tree))

    return walk(state, specs)


def _token_shard_factor(mesh, activation_spec) -> int:
    """How many ways the (batch, seq) token grid shards on this mesh: from
    the activation spec's first two entries when one is given, else from
    the logical batch rule. JAX sizes the fused cross-entropy's tile with
    it; a rank of the port holds that many times fewer tokens."""
    if mesh is None:
        return 1
    if activation_spec is not None:
        spec = getattr(activation_spec, "spec", activation_spec)
    else:
        spec = logical_to_mesh_axes(("batch", "seq"), mesh=mesh)
    factor = 1
    for entry in tuple(spec)[:2]:
        for axis in spec_axes((entry,)):
            factor *= int(mesh.shape[axis])
    return factor


@torch.no_grad()
def _reduce_grads(grads: List[torch.Tensor], specs: List[PartitionSpec],
                  mesh, batch_axes: Tuple[str, ...]) -> None:
    """Sum each gradient over the batch axes (and the sequence axis) its
    leaf is not sharded on, in place: the ranks of such an axis saw other
    rows, or other tokens of them, through the same block. Leaves that
    reduce over the same axes go as one float32 buffer, one all-reduce an
    axis."""
    groups: Dict[Tuple[str, ...], List[int]] = {}
    for i, spec in enumerate(specs):
        named = set(spec_axes(spec))
        over = tuple(a for a in batch_axes
                     if a not in named and mesh_axis_size(mesh, a) > 1)
        if over:
            groups.setdefault(over, []).append(i)
    for over, index in groups.items():
        flat = torch.cat([grads[i].reshape(-1).to(torch.float32)
                          for i in index])
        for axis in over:
            flat = collectives.all_reduce(mesh, flat, axis)
        for i, part in zip(index, flat.split([grads[i].numel()
                                              for i in index])):
            grads[i].copy_(part.view_as(grads[i]))


@torch.no_grad()
def sharded_global_norm(grads: List[torch.Tensor],
                        specs: List[PartitionSpec], mesh) -> torch.Tensor:
    """``optax.global_norm`` over the whole arrays of which ``grads`` are
    this rank's blocks: each leaf's sum of squares, summed over the mesh
    axes its leaf is sharded on and only those (a replicated block counts
    once), then added. The same float32 scalar on every rank."""
    groups: Dict[Tuple[str, ...], torch.Tensor] = {}
    for g, spec in zip(grads, specs):
        over = tuple(a for a in spec_axes(spec)
                     if mesh_axis_size(mesh, a) > 1)
        sq = g.to(torch.float32).square().sum()
        groups[over] = groups[over] + sq if over in groups else sq
    total = None
    for over, sq in groups.items():
        for axis in over:
            sq = collectives.all_reduce(mesh, sq, axis)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def _micro_pieces(mesh, tokens: torch.Tensor, batch_axes: Tuple[str, ...],
                  accum_steps: int) -> Tuple[torch.Tensor, ...]:
    """This rank's piece of each of the global batch's ``accum_steps``
    microbatches, from its contiguous rows: JAX cuts the global batch into
    microbatches and shards each over the batch axes, so rank ``i`` of
    ``n`` runs rows ``[i * m, (i + 1) * m)`` of each, ``m`` the
    microbatch over ``n``. The token ids are all-gathered over the batch
    axes (least significant first, undoing :func:`mesh.batch_shard`'s
    row-major cut) and cut again."""
    whole = tokens
    for axis in reversed(batch_axes):
        whole = collectives.all_gather(mesh, whole, axis)
    index, pieces = batch_shard(mesh)
    rows = whole.shape[0] // (accum_steps * pieces)
    return whole.reshape(accum_steps, pieces, rows,
                         *whole.shape[1:])[:, index].unbind(0)


def make_train_step(cfg: transformer.TransformerConfig, optimizer=None,
                    mesh=None, attn_fn=None, activation_spec=None,
                    accum_steps: int = 1, moe_fn=None):
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
    of its MoE layers, as in the JAX step.

    With a ``mesh`` it returns JAX's ``jit_with_state``: a function of
    this rank's state (its blocks, from :func:`shard_state`) that returns
    the sharded step, whose ``tokens`` are this rank's rows of the global
    batch (``mesh.local_batch``); a microbatch is each rank's rows cut
    ``accum_steps`` ways. ``activation_spec`` may name the batch axes
    (its first entry) and a sequence axis (its second: each rank cuts its
    window of every row, as :func:`make_sp_train_step`'s step does, which
    needs an ``attn_fn`` that crosses the windows)."""
    return _make_step(cfg, optimizer, mesh, attn_fn, activation_spec,
                      accum_steps, moe_fn)


def _make_step(cfg, optimizer, mesh, attn_fn, activation_spec,
               accum_steps: int, moe_fn, expert_axis: Optional[str] = None):
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    optimizer = optimizer or make_optimizer()
    batch_axes: Tuple[str, ...] = ()
    if mesh is not None:
        batch_axes = mesh_batch_axes(mesh)
    seq_axes: Tuple[str, ...] = ()
    if activation_spec is not None:
        named = transformer.activation_batch_axes(activation_spec)
        if mesh is not None and set(named) != set(batch_axes):
            _not_ported(f"activation_spec over batch axes {named} (the "
                        f"mesh's rows are cut over {batch_axes})")
        spec = tuple(getattr(activation_spec, "spec", activation_spec))
        seq_axes = entry_axes(spec[1]) if len(spec) > 1 else ()
        if seq_axes and attn_fn is None:
            raise ValueError("an activation_spec on the sequence needs an "
                             "attn_fn that crosses the ranks' windows: use "
                             "make_sp_train_step")
        if len(seq_axes) > 1:
            raise ValueError(f"the sequence shards over one axis, got "
                             f"{seq_axes}")
    seq_axis = seq_axes[0] if seq_axes and mesh is not None else None
    reduce_axes = batch_axes + ((seq_axis,) if seq_axis else ())
    pieces = _token_shard_factor(mesh, activation_spec)
    pspecs = (transformer.param_pspecs(cfg, mesh=mesh)
              if mesh is not None else None)
    leaf_specs = _leaves(pspecs) if pspecs is not None else None
    # A microbatch's tokens share the MoE layers' capacity and router
    # statistics, so which rows it holds matters there, not in a token mean.
    coupled = (expert_axis is not None and accum_steps > 1
               and len(batch_axes) > 0)

    def window(tokens: torch.Tensor):
        """This rank's window of every row over ``seq_axis`` (its chunk of
        the S-token sequence and the next token, the last target) and the
        chunk's global positions."""
        if seq_axis is None:
            return tokens, None
        _, n, start = sequence_piece(tokens.shape[1] - 1, mesh, seq_axis)
        chunk = (tokens.shape[1] - 1) // n
        return (tokens[:, start:start + chunk + 1],
                torch.arange(start, start + chunk, device=tokens.device))

    def loss_and_grads(params: Params, tokens: torch.Tensor):
        tokens, positions = window(tokens)
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            batch = tokens.shape[0]
            if batch % accum_steps:
                raise ValueError(f"batch {batch} not divisible by "
                                 f"accum_steps {accum_steps}")
            loss_sum, grad_sum = None, None
            micros = (_micro_pieces(mesh, tokens, batch_axes, accum_steps)
                      if coupled else tokens.chunk(accum_steps))
            for micro in micros:
                loss = transformer.loss_fn(
                    params, cfg, micro, attn_fn=attn_fn, moe_fn=moe_fn,
                    mesh=mesh, pspecs=pspecs, expert_axis=expert_axis,
                    positions=positions)
                # Each rank's loss is its rows' mean: the pieces' mean is
                # the global one, so each back-propagates its share.
                scaled = loss if pieces == 1 else loss * (1.0 / pieces)
                # A leaf the loss does not reach (a MoE layer's weights
                # under a moe_fn that ignores them) gets a zero gradient,
                # as under jax.grad.
                grads = torch.autograd.grad(scaled, leaves,
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
        norm = None
        if mesh is not None:
            _reduce_grads(grads, leaf_specs, mesh, reduce_axes)
            norm = sharded_global_norm(grads, leaf_specs, mesh)
            with torch.no_grad():
                for axis in reduce_axes:
                    loss = collectives.all_reduce(mesh, loss, axis)
                loss = loss / pieces
        gnorm = optimizer.update(grads, state.opt_state, state.params,
                                 norm=norm)
        return (TrainState(step=state.step + 1, params=state.params,
                           opt_state=state.opt_state),
                {"loss": loss.float(), "grad_norm": gnorm})

    if mesh is None:
        return step

    def with_state(state: TrainState):
        for leaf, spec in zip(_leaves(state.params), leaf_specs):
            if leaf.dim() != len(spec):
                raise ValueError(f"a {leaf.dim()}-d param block under "
                                 f"spec {spec}")
        return step

    return with_state


# -- pipeline parallelism ------------------------------------------------------

def _stack(values):
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values)
    return np.stack([np.asarray(v) for v in values])


def pp_stack_params(params: Params, n_stages: int) -> Params:
    """The model's params in the pipeline layout: ``{"embed",
    "final_norm", "unembed", "stages"}``, each ``stages`` leaf the layers'
    leaf stacked to ``(n_stages, layers_per_stage, ...)``, stage s holding
    a contiguous run of layers. Tensors or numpy arrays (JAX's leaves),
    as JAX's ``pp_stack_params``."""
    layers = params["layers"]
    n_layers = len(layers)
    if n_layers % n_stages:
        raise ValueError(f"n_layers {n_layers} not divisible by "
                         f"{n_stages} pipeline stages")
    lps = n_layers // n_stages
    return {
        "embed": params["embed"],
        "final_norm": params["final_norm"],
        "unembed": params["unembed"],
        "stages": {name: _stack([_stack([layers[s * lps + j][name]
                                         for j in range(lps)])
                                 for s in range(n_stages)])
                   for name in layers[0]},
    }


def pp_unstack_params(pp_params: Params) -> Params:
    """The inverse of :func:`pp_stack_params` (for checkpoint interchange
    and the equivalence tests); tensors or numpy arrays."""
    stages = pp_params["stages"]
    first = next(iter(stages.values()))
    n_stages, lps = first.shape[0], first.shape[1]
    return {
        "embed": pp_params["embed"],
        "final_norm": pp_params["final_norm"],
        "unembed": pp_params["unembed"],
        "layers": [{name: leaf[s, j] for name, leaf in stages.items()}
                   for s in range(n_stages) for j in range(lps)],
    }


def init_pp_state(rng, cfg: transformer.TransformerConfig, n_stages: int,
                  optimizer=None, device=None) -> TrainState:
    """A TrainState in the pipeline layout whose params are the sequential
    init's, stacked (:func:`pp_stack_params`), with zeroed moments, on
    ``device`` (CUDA unless the caller passes ``device="cpu"``). ``rng``:
    a ``torch.Generator`` (:func:`init_state`'s draws), or a raw JAX key
    (the ``uint32[2]`` words of ``jax.random.PRNGKey(seed)``), whose
    params are JAX's ``init_pp_state``'s bit for bit
    (``transformer.init_from_key``)."""
    device = resolve_device(device)
    optimizer = optimizer or make_optimizer()
    if isinstance(rng, torch.Generator):
        params = transformer.init(rng, cfg, param_dtype=torch.float32)
    else:
        params = transformer.init_from_key(rng, cfg)
    params = tree_map(lambda t: t.to(device),
                      pp_stack_params(params, n_stages))
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def pp_state_pspecs(state: TrainState, mesh=None,
                    axis_name: str = "pp") -> TrainState:
    """PartitionSpecs for a pipeline TrainState, JAX's
    ``pp_state_pspecs``: each stage-stacked leaf shards its leading stage
    axis over ``axis_name``; the embedding and head replicate; the
    moments follow the params and the count replicates."""
    p_specs = _pp_param_specs(state.params, axis_name)
    return TrainState(step=PartitionSpec(), params=p_specs,
                      opt_state=_opt_specs_like(p_specs, state.opt_state))


def _pp_param_specs(params: Params, axis_name: str) -> Params:
    return {"embed": PartitionSpec(), "final_norm": PartitionSpec(),
            "unembed": PartitionSpec(),
            "stages": {name: PartitionSpec(axis_name)
                       for name in params["stages"]}}


def shard_pp_state(state: TrainState, mesh,
                   axis_name: str = "pp") -> Tuple[TrainState, TrainState]:
    """(this rank's blocks of the whole pipeline ``state``: its stage's
    ``(1, layers_per_stage, ...)`` block of every stage leaf and moment,
    the replicated leaves whole, on the mesh's device; the spec tree)."""
    specs = pp_state_pspecs(state, mesh, axis_name)
    return _cut_state(state, specs, mesh), specs


def make_pp_train_step(cfg: transformer.TransformerConfig, mesh,
                       n_microbatches: int, optimizer=None,
                       axis_name: str = "pp"):
    """The pipeline-parallel train step (1F1B): JAX's
    ``make_pp_train_step``. The model's layers split into the ``pp``
    stages (each rank its stage's ``layers_per_stage`` blocks, unrolled);
    the embedding runs before the pipeline on the rank's rows and its
    gradient comes back through the pipeline's ``dx``; the final norm,
    the unembedding (cast to ``cfg.dtype``) and the fused cross-entropy
    are the head, run by the last stage on each microbatch; each stage's
    backward recomputes its forward. Then one AdamW update whose norm is
    the whole model's (each stage's leaves once, the replicated ones
    once). The batch axes of the mesh (``dp``, ``fsdp``, ``ep``) each
    pipeline their own rows, the gradients averaged over them.

    Returns, as :func:`make_train_step` with a mesh, a function of the
    rank's state (:func:`shard_pp_state`'s blocks) that returns the step;
    the step takes the rank's rows over the batch axes
    (``mesh.local_batch``)."""
    from tpu_task_torch.ml.parallel.pipeline import pipeline_train

    optimizer = optimizer or make_optimizer()
    if axis_name not in dict(mesh.shape):
        raise ValueError(f"mesh has no {axis_name!r} axis: "
                         f"{mesh.axis_names}")
    n_stages = mesh_axis_size(mesh, axis_name)
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                         f"{n_stages} pipeline stages")
    if any(cfg.is_moe_layer(i) for i in range(cfg.n_layers)):
        raise ValueError("pipeline step supports dense layers only "
                         "(MoE layers go through make_moe_train_step)")
    lps = cfg.n_layers // n_stages
    batch_axes = mesh_batch_axes(mesh)

    def attn(q, k, v):
        return dot_product_attention(
            q, transformer.expand_kv(k, cfg.n_heads),
            transformer.expand_kv(v, cfg.n_heads), True)

    def stage_fn(stage_layers, h):
        for j in range(lps):
            layer = {name: leaf[j] for name, leaf in stage_layers.items()}
            h, _aux = transformer._block(h, layer, cfg, attn)
        return h

    def head_loss(head, out_mb, tgt_mb):
        h = transformer._rmsnorm(out_mb, head["final_norm"])
        b, s, d = h.shape
        return transformer.fused_xent(
            h.reshape(b * s, d), head["unembed"].to(cfg.dtype),
            tgt_mb.reshape(-1))

    def with_state(state: TrainState):
        leaf_specs = spec_leaves(_pp_param_specs(state.params, axis_name))
        for leaf, spec in zip(leaves(state.params), leaf_specs):
            if spec and leaf.shape[0] != 1:
                raise ValueError(f"a stage block of {leaf.shape[0]} stages:"
                                 " shard_pp_state cuts each rank's one")

        def step(state: TrainState, tokens: torch.Tensor):
            params = state.params
            tokens = tokens.long()
            inp, tgt = tokens[:, :-1], tokens[:, 1:]
            table = params["embed"].detach().requires_grad_(True)
            with torch.enable_grad():
                x = transformer.embed_lookup(table.to(cfg.dtype), inp)
            head = {"final_norm": params["final_norm"],
                    "unembed": params["unembed"]}
            loss, stage_grads, head_grads, dx = pipeline_train(
                stage_fn, params["stages"], x.detach(), tgt, head_loss,
                mesh, n_microbatches, axis_name=axis_name, head_params=head,
                batch_axes=batch_axes)
            (d_embed,) = torch.autograd.grad(x, [table], dx.to(x.dtype))
            # The replicated embedding saw this rank's rows: its gradient
            # sums over the batch axes (dx carries the 1 / pieces of the
            # mean).
            _reduce_grads([d_embed], [PartitionSpec()], mesh, batch_axes)
            grads = leaves({"embed": d_embed, **head_grads,
                            "stages": stage_grads})
            norm = sharded_global_norm(grads, leaf_specs, mesh)
            gnorm = optimizer.update(grads, state.opt_state, params,
                                     norm=norm)
            return (TrainState(step=state.step + 1, params=params,
                               opt_state=state.opt_state),
                    {"loss": loss.float(), "grad_norm": gnorm})

        return step

    return with_state


def make_moe_train_step(cfg: transformer.TransformerConfig, mesh,
                        optimizer=None, axis_name: str = "ep",
                        accum_steps: int = 1):
    """The expert-parallel train step of a MoE config: JAX's
    ``make_moe_train_step``. Its MoE layers dispatch through
    ``moe.apply_sharded`` on each rank's own tokens, two all_to_alls over
    ``axis_name`` a layer each way (their gradients the reverse
    exchanges), the experts one group a rank; the tokens shard over every
    batch axis of the mesh plus ``axis_name``. Returns, as
    :func:`make_train_step` with a mesh, a function of the rank's state
    that returns the step. With ``accum_steps > 1`` each rank runs its
    piece of each global microbatch, as JAX's step does (the capacity and
    the router statistics are a microbatch's), not its own rows cut
    ``accum_steps`` ways."""
    from tpu_task_torch.ml.models import moe

    if axis_name not in dict(mesh.shape):
        raise ValueError(f"mesh has no {axis_name!r} axis: "
                         f"{mesh.axis_names}")
    if not any(cfg.is_moe_layer(i) for i in range(cfg.n_layers)):
        raise ValueError("config has no MoE layers (set moe_every/n_experts)")
    mcfg = cfg.moe_cfg
    batch_axes = mesh_batch_axes(mesh)
    if axis_name not in batch_axes:
        batch_axes = (*batch_axes, axis_name)

    def moe_fn(layer, h):
        return moe.apply_sharded(layer, mcfg, h, mesh, axis_name=axis_name,
                                 batch_axes=batch_axes, whole=False)

    return _make_step(cfg, optimizer, mesh, None,
                      PartitionSpec(batch_axes, None, None), accum_steps,
                      moe_fn, expert_axis=axis_name)


def make_sp_train_step(cfg: transformer.TransformerConfig, mesh,
                       optimizer=None, axis_name: str = "sp",
                       context_parallel: str = "zigzag"):
    """The sequence-parallel (long-context) train step: JAX's
    ``make_sp_train_step``. Each row's activations shard over
    ``axis_name`` in contiguous chunks; params and optimizer state
    replicate over it and follow the usual rules on the mesh's other axes
    (``dp``, ``fsdp``, ``tp``). Returns, as :func:`make_train_step` with a
    mesh, a function of the rank's state that returns the step; the step
    takes the rank's rows over the batch axes at full length, (b_local, S
    + 1) as ``mesh.local_batch`` gives them, and each rank cuts its window
    of S / sp + 1 tokens.

    ``context_parallel`` picks how attention crosses the chunks:
    ``"zigzag"`` (the balanced causal ring; 2 sp must divide S) or
    ``"ulysses"`` (two all_to_alls around one full-length attention;
    ``n_heads % sp == 0``). A MoE config raises: JAX's step averages the
    router statistics over the whole sequence, a rank's dense dispatch
    sees its chunk (ROADMAP A14)."""
    from tpu_task_torch.ml.parallel.ring_attention import (
        zigzag_ring_attention)
    from tpu_task_torch.ml.parallel.ulysses import ulysses_attention

    batch_axes = mesh_batch_axes(mesh) or None
    if context_parallel == "zigzag":
        def attn(q, k, v):
            return zigzag_ring_attention(q, k, v, mesh, axis_name=axis_name,
                                         batch_axes=batch_axes)
    elif context_parallel == "ulysses":
        def attn(q, k, v):
            return ulysses_attention(q, k, v, mesh, axis_name=axis_name,
                                     batch_axes=batch_axes)
    else:
        raise ValueError(f"unknown context_parallel {context_parallel!r} "
                         "(use 'zigzag' or 'ulysses')")
    if axis_name not in dict(mesh.shape):
        raise ValueError(f"mesh has no {axis_name!r} axis: "
                         f"{mesh.axis_names}")
    if any(cfg.is_moe_layer(i) for i in range(cfg.n_layers)):
        _not_ported("the sequence-parallel step of a MoE config (its "
                    "router statistics span the whole sequence)")
    return _make_step(cfg, optimizer, mesh, attn,
                      PartitionSpec(batch_axes, axis_name, None), 1, None)
