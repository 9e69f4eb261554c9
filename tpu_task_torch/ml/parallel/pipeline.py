"""Pipeline parallelism over a ``pp`` mesh axis, GPipe and 1F1B: the
counterpart of ``tpu_task/ml/parallel/pipeline.py``.

Layers split into P contiguous stages, one a position along ``pp``; the
batch splits into M microbatches that stream through the stages.

* :func:`pipeline_apply`: GPipe's forward, M + P - 1 ticks (fill and
  drain); its bubble, (P - 1) / (M + P - 1) of the ticks, shrinks as M
  grows.
* :func:`pipeline_train`: the 1F1B training schedule. Forward and backward
  interleave per microbatch, so a stage holds at most 2P - 1 saved inputs
  instead of all M (why 1F1B exists); the backward recomputes the stage's
  forward from its saved INPUT under autograd (activation recomputation)
  and accumulates the stage's gradients.

Each rank is one mesh position and runs its own stage (SPMD, as the
port's other mesh steps): its stage block's leaves are ``(1, ...)``, its
rows are its piece over the batch axes. Two places differ from JAX's
shard_map body, which XLA wants as one static program:

* a tick runs a stage's forward or backward only when the schedule gives
  it a microbatch there, so the bubble computes nothing (JAX computes on
  every tick and masks); the sums are the same;
* each tick's two hand-offs, the forward output to position s + 1 and
  the input's gradient to s - 1, are one uneven all_to_all
  (``collectives.pipeline_hop``) whose split sizes are zero wherever the
  schedule moves nothing, which every rank knows from the tick and its
  position alone: M + P - 1 calls a forward, M + 2P - 2 a training step,
  the bubble's moving 0 bytes."""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from tpu_task_torch.ml.parallel import collectives
from tpu_task_torch.ml.parallel.sharding import mesh_axis_size
from tpu_task_torch.ml.tree import leaves, tree_map, unflatten


def _split(batch: int, n_microbatches: int) -> int:
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} not divisible by microbatches "
                         f"{n_microbatches}")
    return batch // n_microbatches


def _forward_at(t: int, stage: int, n_microbatches: int) -> Optional[int]:
    """The microbatch whose forward ``stage`` runs at tick ``t``."""
    f = t - stage
    return f if 0 <= f < n_microbatches else None


def _backward_at(t: int, stage: int, n_stages: int,
                 n_microbatches: int) -> Optional[int]:
    """The microbatch whose backward ``stage`` runs at tick ``t`` of 1F1B:
    the last stage's right after its forward, each earlier stage's one
    tick after its successor's."""
    b = t - 2 * (n_stages - 1) + stage
    return b if 0 <= b < n_microbatches else None


@torch.no_grad()
def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, mesh,
                   n_microbatches: int, axis_name: str = "pp"
                   ) -> torch.Tensor:
    """Run ``x`` through the P stages of ``axis_name``; every rank
    returns the whole output.

    ``stage_params``: this rank's stage block, a tree whose leaves have a
    leading axis of 1 (the stage-stacked tree's piece over
    ``axis_name``). ``stage_fn(params_slice, x_mb) -> y_mb`` keeps the
    microbatch's shape and type (one stage's chunk of layers). ``x``:
    (batch, ...), the whole batch on every rank, batch divisible by
    ``n_microbatches``. The last stage banks each microbatch's output and
    one all-reduce over ``axis_name`` gives it to every rank, as JAX's
    psum of the masked bank does. A forward only: the hand-offs carry no
    gradient (training goes through :func:`pipeline_train`)."""
    n_stages = mesh_axis_size(mesh, axis_name)
    batch = x.shape[0]
    mb = _split(batch, n_microbatches)
    micro = x.reshape(n_microbatches, mb, *x.shape[1:])
    params = tree_map(lambda p: p[0], stage_params)
    stage = mesh.axis_index(axis_name)
    last = stage == n_stages - 1
    outputs = torch.zeros_like(micro)
    carry = None
    for t in range(n_microbatches + n_stages - 1):
        f = _forward_at(t, stage, n_microbatches)
        out = None
        if f is not None:
            out = stage_fn(params, micro[f] if stage == 0 else carry)
            if last:
                outputs[f] = out
        carry, _ = collectives.pipeline_hop(
            mesh, axis_name, micro[0],
            forward=out if not last else None,
            receive_forward=(stage > 0 and _forward_at(
                t, stage - 1, n_microbatches) is not None))
    outputs = collectives.all_reduce_as(mesh, outputs, axis_name,
                                        "pipeline_out")
    return outputs.reshape(batch, *x.shape[1:])


def _grad_leaves(tree) -> List[torch.Tensor]:
    """``tree``'s leaves as new leaves of autograd (detached views that
    require a gradient)."""
    return [p.detach().requires_grad_(True) for p in leaves(tree)]


def pipeline_train(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, targets: torch.Tensor,
                   loss_fn: Callable[..., torch.Tensor], mesh,
                   n_microbatches: int, axis_name: str = "pp",
                   head_params: Any = None, batch_axes: Tuple[str, ...] = ()):
    """One 1F1B step of this rank's stage: JAX's ``pipeline_train``.

    Stage s runs the forward of microbatch m at tick ``m + s`` and its
    backward at tick ``m + 2(P - 1) - s``, M + 2P - 2 ticks in all. It
    keeps each forward's INPUT in a ring of 2P slots and, at the
    backward, recomputes the stage from it under autograd and
    back-propagates the cotangent: the loss's gradient on the last stage,
    the one that arrived from stage s + 1 elsewhere. The forward tick's
    graph is not kept.

    ``stage_params``: this rank's stage block (leaves ``(1, ...)``).
    ``x`` and ``targets``: this rank's rows over ``batch_axes`` (its
    piece, as ``mesh.local_batch`` cuts the mesh's batch axes), which it
    regroups into ``n_microbatches`` equal chunks, as JAX's shard-local
    split does; the ValueErrors name the global batch, as JAX's.

    Without ``head_params``: ``loss_fn(out_mb, target_mb) -> scalar`` on
    the last stage; returns ``(mean_loss, grads)``, ``grads`` shaped as
    ``stage_params`` (this rank's stage). With ``head_params`` (a head
    after the last stage, replicated on every rank):
    ``loss_fn(head_params, out_mb, target_mb) -> scalar``, run by the last
    stage alone, and the return grows to ``(mean_loss, grads,
    head_grads, dx)``: ``dx`` is the loss's gradient with respect to
    ``x`` (this rank's rows), for an embedding that runs before the
    pipeline.

    The end reductions are JAX's: the loss summed over ``axis_name``,
    divided by M and averaged over ``batch_axes``; the stage grads divided
    by M and averaged over ``batch_axes``; the head grads summed over
    ``axis_name`` (the last stage holds them), divided by M and averaged;
    ``dx`` summed over ``axis_name`` (stage 0 banks it) and divided by M
    times the batch pieces. ``loss_fn`` must be a mean over its
    microbatch's tokens."""
    # The stage backward's torch.autograd.grad, the first given
    # grad_outputs, imports this module (and sympy) once a process: seconds
    # on a cold host, which inside the schedule the ranks would pay one
    # after another along the chain. Here every rank pays it before its
    # first hand-off, at once.
    import torch.fx.experimental.symbolic_shapes  # noqa: F401

    n_stages = mesh_axis_size(mesh, axis_name)
    batch_axes = tuple(batch_axes)
    batch_shards = 1
    for ax in batch_axes:
        batch_shards *= mesh_axis_size(mesh, ax)
    batch = x.shape[0] * batch_shards
    mb = _split(batch, n_microbatches)
    if mb % batch_shards:
        raise ValueError(
            f"microbatch size {mb} (batch {batch} / {n_microbatches}) not "
            f"divisible by the {batch_shards}-way batch sharding "
            f"({batch_axes})")
    mb_local = mb // batch_shards
    micro = x.reshape(n_microbatches, mb_local, *x.shape[1:])
    targets_micro = targets.reshape(n_microbatches, mb_local,
                                    *targets.shape[1:])
    with_head = head_params is not None
    stage = mesh.axis_index(axis_name)
    first, last = stage == 0, stage == n_stages - 1
    slots = 2 * n_stages      # >= the 2P - 1 inputs a stage holds at most

    sliced = tree_map(lambda p: p[0], stage_params)
    params = _grad_leaves(sliced)
    params_tree = unflatten(sliced, iter(params))
    grads = [torch.zeros_like(p) for p in params]
    head = _grad_leaves(head_params) if with_head else []
    head_tree = unflatten(head_params, iter(head)) if with_head else None
    head_grads = [torch.zeros_like(p) for p in head]
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    dx_bank = torch.zeros_like(micro) if with_head and first else None
    ring: List[Optional[torch.Tensor]] = [None] * slots
    fwd_carry = bwd_carry = None

    for t in range(n_microbatches + 2 * (n_stages - 1)):
        out = dx = None
        f = _forward_at(t, stage, n_microbatches)
        if f is not None:
            inp = micro[f] if first else fwd_carry
            ring[f % slots] = inp
            with torch.no_grad():
                out = stage_fn(params_tree, inp)
        b = _backward_at(t, stage, n_stages, n_microbatches)
        if b is not None:
            saved = ring[b % slots].detach().requires_grad_(True)
            with torch.enable_grad():
                out_b = stage_fn(params_tree, saved)
                if last:
                    loss_b, cot = _head_cotangent(
                        loss_fn, head_tree, head, out_b, targets_micro[b],
                        head_grads)
                    loss_sum = loss_sum + loss_b
                else:
                    cot = bwd_carry
                found = torch.autograd.grad(out_b, params + [saved], cot,
                                            materialize_grads=True)
            with torch.no_grad():
                for g, d in zip(grads, found[:-1]):
                    g.add_(d)
            dx = found[-1]
            if dx_bank is not None:
                dx_bank[b] = dx.to(dx_bank.dtype)
        fwd_carry, bwd_carry = collectives.pipeline_hop(
            mesh, axis_name, micro[0],
            forward=out if not last else None,
            backward=dx if not first else None,
            receive_forward=(not first and _forward_at(
                t, stage - 1, n_microbatches) is not None),
            receive_backward=(not last and _backward_at(
                t, stage + 1, n_stages, n_microbatches) is not None))

    with torch.no_grad():
        return _reduce_ends(mesh, axis_name, batch_axes, batch_shards,
                            n_microbatches, stage_params, grads, loss_sum,
                            head_params, head_grads, dx_bank, micro)


def _head_cotangent(loss_fn, head_tree, head: List[torch.Tensor],
                    out_b: torch.Tensor, target: torch.Tensor,
                    head_grads: List[torch.Tensor]):
    """The last stage's loss on its recomputed output and the loss's
    gradient with respect to that output, in its type; the head's
    gradients are added to ``head_grads``. JAX's ``value_and_grad`` of
    ``loss_fn`` over (head, output)."""
    out_v = out_b.detach().requires_grad_(True)
    if head_tree is None:
        loss_b = loss_fn(out_v, target)
        (dloss,) = torch.autograd.grad(loss_b, [out_v])
    else:
        loss_b = loss_fn(head_tree, out_v, target)
        found = torch.autograd.grad(loss_b, head + [out_v],
                                    materialize_grads=True)
        with torch.no_grad():
            for g, d in zip(head_grads, found[:-1]):
                g.add_(d)
        dloss = found[-1]
    return loss_b.detach().to(torch.float32), dloss.to(out_b.dtype)


def _batch_mean(mesh, value: torch.Tensor, batch_axes) -> torch.Tensor:
    """JAX's pmean over each batch axis in turn."""
    for ax in batch_axes:
        value = (collectives.all_reduce(mesh, value, ax)
                 / mesh_axis_size(mesh, ax))
    return value


def _reduce_ends(mesh, axis_name, batch_axes, batch_shards, n_microbatches,
                 stage_params, grads, loss_sum, head_params, head_grads,
                 dx_bank, micro):
    """The step's end reductions, JAX's, each leaf group as one buffer a
    collective (a sum with the other stages' zeros is exact)."""
    m = n_microbatches
    # The loss and the head's gradients live on the last stage: one sum
    # over the stages replicates them.
    flat = torch.cat([loss_sum.reshape(1)]
                     + [g.reshape(-1).to(torch.float32) for g in head_grads])
    flat = collectives.all_reduce_as(mesh, flat, axis_name, "pipeline_head")
    flat = _batch_mean(mesh, flat / m, batch_axes)
    loss = flat[0]
    stage_flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    stage_flat = _batch_mean(mesh, stage_flat / m, batch_axes)
    stacked = unflatten(stage_params, iter(
        part.view_as(g).to(g.dtype)[None] for part, g in zip(
            stage_flat.split([g.numel() for g in grads]), grads)))
    if head_params is None:
        return loss, stacked
    head_out = unflatten(head_params, iter(
        part.view_as(g).to(g.dtype) for part, g in zip(
            flat[1:].split([g.numel() for g in head_grads]), head_grads)))
    # Stage 0 banked dx: the sum over the stages gives it to every rank.
    bank = dx_bank if dx_bank is not None else torch.zeros_like(micro)
    dx = collectives.all_reduce_as(mesh, bank, axis_name, "pipeline_dx")
    dx = dx / (m * batch_shards)
    return loss, stacked, head_out, dx.reshape(-1, *dx.shape[2:])


__all__ = ["pipeline_apply", "pipeline_train"]
