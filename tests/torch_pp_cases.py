"""The rank side of the pipeline-parallel tests: functions that each rank
of a :class:`torch_spmd_util.SpmdGroup` runs at its mesh position, whose
results the test process holds against the JAX package. A rank takes its
stage's block of every stage-stacked leaf (``[s:s + 1]``, the leading
stage axis cut over ``pp``) and its rows over the batch axes. Ranks
import this module by name, so it imports neither JAX nor the JAX
package."""

from __future__ import annotations

import numpy as np
import torch

from tpu_task_torch.ml import train as ttrain
from tpu_task_torch.ml.ops.attention import mha_reference
from tpu_task_torch.ml.models import transformer as ttf
from tpu_task_torch.ml.parallel import collectives
from tpu_task_torch.ml.parallel import mesh as tmesh
from tpu_task_torch.ml.parallel.pipeline import pipeline_apply, pipeline_train
from tpu_task_torch.ml.tree import tree_map

from torch_spmd_util import case_mesh
from torch_train_mesh_cases import blocks_numpy, config, state_from_numpy


def stage_mlp(params, x):
    """JAX's toy stage: ``tanh(x @ w + b)``."""
    return torch.tanh(x @ params["w"] + params["b"])


def mse(out, tgt):
    return torch.mean((out.to(torch.float32) - tgt) ** 2)


def head_mse(head, out, tgt):
    """A toy head after the last stage: a projection, then the MSE."""
    return mse(out @ head["w"], tgt)


def _stage_block(tree, mesh, axis="pp"):
    """This rank's ``(1, ...)`` block of each stage-stacked numpy leaf."""
    s = mesh.axis_index(axis)
    return tree_map(lambda a: torch.tensor(np.asarray(a)[s:s + 1]), tree)


def _recording_hops(mesh, record: list):
    """``collectives.pipeline_hop`` wrapped to append each call's bytes
    sent by this rank; returns the original."""
    original = collectives.pipeline_hop

    def hop(*args, **kwargs):
        before = mesh.collectives.get("pipeline_hop", [0, 0.0, 0])[2]
        out = original(*args, **kwargs)
        record.append(mesh.collectives["pipeline_hop"][2] - before)
        return out

    collectives.pipeline_hop = hop
    return original


def apply_case(sizes, params, x, n_micro):
    """:func:`pipeline_apply` of the toy stages on a ("pp",) mesh: the
    output every rank returns and its collectives."""
    mesh = case_mesh(("pp",), sizes)
    if mesh is None:
        return None
    mesh.collectives.clear()
    out = pipeline_apply(stage_mlp, _stage_block(params, mesh),
                         torch.tensor(x), mesh, n_micro)
    return {"out": out.numpy().copy(),
            "collectives": collectives.collective_stats(mesh)}


def train_case(names, sizes, params, x, targets, n_micro, head=None,
               batch_axes=(), stage="mlp", model=None):
    """:func:`pipeline_train` on this rank's stage and rows: the loss, its
    stage's gradients (and the head's and dx with a ``head``), the bytes
    each hop call sent and the collectives. ``stage="block"`` runs the
    flagship's ``_block`` (``model``'s config, the plain attention)."""
    mesh = case_mesh(names, sizes)
    if mesh is None:
        return None
    if stage == "block":
        cfg = config(model)

        def stage_fn(layer, h):
            return ttf._block(h, layer, cfg,
                              lambda q, k, v: mha_reference(q, k, v,
                                                            True))[0]
    else:
        stage_fn = stage_mlp
    rows = torch.tensor(tmesh.local_batch(np.asarray(x), mesh))
    tgt = torch.tensor(tmesh.local_batch(np.asarray(targets), mesh))
    loss_fn = mse
    head_params = None
    if head is not None:
        loss_fn = head_mse
        head_params = tree_map(torch.tensor, head)
    mesh.collectives.clear()
    hops: list = []
    original = _recording_hops(mesh, hops)
    try:
        out = pipeline_train(stage_fn, _stage_block(params, mesh), rows, tgt,
                             loss_fn, mesh, n_micro, head_params=head_params,
                             batch_axes=tuple(batch_axes))
    finally:
        collectives.pipeline_hop = original
    result = {"loss": float(out[0]),
              "grads": blocks_numpy(out[1]), "hop_bytes": hops,
              "collectives": collectives.collective_stats(mesh)}
    if head is not None:
        result.update(head_grads=blocks_numpy(out[2]),
                      dx=out[3].numpy().copy())
    return result


def pp_steps(names, sizes, model, state, tokens, n_micro, steps=3,
             directory=None, step=None):
    """``steps`` pipeline-parallel steps from the whole pipeline ``state``
    (the port's numpy ``TrainState`` in ``pp_stack_params`` layout) on the
    global ``tokens``, each rank on its rows: each step's metrics and the
    rank's blocks, and the step's collectives. With ``directory`` the rank
    then saves its blocks there at ``step`` with their layout."""
    from tpu_task_torch.ml import checkpoint

    mesh = case_mesh(names, sizes)
    if mesh is None:
        return None
    cfg = config(model)
    blocks, specs = ttrain.shard_pp_state(state_from_numpy(state), mesh)
    step_fn = ttrain.make_pp_train_step(cfg, mesh, n_micro)(blocks)
    rows = torch.tensor(tmesh.local_batch(np.asarray(tokens), mesh))
    mesh.collectives.clear()
    out = {"metrics": [], "states": []}
    for _ in range(steps):
        blocks, metrics = step_fn(blocks, rows)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["states"].append(blocks_numpy(blocks))
    out["collectives"] = collectives.collective_stats(mesh)
    if directory is not None:
        checkpoint.save_checkpoint_sharded(directory, step, blocks,
                                           specs=specs, mesh=mesh)
    return out


def pp_restore(names, sizes, template, directory):
    """This rank's blocks of a pipeline state restored from ``directory``
    into ``shard_pp_state`` of ``template`` through its layout."""
    from tpu_task_torch.ml import checkpoint

    mesh = case_mesh(names, sizes)
    if mesh is None:
        return None
    blocks, specs = ttrain.shard_pp_state(state_from_numpy(template), mesh)
    restored = checkpoint.restore_checkpoint_sharded(directory, blocks,
                                                     specs=specs, mesh=mesh)
    return blocks_numpy(restored)
