"""The rank side of the sharded-training tests: functions that each rank
of a :class:`torch_spmd_util.SpmdGroup` runs on its own mesh position
and whose results the test process holds against the JAX package. Ranks
import this module by name, so it imports neither JAX nor the JAX
package; states cross as the port's numpy ``TrainState``
(``train.state_to_numpy``)."""

from __future__ import annotations

import numpy as np
import torch

from tpu_task_torch.ml import train as ttrain
from tpu_task_torch.ml.models import transformer as ttf
from tpu_task_torch.ml.parallel import collectives
from tpu_task_torch.ml.parallel import mesh as tmesh
from tpu_task_torch.ml.tree import tree_map

from torch_spmd_util import case_mesh


def config(model: dict) -> ttf.TransformerConfig:
    return ttf.TransformerConfig(dtype=torch.float32, **model)


def state_from_numpy(tree) -> ttrain.TrainState:
    """The port's numpy ``TrainState`` as tensors on the CPU, the step and
    count as ints."""
    def leaf(x):
        return torch.tensor(np.asarray(x)) if np.ndim(x) else int(x)

    return tree_map(leaf, tree)


def blocks_numpy(state: ttrain.TrainState):
    """A rank's state as numpy (the ints stay ints)."""
    return tree_map(lambda t: t.detach().numpy().copy()
                    if torch.is_tensor(t) else t, state)


def batch_rows(names, sizes):
    """(this rank's coordinates, its batch piece and count, its rows of a
    64-row batch)."""
    mesh = case_mesh(names, sizes)
    if mesh is None:
        return None
    index, pieces = tmesh.batch_shard(mesh)
    rows = tmesh.local_batch(np.arange(64), mesh)
    return {"coords": mesh.coords(), "piece": index, "pieces": pieces,
            "slice": tmesh.local_batch_slice(64, mesh),
            "rows": rows.tolist()}


def shard_blocks(names, sizes, model, state):
    """This rank's blocks of ``state`` after ``shard_state``."""
    mesh = case_mesh(names, sizes)
    if mesh is None:
        return None
    blocks, _ = ttrain.shard_state(state_from_numpy(state), config(model),
                                   mesh)
    return blocks_numpy(blocks)


def train_steps(names, sizes, model, state, tokens, steps: int = 3,
                accum: int = 1, moe_axis=None):
    """``steps`` sharded steps from ``state`` on the global ``tokens``
    (each rank takes its rows): the metrics of each step, the rank's
    blocks after each step and its collectives by kind. ``moe_axis``
    takes ``make_moe_train_step`` over that axis."""
    mesh = case_mesh(names, sizes)
    if mesh is None:
        return None
    cfg = config(model)
    blocks, _ = ttrain.shard_state(state_from_numpy(state), cfg, mesh)
    if moe_axis is None:
        build = ttrain.make_train_step(cfg, mesh=mesh, accum_steps=accum)
    else:
        build = ttrain.make_moe_train_step(cfg, mesh, axis_name=moe_axis,
                                           accum_steps=accum)
    step = build(blocks)
    rows = torch.tensor(tmesh.local_batch(np.asarray(tokens), mesh))
    mesh.collectives.clear()
    out = {"metrics": [], "states": []}
    for _ in range(steps):
        blocks, metrics = step(blocks, rows)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["states"].append(blocks_numpy(blocks))
    out["collectives"] = collectives.collective_stats(mesh)
    return out


def moe_steps(names, sizes, model, state, tokens, axis="ep", steps=3,
              accum=1):
    """:func:`train_steps` through ``make_moe_train_step``, with the
    number of (token, expert) assignments its MoE layers dropped past
    capacity in the first step's first microbatch, summed over the ranks
    of the batch."""
    from tpu_task_torch.ml.models import moe

    dropped = []
    original = moe.apply_sharded

    def counting(params, cfg, x, mesh, **kw):
        if len(dropped) < len(_moe_layers(model)):
            dropped.append(_local_drops(params, cfg, x, mesh))
        return original(params, cfg, x, mesh, **kw)

    moe.apply_sharded = counting
    try:
        out = train_steps(names, sizes, model, state, tokens, steps=steps,
                          accum=accum, moe_axis=axis)
    finally:
        moe.apply_sharded = original
    if out is not None:
        out["dropped"] = int(sum(dropped))
    return out


def _moe_layers(model) -> list:
    cfg = config(model)
    return [i for i in range(cfg.n_layers) if cfg.is_moe_layer(i)]


def _local_drops(params, cfg, x, mesh) -> int:
    """Assignments past capacity among this rank's tokens (each routed
    slot-major, so an expert keeps its first ``capacity`` arrivals), all-
    reduced over the mesh so every rank reports the total of its tp
    line's batch."""
    from tpu_task_torch.ml.models import moe

    with torch.no_grad():
        tokens = x.reshape(-1, x.shape[-1])
        index, _, _ = moe._route(tokens, params["router"], cfg)
        cap = max(1, int(cfg.capacity_factor * tokens.shape[0] * cfg.top_k
                         / cfg.n_experts))
        counts = torch.bincount(index.reshape(-1), minlength=cfg.n_experts)
        local = (counts - cap).clamp(min=0).sum().to(torch.float32)
        for axis in ("dp", "fsdp", "ep"):
            local = collectives.all_reduce(mesh, local, axis)
    return int(local.item())


def save_blocks(names, sizes, model, state, directory, step, steps=0,
                tokens=None, mode="sync", keep=None):
    """``shard_state`` of ``state``, ``steps`` train steps on ``tokens``,
    then this rank's blocks saved at ``step`` through
    ``save_checkpoint_sharded`` (``mode="sync"``) or an
    ``AsyncCheckpointer`` (``"async"``) with their layout. Returns the
    saved blocks."""
    from tpu_task_torch.ml import checkpoint

    mesh = case_mesh(names, sizes)
    if mesh is None:
        return None
    cfg = config(model)
    blocks, specs = ttrain.shard_state(state_from_numpy(state), cfg, mesh)
    if steps:
        step_fn = ttrain.make_train_step(cfg, mesh=mesh)(blocks)
        rows = torch.tensor(tmesh.local_batch(np.asarray(tokens), mesh))
        for _ in range(steps):
            blocks, _ = step_fn(blocks, rows)
    if mode == "sync":
        checkpoint.save_checkpoint_sharded(directory, step, blocks,
                                           keep=keep, specs=specs, mesh=mesh)
    else:
        with checkpoint.AsyncCheckpointer(directory, keep=keep) as saver:
            saver.save(step, blocks, specs=specs, mesh=mesh)
    return blocks_numpy(blocks)


def restore_blocks(names, sizes, model, template, directory, step=None):
    """This rank's blocks restored from ``directory`` into ``shard_state``
    of ``template``, through its layout."""
    from tpu_task_torch.ml import checkpoint

    mesh = case_mesh(names, sizes)
    if mesh is None:
        return None
    blocks, specs = ttrain.shard_state(state_from_numpy(template),
                                       config(model), mesh)
    restored = checkpoint.restore_checkpoint_sharded(
        directory, blocks, step, specs=specs, mesh=mesh)
    return blocks_numpy(restored)
