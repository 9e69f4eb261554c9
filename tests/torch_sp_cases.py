"""The rank side of the sequence-parallel tests: functions that each rank
of a :class:`torch_spmd_util.SpmdGroup` runs on its mesh position, whose
results the test process holds against the JAX package. Each rank takes
its contiguous chunk of the sequence (``mesh.sequence_piece``) and its
rows of the batch, as JAX's ``activation_spec`` lays them out. Ranks
import this module by name, so it imports neither JAX nor the JAX
package."""

from __future__ import annotations

import numpy as np
import torch

from tpu_task_torch.ml import train as ttrain
from tpu_task_torch.ml.parallel import collectives
from tpu_task_torch.ml.parallel import mesh as tmesh
from tpu_task_torch.ml.parallel.ring_attention import (
    ring_attention,
    zigzag_ring_attention,
)
from tpu_task_torch.ml.parallel.ulysses import ulysses_attention

from torch_spmd_util import case_mesh
from torch_train_mesh_cases import blocks_numpy, config, state_from_numpy

ATTENTION = {"ring": ring_attention, "zigzag": zigzag_ring_attention,
             "ulysses": ulysses_attention}


def _chunk(x: np.ndarray, mesh) -> torch.Tensor:
    """This rank's contiguous chunk of ``x``'s dim 1 over ``sp``."""
    _, n, start = tmesh.sequence_piece(x.shape[1], mesh)
    return torch.tensor(x[:, start:start + x.shape[1] // n])


def attention(names, sizes, kind, q, k, v, causal=True, grads=False):
    """``kind`` attention on this rank's chunks of q, k, v (b, s, heads,
    d): its output chunk and, with ``grads``, the gradients of the global
    ``(o ** 2).sum()`` with respect to its chunks, each with the
    collectives the rank ran by kind."""
    mesh = case_mesh(names, sizes)
    if mesh is None:
        return None
    q, k, v = (_chunk(x, mesh).requires_grad_(grads) for x in (q, k, v))
    kwargs = {} if kind == "zigzag" else {"causal": causal}
    mesh.collectives.clear()
    o = ATTENTION[kind](q, k, v, mesh, **kwargs)
    out = {"o": o.detach().numpy().copy()}
    if grads:
        (o ** 2).sum().backward()
        out.update(dq=q.grad.numpy().copy(), dk=k.grad.numpy().copy(),
                   dv=v.grad.numpy().copy())
    out["collectives"] = collectives.collective_stats(mesh)
    return out


def sp_steps(names, sizes, model, state, tokens, mode="zigzag", steps=2,
             directory=None, step=None):
    """``steps`` sequence-parallel steps from ``state`` on the global
    ``tokens`` (each rank takes its rows at full length and cuts its own
    window): each step's metrics and the rank's blocks, and the step's
    collectives by kind. With ``directory`` the rank then saves its blocks
    there at ``step`` through ``save_checkpoint_sharded`` with the
    layout."""
    from tpu_task_torch.ml import checkpoint

    mesh = case_mesh(names, sizes)
    if mesh is None:
        return None
    cfg = config(model)
    blocks, specs = ttrain.shard_state(state_from_numpy(state), cfg, mesh)
    step_fn = ttrain.make_sp_train_step(cfg, mesh,
                                        context_parallel=mode)(blocks)
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

