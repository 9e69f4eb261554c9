"""Device meshes and multi-process bring-up — the counterpart of
``tpu_task/ml/parallel/mesh.py``.

A JAX mesh is one controller's view of many devices. Here a mesh is one
process's view of a gang of processes, one a mesh position
(:mod:`~tpu_task_torch.ml.parallel.gang` starts them): :class:`Mesh`
keeps JAX's ``axis_names`` and a ``shape`` mapping (``dict(mesh.shape)
[axis]`` reads as in the JAX package), this process's ``rank`` and its
``device``, and, in a gang, the ``torch.distributed`` process group of
each axis through a :class:`torch.distributed.device_mesh.DeviceMesh`.
Ranks lay out row-major over the axes, as ``np.asarray(devices).reshape(
axis_sizes)`` lays out JAX's devices: rank ``r`` of a ("tp", "ep") mesh is
at tp index ``r // ep`` and ep index ``r % ep``.

The orchestrator's ``TPU_TASK_COORDINATOR`` / ``TPU_TASK_NUM_WORKERS`` /
``TPU_TASK_WORKER_ID`` variables (:func:`worker_env`) become
``torch.distributed.init_process_group`` in
:func:`distributed_init_from_env`.

The JAX module's ``value_vma``, ``shard_map``, ``axis_size`` and ``pvary``
bridge versions of ``jax`` and have no counterpart here: the port's
collectives are explicit calls on each axis's process group."""

from __future__ import annotations

import math
import os
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def balanced_mesh_shape(n_devices: int, n_axes: int = 3) -> Tuple[int, ...]:
    """Factor ``n_devices`` into ``n_axes`` near-equal factors: repeatedly
    divide by the smallest prime factor, assigning it to the currently
    smallest axis. For 8 devices and 3 axes: (2, 2, 2)."""
    if n_devices < 1:
        raise ValueError("n_devices must be >= 1")
    axes = [1] * n_axes
    remaining = n_devices
    while remaining > 1:
        factor = next(
            (p for p in range(2, int(math.isqrt(remaining)) + 1)
             if remaining % p == 0),
            remaining,
        )
        axes[axes.index(min(axes))] *= factor
        remaining //= factor
    return tuple(sorted(axes, reverse=True))


class Mesh:
    """A mesh of ``prod(axis_sizes)`` positions named by ``axis_names``,
    seen from position ``rank``, which runs on ``device``. Without a
    ``device_mesh`` it is a layout only (partition rules read its names,
    shard cuts its coordinates); a gang's mesh has one, and the
    collectives of :mod:`~tpu_task_torch.ml.parallel.gang` run on its
    per-axis groups. ``gang`` is set on rank 0 of a gang: the handle on
    the other ranks. ``collectives`` counts this process's collectives by
    kind, as ``[calls, seconds]``."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 *, rank: int = 0, device=None, device_mesh=None):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"axis sizes {tuple(axis_sizes)} do not match "
                             f"axis names {tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = OrderedDict(
            (name, int(size)) for name, size in zip(axis_names, axis_sizes))
        self.size = int(math.prod(self.shape.values()))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = int(rank)
        self.device = torch.device("cpu" if device is None else device)
        self.device_mesh = device_mesh
        self.gang = None
        self.collectives: Dict[str, list] = {}

    @property
    def devices(self) -> np.ndarray:
        """The ranks in mesh layout: JAX's ``mesh.devices``."""
        return np.arange(self.size).reshape(tuple(self.shape.values()))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Each axis's index of ``rank`` (default: this process's)."""
        index = np.unravel_index(self.rank if rank is None else rank,
                                 tuple(self.shape.values()))
        return {name: int(i) for name, i in zip(self.axis_names, index)}

    def axis_index(self, name: str) -> int:
        """This process's index along ``name`` (0 for an absent axis):
        ``lax.axis_index`` in JAX's shard_map bodies."""
        return self.coords().get(name, 0)

    def group(self, name: str):
        """The process group of this rank's line along axis ``name``."""
        if self.device_mesh is None:
            raise ValueError(f"mesh axis {name!r} has no process group: "
                             "this mesh belongs to no gang")
        return self.device_mesh.get_group(name)

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, rank={self.rank}, "
                f"device={self.device})")


def make_mesh(n_devices: Optional[int] = None, *,
              axis_names: Sequence[str] = ("dp", "fsdp", "tp"),
              axis_sizes: Optional[Sequence[int]] = None,
              devices=None, device=None) -> Mesh:
    """A :class:`Mesh` over ``n_devices`` positions (default: every rank
    of the initialized ``torch.distributed`` group, or 1 without one).
    ``axis_sizes`` defaults to a balanced factorization of the count.
    With a group of that size, the mesh carries its per-axis groups and
    this process's rank; ``devices`` (a sequence of positions) only sets
    the count, as it sets JAX's device list."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    if devices is not None:
        n = len(devices)
    elif n_devices is not None:
        if n_devices > world and grouped:
            raise ValueError(f"asked for {n_devices} devices, have {world}")
        n = n_devices
    else:
        n = world
    if axis_sizes is None:
        axis_sizes = balanced_mesh_shape(n, len(axis_names))
    if math.prod(axis_sizes) != n:
        raise ValueError(f"axis sizes {tuple(axis_sizes)} != {n} devices")
    if not grouped or n == 1 or n != world:
        return Mesh(axis_sizes, axis_names, device=device)
    from torch.distributed.device_mesh import DeviceMesh

    device_mesh = DeviceMesh(
        "cpu", torch.arange(n).reshape(tuple(axis_sizes)),
        mesh_dim_names=tuple(axis_names))
    return Mesh(axis_sizes, axis_names, rank=dist.get_rank(),
                device=device, device_mesh=device_mesh)


def worker_env(worker_id: int, num_workers: int, coordinator: str) -> dict:
    """The env-var contract the orchestrator writes on each worker."""
    return {
        "TPU_TASK_WORKER_ID": str(worker_id),
        "TPU_TASK_NUM_WORKERS": str(num_workers),
        "TPU_TASK_COORDINATOR": coordinator,
    }


def distributed_init_from_env(environ=None, backend: str = "gloo") -> bool:
    """``torch.distributed.init_process_group`` from the orchestrator's
    variables, the coordinator as ``tcp://<coordinator>``. Returns True
    when a group of several processes was set up, False for one worker or
    missing variables. Safe to call at the top of any script."""
    env = os.environ if environ is None else environ
    num_workers = int(env.get("TPU_TASK_NUM_WORKERS", "1"))
    if num_workers <= 1:
        return False
    coordinator = env.get("TPU_TASK_COORDINATOR")
    worker_id = env.get("TPU_TASK_WORKER_ID")
    if not coordinator or worker_id is None:
        return False
    import torch.distributed as dist

    init = (coordinator if "://" in coordinator
            else f"tcp://{coordinator}")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_workers, rank=int(worker_id))
    return True


def batch_shard(mesh=None) -> Tuple[int, int]:
    """(this rank's piece, the number of pieces) of the batch dim: the
    piece at its coordinates over the mesh's batch axes
    (``sharding.mesh_batch_axes``: ``dp``, ``fsdp``, ``ep``), row-major,
    as ``logical_to_mesh_axes(("batch", "seq"))`` shards JAX's batch.
    Ranks that differ only in another axis (``tp``) read the same rows.
    Without a mesh: this process's index and count."""
    from tpu_task_torch.device import process_count, process_index
    from tpu_task_torch.ml.parallel.sharding import mesh_batch_axes

    if mesh is None:
        return process_index(), process_count()
    pieces, index = 1, 0
    for axis in mesh_batch_axes(mesh):
        n = int(mesh.shape[axis])
        pieces, index = pieces * n, index * n + mesh.axis_index(axis)
    return index, pieces


def local_batch_slice(global_batch: int, mesh=None) -> int:
    """This rank's rows of a global batch: the batch divided by the
    number of its pieces over the mesh's batch axes (:func:`batch_shard`).
    JAX divides by its process count, a host holding several devices; a
    process of the port is one mesh position, and the positions along
    ``tp`` share their rows."""
    index, pieces = batch_shard(mesh)
    if global_batch % pieces:
        raise ValueError(f"global batch {global_batch} does not divide "
                         f"into {pieces} batch pieces")
    return global_batch // pieces


def sequence_piece(length: int, mesh, axis: str = "sp"
                   ) -> Tuple[int, int, int]:
    """(this rank's index along ``axis``, the axis size, the first
    position of its chunk) of a ``length``-token sequence cut into
    contiguous chunks over ``axis``, as ``activation_spec``'s sequence
    entry shards JAX's activations: rank ``i`` of ``n`` holds positions
    ``[i * length / n, (i + 1) * length / n)``. Raises JAX's ValueError
    when ``length`` does not divide."""
    n = int(dict(mesh.shape).get(axis, 1))
    if length % n:
        raise ValueError(f"sequence ({length}) not divisible by {axis} "
                         f"({n})")
    index = mesh.axis_index(axis)
    return index, n, index * (length // n)


def local_batch(batch, mesh=None):
    """This rank's rows of ``batch`` (an array or tensor whose leading dim
    is the global batch): a contiguous block, :func:`batch_shard`'s
    piece."""
    index, pieces = batch_shard(mesh)
    rows = local_batch_slice(len(batch), mesh)
    return batch[index * rows:(index + 1) * rows]
