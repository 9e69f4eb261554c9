"""Parallelism: device meshes, partition rules and the gang of ranks that
serves one engine over a mesh — the names ``tpu_task/ml/parallel/
__init__.py`` exports that have a counterpart here (``PartitionPlan``,
``compile_step``, ``named_sharding`` and ``pspecs_to_shardings`` are XLA's
compile seam; the gang's program broadcast takes its place)."""

from tpu_task_torch.ml.parallel.mesh import (
    Mesh,
    balanced_mesh_shape,
    distributed_init_from_env,
    make_mesh,
)
from tpu_task_torch.ml.parallel.sharding import (
    PartitionSpec,
    device_put_tree,
    logical_to_mesh_axes,
    match_partition_rules,
    shard_pytree,
)

__all__ = [
    "Mesh",
    "PartitionSpec",
    "balanced_mesh_shape",
    "device_put_tree",
    "distributed_init_from_env",
    "logical_to_mesh_axes",
    "make_mesh",
    "match_partition_rules",
    "shard_pytree",
]
