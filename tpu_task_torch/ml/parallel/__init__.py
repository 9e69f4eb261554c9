"""Parallelism: device meshes, partition rules, the gang of ranks that
serves one engine over a mesh, and sequence-parallel attention — the names
``tpu_task/ml/parallel/__init__.py`` exports that have a counterpart here
(``PartitionPlan``, ``compile_step``, ``named_sharding`` and
``pspecs_to_shardings`` are XLA's compile seam; the gang's program
broadcast takes its place), plus the sequence cut ``sequence_piece``, the
context-parallel attention modules :mod:`.ring_attention` and
:mod:`.ulysses` (as modules: ``ring_attention`` is also a function of the
first) and the pipeline schedules' module :mod:`.pipeline`
(``pipeline_apply``, ``pipeline_train``), which the JAX package imports by
its path."""

from tpu_task_torch.ml.parallel.mesh import (
    Mesh,
    balanced_mesh_shape,
    distributed_init_from_env,
    make_mesh,
    sequence_piece,
)
from tpu_task_torch.ml.parallel.sharding import (
    PartitionSpec,
    device_put_tree,
    logical_to_mesh_axes,
    match_partition_rules,
    shard_pytree,
)
from tpu_task_torch.ml.parallel import pipeline, ring_attention, ulysses

__all__ = [
    "Mesh",
    "PartitionSpec",
    "balanced_mesh_shape",
    "device_put_tree",
    "distributed_init_from_env",
    "logical_to_mesh_axes",
    "make_mesh",
    "match_partition_rules",
    "pipeline",
    "ring_attention",
    "sequence_piece",
    "shard_pytree",
    "ulysses",
]
