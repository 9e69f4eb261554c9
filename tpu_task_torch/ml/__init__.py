"""Models, ops, the JAX key schedule, the paged serving engine, training,
checkpoints and the input pipeline. The names below are those
``tpu_task/ml/__init__.py`` exports, each from the port's own module."""

from tpu_task_torch.ml.checkpoint import (
    AsyncCheckpointer,
    AsyncCheckpointError,
    latest_step,
    restore_checkpoint,
    restore_checkpoint_sharded,
    save_checkpoint,
    save_checkpoint_sharded,
)
from tpu_task_torch.ml.parallel.mesh import (
    balanced_mesh_shape,
    distributed_init_from_env,
    make_mesh,
)
from tpu_task_torch.ml import profiling

__all__ = [
    "AsyncCheckpointer",
    "AsyncCheckpointError",
    "balanced_mesh_shape",
    "profiling",
    "distributed_init_from_env",
    "latest_step",
    "make_mesh",
    "restore_checkpoint",
    "restore_checkpoint_sharded",
    "save_checkpoint",
    "save_checkpoint_sharded",
]
