"""Where the port's entry points run: the card, unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch device, defaulting to CUDA. Raises
    RuntimeError when CUDA is wanted and absent: the port never carries on
    quietly on the CPU unless the caller passed ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_task_torch runs on a CUDA device by default and CUDA is not "
            "available here; pass device='cpu' to run on the CPU")
    return device


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group, or 0 when no
    group is initialized: the counterpart of ``jax.process_index()``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    """The group's world size, or 1 when no group is initialized: the
    counterpart of ``jax.process_count()``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1
