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
