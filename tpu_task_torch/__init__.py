"""PyTorch/CUDA port of tpu_task's compute half, for one NVIDIA H100.

Each module mirrors its counterpart under ``tpu_task/`` (the JAX package,
which stays the reference): ``tpu_task_torch/ml/serving/engine.py`` ports
``tpu_task/ml/serving/engine.py`` and so on. The package imports torch,
numpy and the standard library only. Its entry points run on a CUDA device
unless the caller passes ``device="cpu"``."""
