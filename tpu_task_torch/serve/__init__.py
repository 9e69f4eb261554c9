"""Serving replicas: engine presets and ``build_engine``, the HTTP
:class:`ReplicaServer` the JAX package's router and fleet drive, and the
replica half of the fleet KV plane."""

__all__ = ["MODEL_PRESETS", "SERVING_PRESETS", "ReplicaServer",
           "build_engine"]


def __getattr__(name):
    # Imported on first use, so that ``python -m
    # tpu_task_torch.serve.replica`` does not load its module twice.
    if name in __all__:
        from tpu_task_torch.serve import replica

        return getattr(replica, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
