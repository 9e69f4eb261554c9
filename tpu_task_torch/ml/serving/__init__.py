"""Continuous batching over a paged KV cache: ``cache`` (pools, block
allocator, prefix cache), ``model`` (the fused decode step and samplers)
and ``engine`` (the scheduler). Import from the submodules."""
