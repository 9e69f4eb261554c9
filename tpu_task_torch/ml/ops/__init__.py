"""Attention: the plain cores, the paged-decode CUDA kernel and its build."""
