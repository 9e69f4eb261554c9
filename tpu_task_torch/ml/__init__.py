"""Models, ops, the JAX key schedule and the paged serving engine."""
