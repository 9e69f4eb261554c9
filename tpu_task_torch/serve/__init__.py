"""Serving replicas: engine presets, the engine builder and the replica
half of the fleet KV plane."""
