"""Serving replicas: engine presets and the engine builder."""
