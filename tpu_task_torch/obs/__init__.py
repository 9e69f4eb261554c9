"""Serving observability of the port: the goodput meter (``goodput``)."""
