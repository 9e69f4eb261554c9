"""Serving observability of the port: the goodput meter (``goodput``) and
the SLO classes (``sla``)."""
