"""SLO classes and the SLA dispatch header — this package's own copy of
``tpu_task/obs/sla.py``'s ``SLO_CLASSES``, ``DEFAULT_CLASS``,
:func:`class_rank`, :data:`SLA_HEADER`, :func:`format_sla_header` and
:func:`parse_sla_header`. The class rank is the protection order the
engine's admission (class-then-EDF) and preemption victim
(least-protected, most slack) key on; the header carries a request's
class and remaining deadline from a router into a replica. The degrade
ladder acts on the router's side and stays in the JAX package."""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["DEFAULT_CLASS", "SLA_HEADER", "SLO_CLASSES", "class_rank",
           "format_sla_header", "parse_sla_header"]

#: Dispatch-header twin of the trace header: ``<class>;<remaining_ms>``
#: (the ms part omitted for deadline-less requests). Remaining, not
#: absolute, because router and replica share no clock.
SLA_HEADER = "X-Tpu-Task-Sla"

#: Protection order, most protected first.
SLO_CLASSES = ("premium", "standard", "best_effort")

DEFAULT_CLASS = "standard"

_RANK = {"premium": 2, "standard": 1, "best_effort": 0}


def class_rank(slo_class: Optional[str]) -> int:
    """Protection rank: premium 2, standard 1, best_effort 0. Unknown
    class names rank as standard — a typo must not silently make a
    request first against the wall."""
    return _RANK.get(slo_class or DEFAULT_CLASS, _RANK[DEFAULT_CLASS])


def format_sla_header(slo_class: str,
                      remaining_ms: Optional[float] = None) -> str:
    if remaining_ms is None:
        return str(slo_class)
    return f"{slo_class};{remaining_ms:.1f}"


def parse_sla_header(value: Optional[str]) \
        -> Tuple[str, Optional[float]]:
    """``(slo_class, remaining_ms)`` — permissive: absent or garbled
    headers degrade to (standard, no deadline), never to a 4xx (the SLA
    plane is advisory metadata on top of a correct request)."""
    if not value:
        return DEFAULT_CLASS, None
    name, _, ms = value.partition(";")
    name = name.strip() or DEFAULT_CLASS
    if not ms.strip():
        return name, None
    try:
        return name, max(0.0, float(ms))
    except ValueError:
        return name, None
