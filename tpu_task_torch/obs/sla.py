"""SLO classes of the serving engine — this package's own copy of
``tpu_task/obs/sla.py``'s ``SLO_CLASSES``, ``DEFAULT_CLASS`` and
:func:`class_rank`, the protection order the engine's admission
(class-then-EDF) and preemption victim (least-protected, most slack)
key on. The SLA header parsers and the degrade ladder come with the
HTTP replica (ROADMAP A11b)."""

from __future__ import annotations

from typing import Optional

__all__ = ["DEFAULT_CLASS", "SLO_CLASSES", "class_rank"]

#: Protection order, most protected first.
SLO_CLASSES = ("premium", "standard", "best_effort")

DEFAULT_CLASS = "standard"

_RANK = {"premium": 2, "standard": 1, "best_effort": 0}


def class_rank(slo_class: Optional[str]) -> int:
    """Protection rank: premium 2, standard 1, best_effort 0. Unknown
    class names rank as standard — a typo must not silently make a
    request first against the wall."""
    return _RANK.get(slo_class or DEFAULT_CLASS, _RANK[DEFAULT_CLASS])
