"""Request-scoped distributed tracing — this package's own copy of
``tpu_task/obs/trace.py``: :data:`TRACE_HEADER`, :class:`TraceContext`,
:class:`Span` and :class:`Tracer` with its bounded drop-oldest ring.

The header string and the span JSON are the contract between the two
packages: a router of either package mints a trace and sends its dispatch
span's context in :data:`TRACE_HEADER`; the replica's engine opens its
queue, prefill and decode spans under it; and a fleet reads the finished
spans as :meth:`Span.to_json` records off the replica's ``/obs``
endpoint or out of ``obs/spans/``. Span timestamps are wall-clock
(``time.time``), comparable across the processes one trace spans.

Layers take an optional ``obs`` handle and skip every call here when it
is ``None``. This module imports nothing of torch, storage or serving
code.
"""

from __future__ import annotations

import collections
import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

__all__ = ["TRACE_HEADER", "Span", "TraceContext", "Tracer"]

#: The one propagation header: ``<trace_id>:<parent span_id>``.
TRACE_HEADER = "X-Tpu-Task-Trace"


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass(frozen=True)
class TraceContext:
    """What crosses a process boundary: which trace, and which span the
    receiver's spans are children of."""

    trace_id: str
    span_id: str

    def to_header(self) -> str:
        return f"{self.trace_id}:{self.span_id}"

    @classmethod
    def mint(cls) -> "TraceContext":
        """A fresh trace with a virtual root span id — for components
        that receive no upstream context but must keep all their spans
        for one request in ONE trace (an engine driven directly, a
        replica client that sends no header). The root id never gets a
        span record; renderers treat its children as orphan roots."""
        return cls(trace_id=_new_id(), span_id=_new_id())

    @classmethod
    def from_header(cls, value: Optional[str]) -> Optional["TraceContext"]:
        if not value or ":" not in value:
            return None
        trace_id, _, span_id = value.partition(":")
        if not trace_id or not span_id:
            return None
        return cls(trace_id=trace_id, span_id=span_id)


@dataclass
class Span:
    """One timed operation. ``status`` is ``ok`` for the happy path;
    interruptions record what happened instead of finishing
    (``error`` / ``preempted`` / ``exported`` / ``redispatched``)."""

    trace_id: str
    span_id: str
    name: str
    start: float
    end: Optional[float] = None
    parent_id: Optional[str] = None
    status: str = "ok"
    source: str = ""
    attrs: Dict[str, object] = field(default_factory=dict)

    @property
    def ctx(self) -> TraceContext:
        """This span as a parent context for children (local or remote)."""
        return TraceContext(trace_id=self.trace_id, span_id=self.span_id)

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None else self.start) - self.start

    def to_json(self) -> dict:
        return {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "start": self.start, "end": self.end, "status": self.status,
            "source": self.source, "attrs": self.attrs,
        }

    @classmethod
    def from_json(cls, record: dict) -> "Span":
        return cls(trace_id=record["trace_id"], span_id=record["span_id"],
                   parent_id=record.get("parent_id"), name=record["name"],
                   start=record["start"], end=record.get("end"),
                   status=record.get("status", "ok"),
                   source=record.get("source", ""),
                   attrs=dict(record.get("attrs") or {}))


Parent = Union[Span, TraceContext, None]


class Tracer:
    """Mint, finish, and ring-buffer spans for one component.

    Thread-safe: HTTP handler threads, the step loop, and the router all
    append to the same ring. ``capacity`` bounds memory (drop-oldest)."""

    def __init__(self, source: str = "", capacity: int = 4096,
                 clock=time.time):
        self.source = source
        self.clock = clock
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0

    # -- span lifecycle --------------------------------------------------------
    def start(self, name: str, parent: Parent = None, **attrs) -> Span:
        """Open a span. ``parent=None`` mints a NEW trace (the router's
        root); a :class:`Span`/:class:`TraceContext` parent keeps the
        trace id and links the hierarchy."""
        if parent is None:
            trace_id, parent_id = _new_id(), None
        else:
            ctx = parent.ctx if isinstance(parent, Span) else parent
            trace_id, parent_id = ctx.trace_id, ctx.span_id
        return Span(trace_id=trace_id, span_id=_new_id(),
                    parent_id=parent_id, name=name, start=self.clock(),
                    source=self.source, attrs=dict(attrs))

    def end(self, span: Span, status: str = "ok", **attrs) -> Span:
        span.end = self.clock()
        span.status = status
        if attrs:
            span.attrs.update(attrs)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(span)
        return span

    def event(self, name: str, parent: Parent = None, status: str = "ok",
              **attrs) -> Span:
        """A zero-duration span — lifecycle transitions, faults."""
        return self.end(self.start(name, parent=parent, **attrs),
                        status=status)

    def error(self, name: str, error: BaseException, parent: Parent = None,
              **attrs) -> Span:
        """A structured error event: exception type + message as span
        attrs, ``status="error"`` — what replaces a bare
        ``traceback.print_exc()`` nobody syncs."""
        return self.event(name, parent=parent, status="error",
                          exc_type=type(error).__name__,
                          error=str(error) or repr(error), **attrs)

    @contextmanager
    def span(self, name: str, parent: Parent = None, **attrs):
        record = self.start(name, parent=parent, **attrs)
        try:
            yield record
        except BaseException as exc:
            self.end(record, status="error", exc_type=type(exc).__name__,
                     error=str(exc) or repr(exc))
            raise
        else:
            self.end(record)

    # -- ring access -----------------------------------------------------------
    def finished(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def drain(self) -> List[Span]:
        """Finished spans, cleared — the exporter's read-once path."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
            return out
