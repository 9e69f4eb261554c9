"""Serving observability of the port: distributed tracing (``trace``),
the metrics registry (``metrics``), their export and Prometheus text
(``export``), the SLO classes and SLA header (``sla``) and the goodput
meter (``goodput``) — each this package's own copy of its
``tpu_task/obs`` counterpart, with the same header strings, span JSON,
snapshot layout and export keys, so a torch replica joins a fleet of
JAX replicas.

:class:`Obs` is the handle a replica threads through its front end and
its engine: one tracer and one registry. ``obs=None`` is the
zero-overhead path: every recording site guards on it."""

from dataclasses import dataclass

from tpu_task_torch.obs.export import (
    METRICS_PREFIX,
    SPAN_PREFIX,
    SpanExporter,
    export_metrics,
    prometheus_text,
    read_metrics,
    read_spans,
)
from tpu_task_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    merge_snapshots,
)
from tpu_task_torch.obs.sla import (
    DEFAULT_CLASS,
    SLA_HEADER,
    SLO_CLASSES,
    class_rank,
    format_sla_header,
    parse_sla_header,
)
from tpu_task_torch.obs.trace import TRACE_HEADER, Span, TraceContext, Tracer

__all__ = [
    "DEFAULT_CLASS",
    "METRICS_PREFIX",
    "SLA_HEADER",
    "SLO_CLASSES",
    "SPAN_PREFIX",
    "TRACE_HEADER",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Obs",
    "Span",
    "SpanExporter",
    "TraceContext",
    "Tracer",
    "class_rank",
    "export_metrics",
    "format_sla_header",
    "merge_snapshots",
    "parse_sla_header",
    "prometheus_text",
    "read_metrics",
    "read_spans",
]


@dataclass
class Obs:
    """One tracer (its spans) and one registry (its numbers)."""

    tracer: Tracer
    metrics: MetricsRegistry

    @classmethod
    def create(cls, source: str = "", capacity: int = 4096) -> "Obs":
        obs = cls(tracer=Tracer(source=source, capacity=capacity),
                  metrics=MetricsRegistry())
        # The tracer's drop-oldest ring is silent on its own: surface its
        # overflow on the export path.
        obs.metrics.counter_fn(
            "obs.spans_dropped",
            lambda tracer=obs.tracer: float(tracer.dropped))
        return obs
