"""Durable span and metric export and the Prometheus text exposition —
this package's own copy of ``tpu_task/obs/export.py``'s
:class:`SpanExporter`, :func:`read_spans`, :func:`export_metrics`,
:func:`read_metrics` and :func:`prometheus_text`.

Export rides the storage backend seam (``list``, ``read``, ``write``): a
replica writes ``obs/spans/`` and ``obs/metrics/`` into its working
directory. The keys and the JSON bodies are the JAX package's, so the JAX
package's ``read_spans``/``read_metrics`` read what a torch replica
exported, and :func:`prometheus_text` gives the same bytes as JAX's for
the same snapshot. The Chrome-trace and waterfall renderers are the JAX
command line's and are not copied.
"""

from __future__ import annotations

import itertools
import json
import re
import uuid
from typing import List, Optional

from tpu_task_torch.obs.metrics import merge_snapshots
from tpu_task_torch.obs.trace import Span

__all__ = [
    "METRICS_PREFIX",
    "SPAN_PREFIX",
    "SpanExporter",
    "export_metrics",
    "prometheus_text",
    "read_metrics",
    "read_spans",
]

SPAN_PREFIX = "obs/spans/"
METRICS_PREFIX = "obs/metrics/"


class SpanExporter:
    """Append-only span batches under ``obs/spans/`` of any backend.

    Keys are ``<source>-<run>-<seq>.json``: ``run`` is per-exporter
    random so a restarted process never overwrites its predecessor's
    batches, ``seq`` keeps one process's batches ordered."""

    def __init__(self, backend, prefix: str = SPAN_PREFIX):
        self._backend = backend
        self._prefix = prefix
        self._run = uuid.uuid4().hex[:8]
        self._seq = itertools.count()

    def export(self, spans: List[Span], source: str = "") -> Optional[str]:
        if not spans:
            return None
        key = (f"{self._prefix}{source or spans[0].source or 'spans'}"
               f"-{self._run}-{next(self._seq):06d}.json")
        self._backend.write(
            key, json.dumps([span.to_json() for span in spans]).encode())
        return key


def read_spans(backend, prefix: str = SPAN_PREFIX) -> List[Span]:
    """Every exported span under ``prefix``, start-ordered. Unreadable
    batches are skipped: a torn write must not take the reader down."""
    spans: List[Span] = []
    for key in sorted(backend.list(prefix)):
        if not key.endswith(".json"):
            continue
        try:
            spans.extend(Span.from_json(record)
                         for record in json.loads(backend.read(key)))
        except (ValueError, KeyError, OSError):
            continue
    spans.sort(key=lambda span: (span.start, span.span_id))
    return spans


def export_metrics(backend, snapshot: dict, source: str,
                   prefix: str = METRICS_PREFIX) -> str:
    """One registry snapshot per source, last write wins: snapshots are
    cumulative, so overwriting is the merge within a source."""
    key = f"{prefix}{source}.json"
    backend.write(key, json.dumps(snapshot).encode())
    return key


def read_metrics(backend, prefix: str = METRICS_PREFIX) -> dict:
    """All sources' snapshots merged (counters add, histograms
    bucket-wise)."""
    snapshots = []
    for key in sorted(backend.list(prefix)):
        if not key.endswith(".json"):
            continue
        try:
            snapshots.append(json.loads(backend.read(key)))
        except (ValueError, OSError):
            continue
    return merge_snapshots(snapshots)


def _prom_name(name: str, prefix: str) -> str:
    """Registry name → a legal Prometheus metric name
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``): dots and every other illegal
    character become underscores."""
    out = prefix + re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not re.match(r"[a-zA-Z_:]", out):
        out = "_" + out
    return out


def _prom_num(value) -> str:
    if value is None:
        return "NaN"
    value = float(value)
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return format(value, ".10g")


def prometheus_text(snapshot: dict, prefix: str = "tpu_task_") -> str:
    """One registry (or merged) snapshot in Prometheus text exposition:
    what a replica's ``GET /metrics`` serves.

    Counters and gauges map directly; histograms emit the cumulative
    ``_bucket{le="..."}`` series (one line per bucket boundary where the
    cumulative count changes, plus the mandatory ``le="+Inf"``), ``_sum``
    and ``_count``. Bucket boundaries come from the deterministic log
    grid, so every replica scrapes onto the same ``le`` label sets."""
    lines: List[str] = []
    for name, entry in sorted(snapshot.items()):
        kind = entry.get("type")
        pname = _prom_name(name, prefix)
        if kind in ("counter", "gauge"):
            lines.append(f"# TYPE {pname} {kind}")
            lines.append(f"{pname} {_prom_num(entry.get('value', 0.0))}")
        elif kind == "histogram":
            lines.append(f"# TYPE {pname} histogram")
            lo, per_decade = entry["lo"], entry["per_decade"]
            growth = 10.0 ** (1.0 / per_decade)
            counts = {int(i): c for i, c in entry.get("counts", {}).items()}
            cum = 0
            for i in range(entry["n"] - 1):   # overflow folds into +Inf
                bucket = counts.get(i, 0)
                if not bucket:
                    continue
                cum += bucket
                upper = lo if i == 0 else lo * growth ** i
                lines.append(
                    f'{pname}_bucket{{le="{_prom_num(upper)}"}} {cum}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {entry["count"]}')
            lines.append(f"{pname}_sum {_prom_num(entry.get('sum', 0.0))}")
            lines.append(f"{pname}_count {entry['count']}")
    return "\n".join(lines) + "\n" if lines else "# no metrics\n"
