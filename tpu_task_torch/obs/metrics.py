"""Metrics registry: counters, gauges and mergeable histograms — this
package's own copy of ``tpu_task/obs/metrics.py``.

One :class:`MetricsRegistry` per replica (its front end and its engine
share it) is the export path of every number the replica publishes: what
``/metrics`` serves as Prometheus text, what ``/obs`` and
``stats()["obs"]`` carry, and what a fleet merges. Histograms count into
deterministic log-spaced buckets (``lo · growth^i``), the same grid as the
JAX package's for the same ``(lo, hi, per_decade)``, so a torch replica's
snapshot merges bucket for bucket with a JAX replica's. Quantiles
log-interpolate inside the winning bucket and clamp to the observed
[min, max].

Plain Python on the host: record at step boundaries, never inside a CUDA
graph.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "merge_snapshots",
]


class Counter:
    """Monotonic counter. Thread-safe: registries are shared between
    HTTP handler threads and step loops, and ``+=`` is not atomic."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value (a plain store is atomic
    under the GIL — no lock needed)."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Streaming histogram over deterministic log-spaced buckets.

    Bucket ``i`` (1 ≤ i ≤ n) covers ``(lo·growth^(i-1), lo·growth^i]``;
    bucket 0 is the underflow catch-all (x ≤ lo) and bucket n+1 the
    overflow. Defaults cover 1 µs .. 10 ks at 8 buckets/decade (~33%
    relative resolution) — wide enough for every latency this repo
    measures, fine enough that "within one bucket" is a usable error bar.
    """

    kind = "histogram"

    def __init__(self, name: str = "", lo: float = 1e-6, hi: float = 1e4,
                 per_decade: int = 8):
        if lo <= 0 or hi <= lo or per_decade < 1:
            raise ValueError(
                f"bad histogram grid lo={lo} hi={hi} per_decade={per_decade}")
        self.name = name
        self.lo = float(lo)
        self.per_decade = int(per_decade)
        self.growth = 10.0 ** (1.0 / per_decade)
        self._inv_log_growth = 1.0 / math.log(self.growth)
        n = int(math.ceil(math.log10(hi / lo) * per_decade))
        self.counts = [0] * (n + 2)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        # observe/merge/snapshot run from handler threads AND step loops
        # on the same shared registry; the multi-field update must be
        # atomic or a mid-observe snapshot serializes count inconsistent
        # with the buckets (breaking quantile/merge math downstream).
        # RLock: snapshot() calls quantile() under the same lock.
        self._lock = threading.RLock()

    # -- recording -------------------------------------------------------------
    def _index(self, x: float) -> int:
        if x <= self.lo:
            return 0
        i = 1 + int(math.floor(math.log(x / self.lo) * self._inv_log_growth
                               # one-ulp guard: exact bucket boundaries must
                               # land in the bucket they close, not the next
                               - 1e-9))
        return min(i, len(self.counts) - 1)

    def observe(self, x: float) -> None:
        x = float(x)
        index = self._index(x)
        with self._lock:
            self.counts[index] += 1
            self.count += 1
            self.sum += x
            self.min = x if self.min is None else min(self.min, x)
            self.max = x if self.max is None else max(self.max, x)

    # -- reading ---------------------------------------------------------------
    def bucket_bounds(self, i: int) -> tuple:
        if i == 0:
            return (0.0, self.lo)
        return (self.lo * self.growth ** (i - 1), self.lo * self.growth ** i)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """q ∈ [0, 1]; log-interpolated inside the winning bucket and
        clamped to the observed [min, max] — agrees with an exact
        percentile of the raw samples to within one bucket."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = max(1.0, q * self.count)
            cum = 0
            for i, c in enumerate(self.counts):
                cum += c
                if c and cum >= target:
                    lo, hi = self.bucket_bounds(i)
                    frac = (target - (cum - c)) / c
                    value = hi if lo <= 0 else lo * (hi / lo) ** frac
                    return max(self.min, min(self.max, value))
            return self.max  # pragma: no cover (count > 0 lands above)

    # -- merge / serialization -------------------------------------------------
    def merge(self, other: "Histogram") -> "Histogram":
        """Bucket-wise add (the cross-replica aggregation path). Grids
        must match — they do by construction when both sides used the
        same knobs."""
        if (self.lo, self.per_decade, len(self.counts)) != \
                (other.lo, other.per_decade, len(other.counts)):
            raise ValueError(
                f"histogram grids differ: {self.name!r} vs {other.name!r}")
        with self._lock:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
            self.count += other.count
            self.sum += other.sum
            for bound in ("min", "max"):
                theirs = getattr(other, bound)
                ours = getattr(self, bound)
                if theirs is not None:
                    pick = theirs if ours is None else \
                        (min if bound == "min" else max)(ours, theirs)
                    setattr(self, bound, pick)
        return self

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "type": "histogram",
                "lo": self.lo,
                "per_decade": self.per_decade,
                "n": len(self.counts),
                # sparse: latency histograms touch a handful of buckets
                "counts": {str(i): c
                           for i, c in enumerate(self.counts) if c},
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
                "p50": self.quantile(0.50),
                "p99": self.quantile(0.99),
            }

    @classmethod
    def from_snapshot(cls, snap: dict, name: str = "") -> "Histogram":
        hist = cls(name, lo=snap["lo"],
                   hi=snap["lo"] * 10.0 ** ((snap["n"] - 2)
                                            / snap["per_decade"]),
                   per_decade=snap["per_decade"])
        # hi reconstruction can be one bucket short under float log round-
        # trip; size the array from the snapshot, which is authoritative.
        hist.counts = [0] * snap["n"]
        for i, c in snap["counts"].items():
            hist.counts[int(i)] = c
        hist.count = snap["count"]
        hist.sum = snap["sum"]
        hist.min = snap["min"]
        hist.max = snap["max"]
        return hist


class MetricsRegistry:
    """Create-or-get typed metrics under unique names, plus lazy gauges
    (``gauge_fn``) that snapshot existing plain-attribute counters without
    rewriting their mutation sites."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        #: name -> (kind, fn): lazily-evaluated metrics over existing
        #: plain attributes. Kind matters at MERGE time: "counter" sums
        #: across sources (monotonic per-process totals), "gauge" keeps
        #: the last writer (instantaneous values).
        self._lazy_fns: Dict[str, tuple] = {}

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(name, **kwargs)
            elif not isinstance(metric, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(metric).__name__}, not {cls.__name__}")
            return metric

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kwargs) -> Histogram:
        return self._get(name, Histogram, **kwargs)

    def gauge_fn(self, name: str, fn: Callable[[], float]) -> None:
        """Register a lazily-evaluated gauge (instantaneous value —
        last-write-wins on merge) — the bridge that puts existing plain
        attributes on the one export path without changing how they are
        written."""
        with self._lock:
            self._lazy_fns[name] = ("gauge", fn)

    def counter_fn(self, name: str, fn: Callable[[], float]) -> None:
        """Like :meth:`gauge_fn` but exported as a COUNTER: monotonic
        per-process totals (``engine.steps``, ``router.redispatches``)
        must SUM across sources in the fleet merge, not keep whichever
        replica's snapshot sorted last."""
        with self._lock:
            self._lazy_fns[name] = ("counter", fn)

    def snapshot(self) -> dict:
        out = {}
        with self._lock:
            metrics = dict(self._metrics)
            lazy_fns = dict(self._lazy_fns)
        for name, metric in sorted(metrics.items()):
            out[name] = metric.snapshot()
        for name, (kind, fn) in sorted(lazy_fns.items()):
            try:
                out[name] = {"type": kind, "value": fn()}
            except Exception:
                pass  # a dead closure must never break the export path
        return out


def merge_snapshots(snapshots: List[dict]) -> dict:
    """Fleet-wide aggregation of per-process registry snapshots:
    counters add, histograms merge bucket-wise, gauges keep the last
    writer (they are instantaneous by definition). A TYPE CONFLICT
    (two sources registered one name as different kinds — a version
    skew across a rolling fleet) keeps the first writer deterministically
    instead of corrupting the merge or taking the export path down."""
    merged: dict = {}
    for snap in snapshots:
        for name, entry in snap.items():
            kind = entry.get("type")
            have = merged.get(name)
            if have is None:
                merged[name] = dict(entry)
            elif have.get("type") != kind:
                continue                  # type conflict: first writer wins
            elif kind == "counter":
                have["value"] += entry["value"]
            elif kind == "histogram":
                hist = Histogram.from_snapshot(have, name).merge(
                    Histogram.from_snapshot(entry, name))
                merged[name] = hist.snapshot()
            else:
                merged[name] = dict(entry)
    return merged
