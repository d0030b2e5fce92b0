"""Metrics registry — process-wide Counter/Gauge/Histogram under one
namespace (DESIGN.md §10.2).

The histogram is log-bucketed: observations land in geometric buckets
(factor 2**0.25 ≈ 19% width) so p50/p95/p99 come from cumulative bucket
counts without retaining raw samples. That replaces ``RunReport.latencies``'
unbounded list as the default accounting path on the serving loop; exact
mode stays available for tests/benches that need sample-level numbers.

Gauges are callback-based: ``registry.gauge(name, fn)`` registers a thunk
sampled at export time, so existing telemetry structs (``StageStats``,
``CubeMetrics``, breaker states, ...) plug in without copying state.
Multi-series collectors (``registry.collector``) emit whole labeled
families the same way.

Export formats: Prometheus text exposition (``to_prometheus``) and a flat
JSON snapshot (``snapshot``) — both read the same live objects.
"""
from __future__ import annotations

import json
import math
import threading
from bisect import bisect_right
from typing import Callable, Optional

NAMESPACE = "jizhi"

# geometric bucket ladder: 1µs .. ~4200s in 19%-wide steps. One shared
# ladder for every histogram keeps snapshots mergeable and the exposition
# page compact.
_BUCKET_FACTOR = 2.0 ** 0.25
_BUCKET_LO = 1e-6
_N_BUCKETS = 128
BUCKET_BOUNDS = tuple(_BUCKET_LO * _BUCKET_FACTOR ** i
                      for i in range(_N_BUCKETS))


def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


class Counter:
    """Monotonic counter. ``inc`` is lock-protected — workers on the async
    executor bump counters concurrently."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def sample(self):
        return self.value


class Gauge:
    """Point-in-time value. Either set directly (``set``) or backed by a
    callback sampled at export time (``fn``)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.fn = fn
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def sample(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:  # noqa: BLE001 — a dead callback must not
                # poison the whole exposition page
                return float("nan")
        return self._value


class Histogram:
    """Log-bucketed histogram: O(1) memory per series, percentile via
    cumulative counts (upper bucket bound = conservative estimate, error
    bounded by the 19% bucket width)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._counts = [0] * (_N_BUCKETS + 1)   # +1 overflow bucket
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        idx = bisect_right(BUCKET_BOUNDS, value)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    def observe_many(self, values) -> None:
        for v in values:
            self.observe(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float:
        """Ceil-based nearest-rank over cumulative bucket counts; returns
        the upper bound of the bucket holding that rank (clamped to the
        observed max so a single-sample histogram reports the sample)."""
        with self._lock:
            n = self._count
            if n == 0:
                return 0.0
            rank = max(1, math.ceil(q * n))
            acc = 0
            for i, c in enumerate(self._counts):
                acc += c
                if acc >= rank:
                    if i >= _N_BUCKETS:
                        return self._max
                    hi = BUCKET_BOUNDS[i]
                    return min(hi, self._max) if self._max > -math.inf else hi
            return self._max

    def sample(self) -> dict:
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                        "p50": 0.0, "p95": 0.0, "p99": 0.0}
            return self._sample_locked()

    def _sample_locked(self) -> dict:
        # caller holds the lock; percentile() re-acquires, so inline it
        out = {"count": self._count, "sum": self._sum,
               "min": self._min, "max": self._max}
        for key, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            rank = max(1, math.ceil(q * self._count))
            acc = 0
            val = self._max
            for i, c in enumerate(self._counts):
                acc += c
                if acc >= rank:
                    val = (self._max if i >= _N_BUCKETS
                           else min(BUCKET_BOUNDS[i], self._max))
                    break
            out[key] = val
        return out

    def bucket_counts(self):
        with self._lock:
            return list(self._counts)


class MetricsRegistry:
    """Get-or-create registry for all series in the process. Thread-safe.

    ``collector(name, fn)`` registers a callback returning a whole labeled
    family at once: ``{(("stage","rerank"),): value, ...}`` — a dict mapping
    label tuples (sorted (key, value) pairs) to numbers. Used for per-stage
    / per-server series whose population is only known at sample time.
    """

    def __init__(self, namespace: str = NAMESPACE):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._collectors: dict[str, Callable[[], dict]] = {}

    # ---------------------------------------------------- get-or-create

    def _get(self, cls, name: str, help: str, **kw):
        name = _sanitize(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, wanted {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(Gauge, name, help)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def collector(self, name: str, fn: Callable[[], dict],
                  help: str = "") -> None:
        """fn() -> {label_tuple: value}; label_tuple is a tuple of
        (key, value) string pairs."""
        with self._lock:
            self._collectors[_sanitize(name)] = fn

    def unregister(self, name: str) -> None:
        name = _sanitize(name)
        with self._lock:
            self._metrics.pop(name, None)
            self._collectors.pop(name, None)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()

    # ----------------------------------------------------------- export

    def _items(self):
        with self._lock:
            metrics = sorted(self._metrics.items())
            collectors = sorted(self._collectors.items())
        return metrics, collectors

    def snapshot(self) -> dict:
        """Flat JSON-serializable snapshot: ``{full_name: value}`` for
        scalars, ``{full_name: {count,sum,min,max,p50,p95,p99}}`` for
        histograms, labeled series as ``name{k=v,...}`` keys."""
        out: dict[str, object] = {}
        metrics, collectors = self._items()
        for name, m in metrics:
            out[f"{self.namespace}_{name}"] = m.sample()
        for name, fn in collectors:
            try:
                series = fn() or {}
            except Exception:  # noqa: BLE001
                continue
            for labels, value in sorted(series.items()):
                lbl = ",".join(f"{k}={v}" for k, v in labels)
                out[f"{self.namespace}_{name}{{{lbl}}}"] = value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format, version 0.0.4."""
        lines: list[str] = []
        metrics, collectors = self._items()
        for name, m in metrics:
            full = f"{self.namespace}_{name}"
            if m.help:
                lines.append(f"# HELP {full} {m.help}")
            if isinstance(m, Histogram):
                lines.append(f"# TYPE {full} histogram")
                acc = 0
                counts = m.bucket_counts()
                for i, c in enumerate(counts[:-1]):
                    if c == 0:
                        continue
                    acc += c
                    lines.append(f'{full}_bucket{{le="{BUCKET_BOUNDS[i]:.6g}"'
                                 f'}} {acc}')
                acc += counts[-1]
                lines.append(f'{full}_bucket{{le="+Inf"}} {acc}')
                lines.append(f"{full}_sum {m.sum:.9g}")
                lines.append(f"{full}_count {m.count}")
            else:
                lines.append(f"# TYPE {full} {m.kind}")
                v = m.sample()
                lines.append(f"{full} {v:.9g}")
        for name, fn in collectors:
            full = f"{self.namespace}_{name}"
            try:
                series = fn() or {}
            except Exception:  # noqa: BLE001
                continue
            lines.append(f"# TYPE {full} gauge")
            for labels, value in sorted(series.items()):
                lbl = ",".join(f'{k}="{v}"' for k, v in labels)
                lines.append(f"{full}{{{lbl}}} {float(value):.9g}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=1, sort_keys=True,
                          default=str)


# The process-wide default registry. Components register here unless handed
# an explicit registry (tests construct private ones).
DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return DEFAULT
