"""Unified telemetry plane (DESIGN.md §10).

Three legs:
  * ``obs.trace``   — per-request span trees through both executors,
                      tail-sampled ``TraceBuffer``, Chrome/Perfetto export,
                      critical-path analysis.
  * ``obs.metrics`` — process-wide Counter/Gauge/Histogram registry with
                      Prometheus + JSON export; ``obs.bridge`` plugs the
                      existing telemetry structs in callback-style.
  * ``obs.recorder``— windowed, DONE-marker-published history log the IRM's
                      offline auto-search reads (ROADMAP item 4).
``obs.log`` is the one structured-logging helper every watcher/monitor
emits through.
"""
from repro_torch.obs import bridge  # noqa: F401
from repro_torch.obs.log import CapturingHandler, log_event  # noqa: F401
from repro_torch.obs.metrics import (DEFAULT, BUCKET_BOUNDS, Counter,  # noqa: F401
                               Gauge, Histogram, MetricsRegistry,
                               get_registry)
from repro_torch.obs.trace import (TraceBuffer, Tracer, add_child_spans,  # noqa: F401
                             annotate, critical_path, shard_fanout_spans,
                             shard_profile, span_topology, stage_path)

__all__ = [
    "DEFAULT", "BUCKET_BOUNDS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "get_registry", "Tracer", "TraceBuffer", "annotate",
    "add_child_spans", "shard_fanout_spans", "shard_profile",
    "critical_path", "span_topology", "stage_path", "log_event",
    "CapturingHandler", "bridge", "StatsRecorder", "read_history",
]


def __getattr__(name):
    # recorder imports stay lazy: obs.log is imported by serve/hotload,
    # and an eager recorder import here would close an import cycle the
    # moment a watcher pulls in obs
    if name in ("StatsRecorder", "read_history"):
        from repro_torch.obs import recorder
        return getattr(recorder, name)
    raise AttributeError(name)
