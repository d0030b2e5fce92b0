"""Bridges: register the existing telemetry structs with a
``MetricsRegistry`` under the ``jizhi_`` namespace (DESIGN.md §10.3).

Every bridge is callback-based — registration stores a thunk over the
live object, sampled only at export time, so attaching observability to
a component costs nothing on its hot path. Each ``register_*`` takes an
optional registry (defaults to the process-wide one) and an optional
``prefix`` so multiple instances (two cubes, per-scenario executors)
coexist without colliding.
"""
from __future__ import annotations

from dataclasses import fields, is_dataclass
from typing import Optional

from repro_torch.obs.metrics import DEFAULT, MetricsRegistry


def _reg(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    return registry if registry is not None else DEFAULT


def _dataclass_series(obj, label: tuple) -> dict:
    out = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, (int, float)):
            out[label + (("field", f.name),)] = v
    return out


def register_executor(executor, name: str = "exec",
                      registry: Optional[MetricsRegistry] = None) -> None:
    """Per-stage ``StageStats`` as one labeled family
    (``jizhi_stage_stats{exec=...,stage=...,field=...}``) plus live queue
    depths."""
    r = _reg(registry)

    def stage_series():
        out = {}
        for stage, st in list(executor.stats.items()):
            out.update(_dataclass_series(
                st, (("exec", name), ("stage", stage))))
        return out

    def depth_series():
        out = {}
        for stage in executor.plan.stages:
            try:
                out[(("exec", name), ("stage", stage))] = \
                    executor._depth(stage)
            except Exception:  # noqa: BLE001 — depth on a torn-down
                # executor must not poison the page
                pass
        return out

    r.collector(f"stage_stats_{name}", stage_series,
                help="per-stage SEDP executor counters")
    r.collector(f"queue_depth_{name}", depth_series,
                help="live channel depth per stage")


def register_cube(cube, name: str = "cube",
                  registry: Optional[MetricsRegistry] = None) -> None:
    r = _reg(registry)
    r.gauge(f"{name}_version", "published cube version",
            fn=lambda: cube.version)
    r.collector(
        f"{name}_metrics",
        lambda: _dataclass_series(cube.metrics, (("cube", name),)),
        help="ParameterCube counters (lookups, failovers, compaction)")


def register_health(health, name: str = "cube",
                    registry: Optional[MetricsRegistry] = None) -> None:
    """Per-server breaker state (0=closed, 1=half_open, 2=open) and its
    open/close/skip counters."""
    r = _reg(registry)
    code = {"closed": 0, "half_open": 1, "open": 2}

    def series():
        out = {}
        for sid, h in enumerate(health.servers):
            base = (("cube", name), ("server", str(sid)))
            out[base + (("field", "state"),)] = code.get(h.state, -1)
            out[base + (("field", "opens"),)] = h.opens
            out[base + (("field", "closes"),)] = h.closes
            out[base + (("field", "skipped"),)] = h.skipped
        return out

    r.collector(f"{name}_breaker", series,
                help="per-server circuit breaker state + transitions")


def register_update_manager(mgr, name: str = "update",
                            registry: Optional[MetricsRegistry] = None) -> None:
    r = _reg(registry)
    r.collector(
        f"{name}_stats",
        lambda: _dataclass_series(mgr.stats, (("mgr", name),)),
        help="UpdateManager counters incl. apply/compaction timings")
    r.gauge(f"{name}_last_version", "last delta version applied",
            fn=lambda: mgr.stats.last_version)


def register_quota(quota, name: str = "shed",
                   registry: Optional[MetricsRegistry] = None) -> None:
    r = _reg(registry)
    r.gauge(f"{name}_quota", "live admission quota (1.0 = free capacity)",
            fn=lambda: quota.value)


def register_traced_jit(tj, name: str,
                        registry: Optional[MetricsRegistry] = None) -> None:
    r = _reg(registry)
    r.gauge(f"jit_traces_{name}", "jit cache size (recompilation count)",
            fn=lambda: tj.n_traces)


def register_snapshotter(snap, name: str = "snapshot",
                         registry: Optional[MetricsRegistry] = None) -> None:
    r = _reg(registry)
    r.gauge(f"{name}_last_version", "last durable snapshot version",
            fn=lambda: snap.last_snapshot_version)
    r.gauge(f"{name}_last_duration_s", "duration of the last snapshot",
            fn=lambda: getattr(snap, "last_snapshot_s", 0.0))


def register_delta_watcher(dw, name: str = "delta",
                           registry: Optional[MetricsRegistry] = None) -> None:
    r = _reg(registry)
    r.gauge(f"{name}_applied_version", "delta-log apply cursor",
            fn=lambda: dw.applied_version)


def register_substrate(sub, name: str = "substrate",
                       registry: Optional[MetricsRegistry] = None) -> None:
    """One call registers a ServingSubstrate's cube, health (if attached),
    update manager and replay timing."""
    r = _reg(registry)
    register_cube(sub.cube, name=f"{name}_cube", registry=r)
    if getattr(sub.cube, "health", None) is not None:
        register_health(sub.cube.health, name=f"{name}_cube", registry=r)
    if getattr(sub, "updates", None) is not None:
        register_update_manager(sub.updates, name=f"{name}_update",
                                registry=r)
    r.gauge(f"{name}_last_replay_s", "duration of the last delta-log replay",
            fn=lambda: getattr(sub, "last_replay_s", 0.0))


def register_runtime(rt, name: str,
                     registry: Optional[MetricsRegistry] = None) -> None:
    """A ScenarioRuntime's jit trace counters."""
    r = _reg(registry)
    for attr in ("serve", "rerank", "retrieve"):
        tj = getattr(rt, attr, None)
        if tj is not None and hasattr(tj, "n_traces"):
            register_traced_jit(tj, f"{name}_{attr}", registry=r)


def register_service(svc, name: str = "svc",
                     registry: Optional[MetricsRegistry] = None) -> None:
    """Convenience: wire a whole InferenceService/MultiScenarioService —
    substrate, runtimes, shedder quota — in one call."""
    r = _reg(registry)
    sub = getattr(svc, "substrate", None)
    if sub is not None:
        register_substrate(sub, name=name, registry=r)
    runtimes = getattr(svc, "runtimes", None) or {}
    for sc_name, rt in (runtimes.items()
                        if hasattr(runtimes, "items") else []):
        register_runtime(rt, f"{name}_{sc_name}", registry=r)
    rt = getattr(svc, "runtime", None)
    if rt is not None:
        register_runtime(rt, name, registry=r)
    shedder = getattr(svc, "shedder", None)
    if shedder is not None and getattr(shedder, "controller", None) is not None:
        register_quota(shedder.controller, name=name, registry=r)
