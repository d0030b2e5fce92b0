"""The traced sub-window: one dispatch loop run under ``torch.profiler``,
reduced to the device's busy time, the
time of each layer's kernels, the largest device operations and the
longest idle gaps by what the host was doing. The profiler's trace is
written to a temporary directory (under ``TMPDIR``), read and deleted.

Kernels map to layers through ``kernels.json`` (a layer: the names of
its kernels, matched as whole identifiers in the trace's kernel names).
A kernel that matches no layer is a plain torch operation."""
from __future__ import annotations

import bisect
import json
import re
import tempfile
from pathlib import Path

import torch

LAYERS = Path(__file__).resolve().parent / "kernels.json"
WINDOW = "portbench.window"
TOP = 10
#: the profiler's activity kinds that occupy the device
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the host's activity kinds that label an idle gap
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def kernel_layers() -> list[tuple[str, re.Pattern]]:
    table = json.loads(LAYERS.read_text())
    return [(layer, re.compile(r"\b(" + "|".join(map(re.escape, names))
                               + r")\b"))
            for layer, names in table["layers"].items()]


def layer_of(name: str, layers) -> str | None:
    for layer, pat in layers:
        if pat.search(name):
            return layer
    return None


def _union(intervals, lo, hi) -> tuple[float, list]:
    """Busy ns of ``intervals`` clipped to [lo, hi], and the idle gaps
    (start, end) between them."""
    busy, gaps, at = 0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        if e > at:
            busy += e - max(s, at)
            at = e
    if hi > at:
        gaps.append((at, hi))
    return busy, gaps


def _host_label(cpu, starts, t) -> str:
    """The innermost host event running at ``t``."""
    k = bisect.bisect_right(starts, t)
    for j in range(k - 1, max(k - 4000, 0) - 1, -1):
        s, e, name = cpu[j]
        if e >= t:
            return name
    return "host: no recorded op"


def reduce(events: list) -> dict | None:
    """The window's figures from the trace's events (the profiler's
    Chrome trace: "cat", "name", "ts" and "dur" in us), or None when the
    trace holds no device event."""
    win = next((e for e in events if e.get("name") == WINDOW
                and e.get("cat") == "user_annotation"), None)
    dev = [e for e in events if e.get("cat") in DEVICE_KINDS and "dur" in e]
    if win is None or not dev:
        return None
    lo, hi = win["ts"], win["ts"] + win["dur"]
    layers = kernel_layers()
    layer_s: dict = {}
    by_name: dict = {}
    other = copies = 0.0
    for e in dev:
        if not lo <= e["ts"] <= hi:
            continue
        dur, name = e["dur"], e["name"]
        by_name[name] = by_name.get(name, 0.0) + dur
        if e["cat"] != "kernel":
            copies += dur
            continue
        layer = layer_of(name, layers)
        if layer is None:
            other += dur
        else:
            layer_s[layer] = layer_s.get(layer, 0.0) + dur
    busy, gaps = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi)
    cpu = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") in HOST_KINDS and "dur" in e
                 and e.get("name") != WINDOW)
    starts = [c[0] for c in cpu]
    idle: dict = {}
    for s, e in gaps:
        label = _host_label(cpu, starts, s)
        idle[label] = idle.get(label, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "layer_s": {k: v / 1e6 for k, v in layer_s.items()},
            "other_s": other / 1e6, "copy_s": copies / 1e6,
            "device_ops": [[n[:120], v / 1e6] for n, v in top],
            "idle_gaps": [[n[:120], v / 1e6] for n, v in gaps_top]}


def profile(loop, seconds: float, tries: int = 3) -> dict | None:
    """``loop.run(seconds)`` under the profiler: the reduced figures with
    the run's own ("slots", "items", "calls"). A trace that comes back
    without device events is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    from torch.profiler import record_function
    for _ in range(tries):
        torch.cuda.synchronize()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                got = loop.run(seconds=seconds)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text()).get("traceEvents", [])
        out = reduce(events)
        if out is not None:
            out.update(slots=got["slots"], items=got["items"],
                       calls=got["calls"])
            return out
    return None
