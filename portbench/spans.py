"""The program's layer spans in the traced sub-window, and their readers.

The program marks the layers of its model step with spans on the
profiler's clock (``repro_torch.obs.layer.span``: ``model.*`` around a
layer, ``kernel.<name>`` around a kernel wrapper's host path); each lands
in the profiler's Chrome trace as a ``user_annotation`` event. For each
span name that starts inside the window (``tracing.WINDOW``, the window
whose calls the trace counts), :func:`reduce` gives

  * ``count``: the spans;
  * ``host_s``: their host durations, summed;
  * ``device_s``: the device time of the kernels and copies whose launch
    lay inside one of them (nested spans included). A device event is
    matched to its launch by the trace's ``correlation`` argument, never
    by time: with batches in flight a kernel runs while the host is
    already in the next batch's spans;
  * ``idle_s``: the device's idle time (the gaps between its events)
    while the host was inside one of them;
  * ``launches``: the ``cudaLaunch*``, ``cuLaunch*`` and
    ``cudaGraphLaunch`` calls inside them.

The harness reduces the trace with ``tracing.reduce``; :func:`install`
wraps it so that its figures also hold "spans" (the above, by name) and
"unmatched_s" (device seconds in the window whose correlation matched no
host event). The span metrics' readers call it when the harness loads
them, before the window runs, so the spans are read from the same trace
and window as every other traced metric. A program without spans gives
no names, and each reader below then returns None.
"""
from __future__ import annotations

import bisect
import re

from portbench import tracing

PREFIXES = ("model.", "kernel.")
LAUNCH = re.compile(r"^(cudaLaunch|cuLaunch|cudaGraphLaunch)")
#: the host's activity kinds that launch device work
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


def _inside(starts, ends, t) -> bool:
    """``t`` lies in one of the sorted, disjoint intervals."""
    k = bisect.bisect_right(starts, t) - 1
    return k >= 0 and t <= ends[k]


def _overlap(starts, ends, gaps) -> float:
    """Time that the sorted, disjoint ``gaps`` share with the intervals."""
    total, j = 0.0, 0
    for gs, ge in gaps:
        while j < len(starts) and ends[j] <= gs:
            j += 1
        k = j
        while k < len(starts) and starts[k] < ge:
            total += max(0.0, min(ge, ends[k]) - max(gs, starts[k]))
            k += 1
    return total


def _correlation(e):
    return (e.get("args") or {}).get("correlation")


def reduce(events: list) -> dict | None:
    """{"spans": {name: {"count", "host_s", "device_s", "idle_s",
    "launches"}}, "unmatched_s"} from the trace's events (the profiler's
    Chrome trace, times in us), or None without a window."""
    win = next((e for e in events if e.get("name") == tracing.WINDOW
                and e.get("cat") == "user_annotation"), None)
    if win is None:
        return None
    lo, hi = win["ts"], win["ts"] + win["dur"]
    raw: dict = {}
    for e in events:
        if (e.get("cat") == "user_annotation" and "dur" in e
                and e["name"].startswith(PREFIXES) and lo <= e["ts"] <= hi):
            raw.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    launched_at, launches = {}, []
    for e in events:
        if e.get("cat") in LAUNCH_KINDS:
            c = _correlation(e)
            if c is not None:
                launched_at[c] = e["ts"]
            if LAUNCH.match(e["name"]):
                launches.append(e["ts"])
    dev = [e for e in events
           if e.get("cat") in tracing.DEVICE_KINDS and "dur" in e]
    _, gaps = tracing._union([(e["ts"], e["ts"] + e["dur"]) for e in dev],
                             lo, hi)
    unmatched = 0.0
    at = []                       # (launch time, device us) of each event
    for e in dev:
        t = launched_at.get(_correlation(e))
        if t is not None:
            at.append((t, e["dur"]))
        elif lo <= e["ts"] <= hi:
            unmatched += e["dur"]
    spans = {}
    for name, iv in raw.items():
        # spans of one name never nest: sorted, they are disjoint
        starts, ends = zip(*sorted(iv))
        spans[name] = {
            "count": len(iv),
            "host_s": sum(e - s for s, e in iv) / 1e6,
            "device_s": sum(d for t, d in at
                            if _inside(starts, ends, t)) / 1e6,
            "idle_s": _overlap(starts, ends, gaps) / 1e6,
            "launches": sum(_inside(starts, ends, t) for t in launches)}
    return {"spans": spans, "unmatched_s": unmatched / 1e6}


def install():
    """Wrap ``tracing.reduce`` once so that its figures also hold this
    module's ("spans", "unmatched_s")."""
    base = tracing.reduce
    if hasattr(base, "base"):
        return

    def with_spans(events):
        out = base(events)
        if out is not None:
            out.update(reduce(events))
        return out
    with_spans.base = base
    tracing.reduce = with_spans


def _figure(run, name: str, key: str):
    """``key`` of span ``name`` a call of the traced window, or None."""
    tr = run.trace
    if tr is None or not tr.get("calls"):
        return None
    span = tr.get("spans", {}).get(name)
    return None if span is None else span[key] / tr["calls"]


def span_host_ms(run, name: str):
    """Host ms a call inside span ``name``."""
    v = _figure(run, name, "host_s")
    return None if v is None else 1e3 * v


def span_device_ms(run, name: str):
    """Device ms a call of the work launched inside span ``name``."""
    v = _figure(run, name, "device_s")
    return None if v is None else 1e3 * v


def span_idle_ms(run, name: str):
    """Device idle ms a call while the host is inside span ``name``."""
    v = _figure(run, name, "idle_s")
    return None if v is None else 1e3 * v


def span_launches(run, name: str):
    """Kernel launches a call inside span ``name``."""
    return _figure(run, name, "launches")
