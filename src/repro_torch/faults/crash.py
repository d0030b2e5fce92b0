"""Simulated process crashes for recovery drills (DESIGN.md §9).

The chaos plane (``FaultPlan``/``FaultInjector``) models *intra-process*
faults: a server dies, a disk slows, a breaker opens — the process keeps
serving. Crash-safety needs the complement: the PROCESS dies at the worst
possible instant, mid-way through a multi-file publish, and a fresh
process must recover from whatever the filesystem holds.

``crash_point(name)`` is a named no-op sprinkled through durable-write
paths (delta emit, snapshot publish, chunked compaction). A drill ``arm``s
a point and the next hit raises :class:`SimulatedCrash` — the test/bench
catches it, DISCARDS the in-memory state (that is the crash), and runs
recovery against the torn on-disk state the abort left behind.

Unarmed, a crash point is one dict-emptiness check — cheap enough to live
inside writer loops. Points are process-global (the drills are
single-process by construction); ``disarm_all`` resets between cases.
"""
from __future__ import annotations

import threading

__all__ = ["SimulatedCrash", "arm", "disarm_all", "armed", "crash_point"]


class SimulatedCrash(RuntimeError):
    """Raised by an armed crash point: everything after this instant — in
    the aborted call stack AND in the process state the drill discards —
    simulates work a real crash would have lost."""


_lock = threading.Lock()
_armed: dict[str, int] = {}      # point → remaining hits before crash


def arm(point: str, at_hit: int = 1):
    """Arm ``point`` to crash on its ``at_hit``-th invocation (1 = next).
    The point disarms itself when it fires — one crash per arm."""
    assert at_hit >= 1
    with _lock:
        _armed[point] = at_hit


def disarm_all():
    with _lock:
        _armed.clear()


def armed() -> dict:
    with _lock:
        return dict(_armed)


def crash_point(point: str):
    """Durable-write paths call this at each torn-state boundary; a drill
    that armed ``point`` gets its simulated crash here."""
    if not _armed:                       # fast path: nothing armed anywhere
        return
    with _lock:
        n = _armed.get(point)
        if n is None:
            return
        if n > 1:
            _armed[point] = n - 1
            return
        del _armed[point]
    raise SimulatedCrash(point)
