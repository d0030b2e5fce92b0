"""Deterministic fault schedules (DESIGN.md §8.1).

A ``FaultPlan`` is a pure data schedule — (time, kind, server, amount)
tuples — built either explicitly (benchmark drills script the exact
scenario they gate) or sampled from a seeded RNG (``FaultPlan.random``:
same seed → same faults, so chaos results are reproducible). The
``FaultInjector`` walks the schedule against ANY clock: call
``poll(now)`` from a stage op (``ctx.now()``) or a drill loop and every
event whose time has come is applied to the cube.

Fault taxonomy (per cube server):

  * ``kill``          — hard kill (``alive = False``); optional later
                        revival. Lookups fail over to replicas.
  * ``unavailable``   — transient kill with a mandatory auto-revive
                        (network partition / GC pause flavour).
  * ``latency_spike`` — adds ``amount`` seconds to every RPC touching the
                        server for the duration.
  * ``slow_disk``     — multiplies the disk-block latency of the server's
                        memmapped blocks by ``amount`` for the duration.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

KINDS = ("kill", "revive", "unavailable", "latency_spike", "slow_disk")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled state change. ``until`` (absolute time) auto-schedules
    the recovery for transient kinds; ``amount`` is seconds for
    ``latency_spike`` and a multiplier for ``slow_disk``."""
    at: float
    kind: str
    server: int
    until: Optional[float] = None
    amount: float = 0.0


@dataclass
class FaultPlan:
    events: list = field(default_factory=list)

    # ------------------------------------------------------------ builders
    def kill(self, server: int, at: float,
             revive_at: Optional[float] = None) -> "FaultPlan":
        self.events.append(FaultEvent(at, "kill", server, until=revive_at))
        return self

    def unavailable(self, server: int, at: float,
                    duration_s: float) -> "FaultPlan":
        self.events.append(
            FaultEvent(at, "unavailable", server, until=at + duration_s))
        return self

    def latency_spike(self, server: int, at: float, duration_s: float,
                      add_s: float) -> "FaultPlan":
        self.events.append(FaultEvent(at, "latency_spike", server,
                                      until=at + duration_s, amount=add_s))
        return self

    def slow_disk(self, server: int, at: float, duration_s: float,
                  mult: float = 10.0) -> "FaultPlan":
        self.events.append(FaultEvent(at, "slow_disk", server,
                                      until=at + duration_s, amount=mult))
        return self

    @classmethod
    def random(cls, seed: int, n_servers: int, horizon_s: float,
               rate_per_s: float = 0.05, max_down_s: float = 2.0,
               spike_add_s: float = 2e-3, disk_mult: float = 10.0,
               allow_kill: bool = True) -> "FaultPlan":
        """Poisson-ish fault arrivals over [0, horizon): deterministic in
        ``seed``. Every sampled fault recovers within ``max_down_s`` so a
        random plan never leaves the fleet permanently degraded."""
        rng = np.random.default_rng(seed)
        plan = cls()
        t = 0.0
        kinds = ["unavailable", "latency_spike", "slow_disk"]
        if allow_kill:
            kinds.append("kill")
        while True:
            t += float(rng.exponential(1.0 / max(rate_per_s, 1e-9)))
            if t >= horizon_s:
                break
            sid = int(rng.integers(n_servers))
            dur = float(rng.uniform(0.1, 1.0) * max_down_s)
            kind = kinds[int(rng.integers(len(kinds)))]
            if kind == "kill":
                plan.kill(sid, t, revive_at=t + dur)
            elif kind == "unavailable":
                plan.unavailable(sid, t, dur)
            elif kind == "latency_spike":
                plan.latency_spike(sid, t, dur,
                                   float(rng.uniform(0.2, 1.0) * spike_add_s))
            else:
                plan.slow_disk(sid, t, dur, disk_mult)
        return plan

    # ------------------------------------------------------------ timeline
    def timeline(self) -> list:
        """Expand transient faults into (start, recover) pairs and return
        every state change sorted by time (recoveries after starts at the
        same instant)."""
        out = []
        for e in self.events:
            if e.kind not in KINDS:
                raise ValueError(f"unknown fault kind {e.kind!r}")
            out.append((e.at, 0, e))
            if e.until is not None:
                out.append((e.until, 1, e))
        out.sort(key=lambda x: (x[0], x[1]))
        return out


class FaultInjector:
    """Applies a plan's due events to a cube. Clock-agnostic: the caller
    owns time and calls ``poll(now)`` whenever it likes; every scheduled
    change with ``at <= now`` lands (idempotently — the walk index only
    moves forward). Recoveries restore the pre-fault state: revive for
    kills/unavailability, zero extra latency, unit disk multiplier."""

    def __init__(self, cube, plan: FaultPlan):
        self.cube = cube
        self.plan = plan
        self._timeline = plan.timeline()
        self._i = 0
        self.applied: list = []      # (t, phase, FaultEvent) audit log

    def poll(self, now: float) -> int:
        n = 0
        while self._i < len(self._timeline):
            t, phase, e = self._timeline[self._i]
            if t > now:
                break
            self._apply(e, recovering=bool(phase))
            self.applied.append((t, "recover" if phase else "start", e))
            self._i += 1
            n += 1
        return n

    def drain(self) -> int:
        """Apply everything left (end-of-drill cleanup)."""
        return self.poll(float("inf"))

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self._timeline)

    def _apply(self, e: FaultEvent, recovering: bool):
        srv = self.cube.servers[e.server]
        if e.kind in ("kill", "unavailable"):
            if recovering:
                self.cube.revive_server(e.server)
            else:
                self.cube.kill_server(e.server)
        elif e.kind == "latency_spike":
            srv.extra_latency_s = 0.0 if recovering else e.amount
        elif e.kind == "slow_disk":
            srv.disk_latency_mult = 1.0 if recovering else e.amount


class HostFaultInjector(FaultInjector):
    """The same schedule machinery one level up: events target MESH HOSTS
    (``FaultEvent.server`` indexes ``mesh.host_list``) instead of
    in-process cube servers. Kills flip the host's ``alive`` flag —
    detection happens organically: the next lookup's failed probe raises
    ``HostDown``, the ShardClient records ONE host-level strike (opening
    every (host, *) breaker) and fails over along the topology's
    preference order. ``slow_disk`` has no host-level analogue and maps
    to a latency spike of ``amount`` milliseconds-scale seconds."""

    def __init__(self, mesh, plan: FaultPlan):
        super().__init__(mesh, plan)
        self.mesh = mesh

    def _apply(self, e: FaultEvent, recovering: bool):
        host = self.mesh.host_list[e.server]
        if e.kind in ("kill", "unavailable"):
            if recovering:
                self.mesh.revive_host(host.host_id)
            else:
                self.mesh.kill_host(host.host_id)
        elif e.kind in ("latency_spike", "slow_disk"):
            host.extra_latency_s = 0.0 if recovering else e.amount
