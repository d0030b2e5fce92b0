"""Replica fleet + least-loaded balancer (DESIGN.md §11.4).

Data-parallel scenario replicas — M copies of the same stage chain in
ONE executor plan — sit behind a :class:`FleetBalancer`. The balancer's
``pick`` policy is (1) liveness: a killed replica receives ZERO new
arrivals (its already-queued events still drain through its stages);
(2) health: an open breaker for the replica (``(replica, "entry")``-keyed
:class:`~repro.faults.health.HealthRegistry`) skips it like a dead one;
(3) load: among the live candidates, route to the replica with the
shallowest entry queue (`ExecContext.queue_depth` — the same per-replica
`StageStats` signal the quota controller reads). Ties break
round-robin so equal-load replicas share traffic instead of pile-on.

Wire it into a plan with
:func:`repro.core.multitenant.make_balance_op(balancer.pick)` on a
dispatch stage whose successors are the replica entry stages.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

__all__ = ["Replica", "FleetBalancer"]


@dataclass
class Replica:
    """One scenario-service replica: its entry stage in the shared plan
    plus balancer-visible state."""
    name: str
    entry: str                    # entry stage name in the executor plan
    alive: bool = True
    routed: int = 0               # arrivals the balancer sent here


class FleetBalancer:
    """Least-loaded, health-aware replica choice."""

    def __init__(self, replicas: list, health=None, clock=None):
        self.replicas = list(replicas)
        self.by_name = {r.name: r for r in self.replicas}
        self.health = health      # optional (replica, "entry")-keyed registry
        self.clock = clock
        self._lock = threading.Lock()
        self._rr = 0              # tie-break cursor
        self.unroutable = 0

    # ------------------------------------------------------------ control
    def kill(self, name: str):
        self.by_name[name].alive = False

    def revive(self, name: str):
        self.by_name[name].alive = True

    def _allowed(self, replica: Replica) -> bool:
        if not replica.alive:
            return False
        if self.health is None:
            return True
        try:
            breaker = self.health[(replica.name, "entry")]
        except KeyError:
            return True
        now = self.health.clock() if self.clock is None else self.clock()
        return breaker.allow_request(now)

    # --------------------------------------------------------------- pick
    def pick(self, ev, ctx) -> Optional[str]:
        """Balance-op policy: entry stage of the chosen replica, or None
        when no replica is routable."""
        with self._lock:
            live = [r for r in self.replicas if self._allowed(r)]
            if not live:
                self.unroutable += 1
                return None
            depth = {r.name: ctx.queue_depth(r.entry) for r in live}
            best = min(depth[r.name] for r in live)
            cands = [r for r in live if depth[r.name] == best]
            choice = cands[self._rr % len(cands)]
            self._rr += 1
            choice.routed += 1
            return choice.entry

    # ------------------------------------------------------------- stats
    def snapshot(self) -> dict:
        return {r.name: {"alive": r.alive, "routed": r.routed}
                for r in self.replicas}
