"""Per-server circuit breaker (DESIGN.md §8.2).

A dead cube server costs every lookup that routes to it one failed-probe
RPC before the replica path takes over. The breaker remembers: after
``failure_threshold`` consecutive failures it OPENS and the router treats
the server as down without probing; after ``cooldown_s`` it lets ONE
probe through (HALF-OPEN) — a success closes it, a failure re-opens it
and restarts the cooldown. States:

    closed ──(threshold consecutive failures)──► open
    open ──(cooldown elapsed)──► half-open
    half-open ──(probe ok)──► closed
    half-open ──(probe fails)──► open

Clock-agnostic: every transition takes ``now`` from the caller, so the
same breaker runs on wall time (AsyncExecutor) and on the SimExecutor's
virtual clock. Thread-safe: stage workers probe concurrently.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


class ServerHealth:
    """Circuit breaker for one cube server."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 1.0):
        assert failure_threshold >= 1 and cooldown_s >= 0.0
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.state = BREAKER_CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self._probe_out = False      # half-open: one probe in flight
        self._lock = threading.Lock()
        # observability counters
        self.opens = 0
        self.closes = 0
        self.skipped = 0             # requests the open breaker absorbed

    def allow_request(self, now: float) -> bool:
        """May the router probe this server at ``now``? An open breaker
        absorbs the request (False = route straight to the replica tier);
        after the cooldown exactly one caller gets True as the half-open
        probe until its success/failure lands."""
        with self._lock:
            if self.state == BREAKER_CLOSED:
                return True
            if self.state == BREAKER_OPEN:
                if now - self.opened_at < self.cooldown_s:
                    self.skipped += 1
                    return False
                self.state = BREAKER_HALF_OPEN
                self._probe_out = False
            # half-open: admit a single probe per transition
            if self._probe_out:
                self.skipped += 1
                return False
            self._probe_out = True
            return True

    def record_success(self, now: float):
        with self._lock:
            self.consecutive_failures = 0
            self._probe_out = False
            if self.state != BREAKER_CLOSED:
                self.closes += 1
                self.state = BREAKER_CLOSED

    def record_failure(self, now: float):
        with self._lock:
            self.consecutive_failures += 1
            self._probe_out = False
            if (self.state == BREAKER_HALF_OPEN
                    or self.consecutive_failures >= self.failure_threshold):
                if self.state != BREAKER_OPEN:
                    self.opens += 1
                self.state = BREAKER_OPEN
                self.opened_at = now

    def trip(self, now: float):
        """Force-open without paying ``failure_threshold`` probes — the
        fleet-wide verdict path: when a HOST is found dead, every breaker
        it backs opens at once (one strike total, DESIGN.md §11.5), not
        one failure-threshold run per shard."""
        with self._lock:
            self.consecutive_failures = max(self.consecutive_failures,
                                            self.failure_threshold)
            self._probe_out = False
            if self.state != BREAKER_OPEN:
                self.opens += 1
            self.state = BREAKER_OPEN
            self.opened_at = now


class HealthRegistry:
    """Breakers keyed by serving endpoint, plus the clock they share.

    Historically one breaker per in-process cube server, keyed by index
    (``n_servers=...``); the mesh generalizes keys to ``(host, server)``
    tuples (``keys=[...]``) so a host-level failure can open all of the
    host's breakers with ONE strike (``record_host_failure``). The
    positional ``servers`` list survives in key order — the cube's
    ``_alive_mask`` indexes it positionally.

    ``clock`` defaults to ``time.monotonic``; benchmarks running on a
    virtual clock pass their own callable (``lambda: sim_now``). Attach to
    a cube with ``ParameterCube.attach_health`` or a mesh with
    ``MeshCube.attach_health``."""

    def __init__(self, n_servers: Optional[int] = None,
                 clock: Optional[Callable] = None,
                 failure_threshold: int = 3, cooldown_s: float = 1.0,
                 keys: Optional[list] = None):
        assert (n_servers is None) != (keys is None), \
            "pass exactly one of n_servers / keys"
        self.clock = clock or time.monotonic
        self.keys = list(keys) if keys is not None else list(range(n_servers))
        self._breakers = {k: ServerHealth(failure_threshold, cooldown_s)
                          for k in self.keys}
        # positional view in key order — legacy int-keyed callers
        # (cube._alive_mask) index this directly
        self.servers = [self._breakers[k] for k in self.keys]

    @classmethod
    def for_mesh(cls, hosts, n_shards: int, **kw) -> "HealthRegistry":
        """One breaker per (host, shard) pair of a mesh topology."""
        return cls(keys=[(h, s) for h in hosts for s in range(n_shards)],
                   **kw)

    def __getitem__(self, key) -> ServerHealth:
        return self._breakers[key]

    def __len__(self) -> int:
        return len(self.servers)

    def record_host_failure(self, host, now: Optional[float] = None):
        """One dead host = one strike: trip every breaker whose key names
        ``host`` (tuple keys with ``key[0] == host``)."""
        now = self.clock() if now is None else now
        for k, b in self._breakers.items():
            if isinstance(k, tuple) and k and k[0] == host:
                b.trip(now)

    def host_states(self, host) -> dict:
        return {k: b.state for k, b in self._breakers.items()
                if isinstance(k, tuple) and k and k[0] == host}

    def states(self) -> list[str]:
        return [h.state for h in self.servers]

    @property
    def total_skipped(self) -> int:
        return sum(h.skipped for h in self.servers)
