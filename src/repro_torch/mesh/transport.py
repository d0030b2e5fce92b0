"""ShardClient / ShardHost transport boundary (DESIGN.md §11.2).

A :class:`ShardHost` is the access path to the shard cubes a simulated
host serves: an in-process thread pool standing in for the remote RPC
endpoint, with an injectable fault surface (``alive``,
``extra_latency_s``) that the host-level fault injector
(:class:`repro.faults.plan.HostFaultInjector`) drives mid-drill. Work
submitted to a dead host raises :class:`HostDown` — the transport-level
failure the client turns into failover + a host-level breaker trip.

The :class:`ShardClient` owns per-call routing policy:

  * host choice follows the topology's preference order, filtered by the
    ``(host, shard)``-keyed breaker registry (an OPEN breaker skips the
    host for free; a dead host costs ONE failed probe fleet-wide —
    ``record_host_failure`` trips every breaker of the host at once);
  * **hedged requests**: if the first host has not answered within
    ``hedge_after_s``, the same work is launched on the next preference
    host; the first response wins and the LOSER IS CANCELLED (its cancel
    event is set; a host checks it before touching the shard);
  * scatter: per-shard sub-batches of one lookup run concurrently on the
    client's pool, and every call records a fan-out entry (shard, host,
    key count, wall t0/t1, hedged) that the fetch stage turns into
    ``shard_fetch`` child spans.

Wall-clock latency injection (``time.sleep``) is opt-in per host
(``wall_latency=True``) — async/thread drills want real stalls, the
SimExecutor bench models the same latency on the virtual clock via its
service-time model instead.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Optional

__all__ = ["HostDown", "MeshUnavailable", "RequestCancelled", "ShardHost",
           "ShardClient"]


class HostDown(RuntimeError):
    """The submitted-to host is dead (transport-level failure)."""


class MeshUnavailable(RuntimeError):
    """No host holding the shard could serve the call."""


class RequestCancelled(Exception):
    """A hedged call lost the race and was cancelled before executing."""


class ShardHost:
    """One simulated host: a bounded worker pool + fault surface."""

    def __init__(self, host_id: str, n_workers: int = 2,
                 wall_latency: bool = False):
        self.host_id = host_id
        self.alive = True
        self.extra_latency_s = 0.0      # per-RPC latency injection
        self.wall_latency = wall_latency
        self.served = 0
        self.rejected = 0
        self.cancelled = 0
        self._pool = ThreadPoolExecutor(
            max_workers=n_workers, thread_name_prefix=f"mesh-{host_id}")

    def submit(self, fn: Callable, *args,
               cancel: Optional[threading.Event] = None):
        """Run ``fn(*args)`` on this host's pool. Checks the fault surface
        AT EXECUTION TIME (a kill landing while the call is queued still
        rejects it) and honours ``cancel`` both before and after any
        injected latency — a cancelled hedge loser never touches the
        shard."""
        def run():
            if cancel is not None and cancel.is_set():
                self.cancelled += 1
                raise RequestCancelled(self.host_id)
            if not self.alive:
                self.rejected += 1
                raise HostDown(self.host_id)
            if self.extra_latency_s > 0.0 and self.wall_latency:
                time.sleep(self.extra_latency_s)
            if cancel is not None and cancel.is_set():
                self.cancelled += 1
                raise RequestCancelled(self.host_id)
            if not self.alive:
                self.rejected += 1
                raise HostDown(self.host_id)
            out = fn(*args)
            self.served += 1
            return out
        return self._pool.submit(run)

    def shutdown(self):
        self._pool.shutdown(wait=False)


class ShardClient:
    """Routing + hedging + failover policy over a host fleet."""

    def __init__(self, hosts: dict, router, health=None,
                 hedge_after_s: Optional[float] = None,
                 scatter_workers: int = 8, clock=None):
        self.hosts = hosts              # host_id → ShardHost
        self.router = router
        self.health = health            # (host, shard)-keyed HealthRegistry
        self.hedge_after_s = hedge_after_s
        self.clock = clock or time.monotonic
        self._pool = ThreadPoolExecutor(max_workers=scatter_workers,
                                        thread_name_prefix="mesh-scatter")
        self._lock = threading.Lock()
        self.stats = {"calls": 0, "hedges": 0, "hedge_wins": 0,
                      "failovers": 0, "cancelled": 0, "host_failures": 0}

    # ------------------------------------------------------------ breakers
    def _allow(self, host_id: str, shard: int) -> bool:
        if self.health is None:
            return True
        try:
            breaker = self.health[(host_id, shard)]
        except KeyError:
            return True
        return breaker.allow_request(self.health.clock())

    def _record(self, host_id: str, shard: int, ok: bool):
        if self.health is None:
            return
        now = self.health.clock()
        if ok:
            try:
                self.health[(host_id, shard)].record_success(now)
            except KeyError:
                pass
        else:
            # a dead HOST is one strike fleet-wide: every (host, *)
            # breaker trips at once instead of paying one failed probe
            # per shard the host serves
            with self._lock:
                self.stats["host_failures"] += 1
            if hasattr(self.health, "record_host_failure"):
                self.health.record_host_failure(host_id, now)
            else:
                try:
                    self.health[(host_id, shard)].record_failure(now)
                except KeyError:
                    pass

    # ---------------------------------------------------------------- call
    def call(self, shard: int, fn: Callable):
        """Execute ``fn()`` on a host holding ``shard``. Returns
        ``(result, meta)`` with ``meta = {host, hedged, attempts}``.
        Raises :class:`MeshUnavailable` when every candidate fails."""
        topo = self.router.topology
        order = list(topo.hosts_for(shard))
        cands = [h for h in order if self._allow(h, shard)]
        if not cands:
            cands = order           # all breakers open: last-resort probes
        with self._lock:
            self.stats["calls"] += 1
        inflight: list = []         # (future, host_id, cancel, is_hedge)
        seq = 0
        errors: list = []

        def launch(host_id, is_hedge=False):
            nonlocal seq
            cancel = threading.Event()
            fut = self.hosts[host_id].submit(fn, cancel=cancel)
            inflight.append((fut, host_id, cancel, is_hedge))
            seq += 1

        launch(cands[0])
        next_cand = 1
        while True:
            hedge = (self.hedge_after_s
                     if (self.hedge_after_s is not None
                         and next_cand < len(cands) and len(inflight) == 1)
                     else None)
            done, _ = wait([f for f, *_ in inflight], timeout=hedge,
                           return_when=FIRST_COMPLETED)
            if not done:            # hedge window expired: race a second host
                with self._lock:
                    self.stats["hedges"] += 1
                launch(cands[next_cand], is_hedge=True)
                next_cand += 1
                continue
            for entry in list(inflight):
                fut, host_id, cancel, is_hedge = entry
                if not fut.done():
                    continue
                inflight.remove(entry)
                try:
                    out = fut.result()
                except RequestCancelled:
                    continue
                except HostDown:
                    self._record(host_id, shard, ok=False)
                    errors.append(host_id)
                    continue
                self._record(host_id, shard, ok=True)
                for _f2, _h2, c2, _s2 in inflight:
                    c2.set()        # first response wins: cancel the rest
                    with self._lock:
                        self.stats["cancelled"] += 1
                if is_hedge:
                    with self._lock:
                        self.stats["hedge_wins"] += 1
                return out, {"host": host_id, "hedged": is_hedge,
                             "attempts": seq}
            if not inflight:
                if next_cand < len(cands):
                    with self._lock:
                        self.stats["failovers"] += 1
                    launch(cands[next_cand])
                    next_cand += 1
                else:
                    raise MeshUnavailable(
                        f"shard {shard}: no live host among {order} "
                        f"(failed: {errors})")

    # ------------------------------------------------------------- scatter
    def scatter(self, calls: list) -> list:
        """Run ``[(shard, fn)]`` concurrently; returns
        ``[(shard, result_or_None, meta)]`` in input order. A shard whose
        every host is down yields ``result=None`` with
        ``meta["failed"]=True`` — the mesh lookup degrades that sub-batch
        to the default tier instead of failing the whole gather."""
        def one(shard, fn):
            t0 = self.clock()
            try:
                out, meta = self.call(shard, fn)
            except MeshUnavailable:
                out, meta = None, {"host": None, "hedged": False,
                                   "failed": True}
            meta.setdefault("failed", False)
            meta["t0"], meta["t1"] = t0, self.clock()
            return shard, out, meta
        if len(calls) == 1:
            return [one(*calls[0])]
        futs = [self._pool.submit(one, s, fn) for s, fn in calls]
        return [f.result() for f in futs]

    def shutdown(self):
        self._pool.shutdown(wait=False)
        for h in self.hosts.values():
            h.shutdown()
