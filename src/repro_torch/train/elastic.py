"""Elastic scaling + failure handling policy for 1000+-node fleets.

What actually happens on real pods: a chip/host dies → the job restarts on
the surviving topology. The framework's job is to make that restart CHEAP
and AUTOMATIC:

  1. health: heartbeat registry; missing heartbeats mark hosts dead.
  2. re-mesh: pick the largest supported mesh ≤ survivors (pods × 16 × 16,
     then halving data); recompute per-device batch so the GLOBAL batch and
     therefore the training trajectory is preserved (grad-accum absorbs the
     difference).
  3. restore: sharding-aware checkpoint restore onto the new mesh
     (repro.train.checkpoint.restore with the new shardings) — no format
     migration, leaves reshard on device_put.
  4. stragglers: the data pipeline hands out redundant shard leases;
     SEDP stages apply batch timeouts so one slow worker can't stall a
     batch (the paper's long-tail mitigation, applied to training I/O).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    alive: bool = True


class HealthRegistry:
    def __init__(self, n_hosts: int, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        now = time.monotonic()
        self.hosts = {i: HostState(i, now) for i in range(n_hosts)}

    def heartbeat(self, host_id: int, now: Optional[float] = None):
        self.hosts[host_id].last_heartbeat = now or time.monotonic()
        self.hosts[host_id].alive = True

    def sweep(self, now: Optional[float] = None) -> list[int]:
        now = now or time.monotonic()
        dead = []
        for h in self.hosts.values():
            if h.alive and now - h.last_heartbeat > self.timeout_s:
                h.alive = False
                dead.append(h.host_id)
        return dead

    @property
    def n_alive(self) -> int:
        return sum(h.alive for h in self.hosts.values())


@dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axes: tuple
    n_micro: int
    per_shard_batch: int


def plan_mesh(n_devices: int, global_batch: int,
              per_shard_seqs: int = 1, model_axis: int = 16) -> MeshPlan:
    """Largest supported mesh ≤ n_devices keeping the model axis intact
    (TP size is a model property; only data parallelism is elastic)."""
    if n_devices < model_axis:
        raise ValueError(f"need ≥{model_axis} devices for the model axis")
    data = n_devices // model_axis
    # data axis: largest power of two ≤ available (keeps batch divisible)
    d = 1
    while d * 2 <= data:
        d *= 2
    pods = 1
    if d > 16:                       # factor into (pod, 16)
        pods, d = d // 16, 16
    ds = pods * d
    n_micro = max(1, global_batch // (per_shard_seqs * ds))
    while global_batch % n_micro or (global_batch // n_micro) % ds:
        n_micro -= 1
    shape = (pods, d, model_axis) if pods > 1 else (d, model_axis)
    axes = ("pod", "data", "model") if pods > 1 else ("data", "model")
    return MeshPlan(shape, axes, max(1, n_micro), global_batch // ds)


@dataclass
class ShardLease:
    """Straggler-tolerant input sharding: every data shard is leased to a
    primary AND a backup reader; first completion wins (backup task
    pattern à la MapReduce)."""
    shard_id: int
    primary: int
    backup: int
    completed_by: Optional[int] = None


def lease_shards(n_shards: int, workers: list[int]) -> list[ShardLease]:
    n = len(workers)
    return [ShardLease(s, workers[s % n], workers[(s + n // 2) % n])
            for s in range(n_shards)]
