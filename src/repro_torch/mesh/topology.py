"""Versioned shard topology + deterministic signature→shard routing
(DESIGN.md §11.1).

The mesh partitions the parameter cube across N shards served by H
simulated hosts. Routing must be (a) deterministic — every replica,
every drill re-run, and the single-host oracle agree on which shard owns
a signature; (b) stable under topology REPUBLISH — bumping the topology
version (failover reorder, host add) must not move keys; and (c) minimal
under RESHARD — growing n_shards moves only the keys the new shard wins.
Rendezvous (highest-random-weight) hashing gives all three: each shard
scores ``mix64(sig ^ salt_shard)`` and the max score owns the key, so
removing/adding one shard only touches that shard's keys.

Topology changes follow the cube's snapshot-swap discipline: a
:class:`ShardTopology` is immutable; the :class:`ShardRouter` publishes a
whole new versioned object with ONE atomic reference swap (readers that
captured the old object keep routing against exactly it — no reader ever
sees shard assignments from one version with host preferences from
another).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = ["ShardTopology", "ShardRouter", "make_topology", "mix64"]

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def mix64(x) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 arrays — the routing
    hash. Bijective, so distinct signatures never collide into identical
    score vectors."""
    x = np.atleast_1d(np.asarray(x, np.uint64)).copy()
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


@dataclass(frozen=True)
class ShardTopology:
    """One immutable, versioned view of the mesh layout.

    ``assignments[s]`` lists host INDEXES (into ``hosts``) that hold a
    copy of shard ``s``, in routing-preference order — element 0 is the
    primary, the rest are failover targets. A failover is a republished
    topology with the dead host rotated to the back of every assignment;
    ``shard_of`` does not read ``assignments``, so the key→shard mapping
    is untouched by failover republishes."""
    version: int
    n_shards: int
    hosts: tuple              # host ids, e.g. ("host0", "host1", ...)
    assignments: tuple        # per shard: tuple of host indexes, pref order
    seed: int = 0

    def _salts(self) -> np.ndarray:
        with np.errstate(over="ignore"):
            base = np.uint64(self.seed) * _GOLDEN
            return mix64(np.arange(1, self.n_shards + 1, dtype=np.uint64)
                         + base)

    def shard_of(self, sigs) -> np.ndarray:
        """Vectorized rendezvous routing: (B,) uint64 signatures →
        (B,) int32 shard ids. Depends only on (n_shards, seed) — never on
        version or host assignments."""
        sigs = np.atleast_1d(np.asarray(sigs, np.uint64))
        scores = mix64((sigs[None, :] ^ self._salts()[:, None]).ravel())
        scores = scores.reshape(self.n_shards, sigs.size)
        return np.argmax(scores, axis=0).astype(np.int32)

    def hosts_for(self, shard: int) -> tuple:
        """Host ids holding ``shard``, preference order."""
        return tuple(self.hosts[i] for i in self.assignments[shard])

    # ------------------------------------------------------- derivations
    def with_version(self, version: int) -> "ShardTopology":
        return ShardTopology(version, self.n_shards, self.hosts,
                             self.assignments, self.seed)

    def with_host_down(self, host_id: str) -> "ShardTopology":
        """Failover derivation: the dead host drops to the BACK of every
        assignment (still listed — it may revive), version bumps. The
        signature→shard mapping is untouched."""
        hi = self.hosts.index(host_id)
        assignments = tuple(
            tuple([i for i in a if i != hi] + [i for i in a if i == hi])
            for a in self.assignments)
        return ShardTopology(self.version + 1, self.n_shards, self.hosts,
                             assignments, self.seed)

    def with_shards(self, n_shards: int) -> "ShardTopology":
        """Reshard derivation: same hosts/seed, new shard count (the
        rendezvous property bounds key movement to the new shard's wins)."""
        return make_topology(n_shards, self.hosts,
                             replication=max(len(a)
                                             for a in self.assignments),
                             version=self.version + 1, seed=self.seed)


def make_topology(n_shards: int, hosts: Sequence[str], replication: int = 2,
                  version: int = 1, seed: int = 0) -> ShardTopology:
    """Standard layout: shard ``s`` lives on hosts ``(s+r) % H`` for
    ``r < replication`` — the same rotation the cube uses for its
    in-process server replicas, one level up."""
    hosts = tuple(hosts)
    replication = min(replication, len(hosts))
    assignments = tuple(
        tuple((s + r) % len(hosts) for r in range(replication))
        for s in range(n_shards))
    return ShardTopology(version, n_shards, hosts, assignments, seed)


class ShardRouter:
    """Atomic topology publication + batch splitting.

    ``publish`` swaps the whole versioned topology object (monotonic
    versions enforced — a stale republish must never roll the mesh back);
    ``split`` routes one signature batch against ONE topology capture."""

    def __init__(self, topology: ShardTopology):
        self._topology = topology
        self._lock = threading.Lock()
        self.publishes = 0

    @property
    def topology(self) -> ShardTopology:
        return self._topology

    def publish(self, topology: ShardTopology) -> ShardTopology:
        with self._lock:
            if topology.version <= self._topology.version:
                raise ValueError(
                    f"topology version must advance: "
                    f"{topology.version} <= {self._topology.version}")
            self._topology = topology
            self.publishes += 1
        return topology

    def split(self, sigs) -> list:
        """Route a signature batch: returns ``[(shard, idx)]`` where
        ``idx`` indexes the input positions owned by ``shard`` (ascending
        shard order; empty shards omitted). One topology capture covers
        the whole batch."""
        topo = self._topology
        sigs = np.atleast_1d(np.asarray(sigs, np.uint64))
        if sigs.size == 0:
            return []
        shard = topo.shard_of(sigs)
        order = np.argsort(shard, kind="stable")
        sorted_shard = shard[order]
        bounds = np.searchsorted(sorted_shard,
                                 np.arange(topo.n_shards + 1))
        out = []
        for s in range(topo.n_shards):
            lo, hi = bounds[s], bounds[s + 1]
            if lo != hi:
                out.append((s, order[lo:hi]))
        return out
