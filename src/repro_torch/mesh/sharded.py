"""MeshCube: the parameter cube partitioned across simulated hosts
(DESIGN.md §11.3).

One :class:`MeshCube` owns N :class:`~repro.core.cube.ParameterCube`
shards, a :class:`~repro.mesh.topology.ShardRouter`, and a
:class:`~repro.mesh.transport.ShardClient` over H :class:`ShardHost`
endpoints. It duck-types the exact cube surface `CubeFetchStage` and
`UpdateManager` consume — ``pin()`` / ``lookup`` / ``lookup_ex`` /
``contains`` / ``version`` / ``row_shape`` / ``apply_batch`` /
``load_table`` / ``overlay_blocks`` / ``compact`` — so the whole serving
and update plane runs against a mesh unchanged.

**Cross-shard pin semantics.** The single-host cube's batch-atomicity
(§6.6) comes from swapping ONE snapshot tuple. The mesh extends that
with a refcounted :class:`_MeshRecord`: at every mesh publish the writer
captures a pin of EVERY shard (each shard's own `pin()` discipline) and
swaps the record atomically. A reader pins the record, not the shards —
so one mesh pin yields a frozen cross-shard frontier: every shard read
resolves at exactly the shard version captured by one publish. A delta
batch is applied to all owning shards FIRST, and only then does the
topology-visible mesh version bump — no reader can observe group g's
rows on shard A new and group h's rows on shard B old from the same
batch. Retired records release their shard pins when the last reader
drains, letting each shard's compactor reclaim as usual.

**Data vs control plane.** Row reads (`lookup`/`lookup_ex`) cross the
ShardClient transport boundary — they pay host faults, hedging, and
failover. Membership probes (`contains`) resolve against the shard
primary indexes directly: per the paper the key index is all-in-memory
and replicated to routers, so membership is a local metadata check (and
a dead host must degrade DATA reads to `TIER_DEFAULT`, never flip
membership to "absent", which would turn outage zeros into authoritative
tombstones).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np

from repro_torch.core.cube import (TIER_DEFAULT, ParameterCube, PinnedVersion)
from repro_torch.sparse.hashing import signature_np

from .topology import ShardRouter, ShardTopology, make_topology
from .transport import ShardClient, ShardHost

__all__ = ["MeshCube", "_MeshRecord"]


class _MeshRecord:
    """One published cross-shard frontier: the mesh version plus a live
    pin on every shard at the versions captured together. Indexable at
    ``[0]`` (the version) so `UpdateManager.pinned_capture`'s
    ``PinnedVersion(snap)`` / ``snap[0]`` contract holds verbatim."""

    __slots__ = ("version", "shard_pins", "shard_versions", "_stack",
                 "refs", "closed")

    def __init__(self, version: int, shard_pins: list,
                 stack: contextlib.ExitStack):
        self.version = version
        self.shard_pins = shard_pins          # per-shard PinnedVersion
        self.shard_versions = tuple(p.version for p in shard_pins)
        self._stack = stack
        self.refs = 0
        self.closed = False

    def __getitem__(self, i: int) -> int:
        if i == 0:
            return self.version
        raise IndexError(i)

    def close(self):
        if not self.closed:
            self.closed = True
            self._stack.close()               # releases every shard pin


class MeshCube:
    """Sharded, host-distributed parameter cube behind the cube API."""

    is_mesh = True

    def __init__(self, n_shards: int = 4, n_hosts: int = 4,
                 replication: int = 2, seed: int = 0,
                 hedge_after_s: Optional[float] = None,
                 wall_latency: bool = False, host_workers: int = 2,
                 n_servers: int = 2, cube_replication: int = 2,
                 block_rows: int = 65536, **cube_kwargs):
        self.n_shards = n_shards
        self.shards = [ParameterCube(n_servers=n_servers,
                                     replication=cube_replication,
                                     block_rows=block_rows, **cube_kwargs)
                       for _ in range(n_shards)]
        host_ids = tuple(f"host{h}" for h in range(n_hosts))
        self.hosts = {hid: ShardHost(hid, n_workers=host_workers,
                                     wall_latency=wall_latency)
                      for hid in host_ids}
        self.host_list = [self.hosts[hid] for hid in host_ids]
        self.router = ShardRouter(make_topology(
            n_shards, host_ids, replication=replication, seed=seed))
        self.health = None
        self.client = ShardClient(self.hosts, self.router, health=None,
                                  hedge_after_s=hedge_after_s)
        self._shapes: dict[int, tuple] = {}
        self._w_lock = threading.RLock()      # serializes mesh mutations
        self._pin_lock = threading.Lock()
        self._records: dict[int, _MeshRecord] = {}
        self._record = self._capture(0)
        self._records[0] = self._record
        self.publishes = 0
        # per-shard data-plane counters (metrics collectors read these)
        self.shard_stats = [{"calls": 0, "rows": 0, "degraded_rows": 0}
                            for _ in range(n_shards)]
        self._fanout = threading.local()

    # ----------------------------------------------------------- publish
    def _capture(self, version: int) -> _MeshRecord:
        stack = contextlib.ExitStack()
        pins = [stack.enter_context(s.pin()) for s in self.shards]
        return _MeshRecord(version, pins, stack)

    def _republish(self) -> int:
        """Swap in a fresh cross-shard frontier. Called after every mesh
        mutation, with all shard-local publishes already complete — the
        §6.6 extension: the delta is on every owning shard before the
        topology-visible version bumps."""
        with self._w_lock:
            new = self._capture(self._record.version + 1)
            with self._pin_lock:
                old = self._record
                self._record = new
                self._records[new.version] = new
                if old.refs <= 0:
                    self._records.pop(old.version, None)
                    old.close()
            self.publishes += 1
            return new.version

    # --------------------------------------------------------------- pin
    @property
    def version(self) -> int:
        return self._record.version

    def _pin_current(self):
        with self._pin_lock:
            rec = self._record
            rec.refs += 1
        return rec

    def _pin_release(self, ver: int):
        with self._pin_lock:
            rec = self._records.get(ver)
            if rec is None:
                return
            rec.refs -= 1
            if rec.refs <= 0 and rec is not self._record:
                self._records.pop(ver, None)
                rec.close()

    @contextlib.contextmanager
    def pin(self):
        """Pin the published cross-shard frontier: every shard lookup made
        with the handle resolves at the shard versions captured by ONE
        mesh publish, while deltas/failovers land concurrently."""
        rec = self._pin_current()
        try:
            yield PinnedVersion(rec)
        finally:
            self._pin_release(rec.version)

    @staticmethod
    def _rec_of(version) -> Optional[_MeshRecord]:
        return version.snap if version is not None else None

    # ------------------------------------------------------------- reads
    def row_shape(self, group: int) -> Optional[tuple]:
        return self._shapes.get(group)

    def _take_fanout_sink(self) -> list:
        sink = getattr(self._fanout, "records", None)
        if sink is None:
            sink = self._fanout.records = []
        return sink

    def take_fanout(self) -> list:
        """Drain this thread's per-shard fan-out records (appended by the
        last `lookup_ex` on this thread) — the fetch stage turns them into
        ``shard_fetch`` child spans."""
        sink = self._take_fanout_sink()
        out, sink[:] = list(sink), []
        return out

    def lookup_ex(self, group: int, raw_ids,
                  version: Optional[PinnedVersion] = None):
        """Scatter/gather degradation-aware read. Sub-batches fan out to
        the owning shards' hosts concurrently; each travels with that
        shard's pin from the mesh record, so the merged batch is one
        consistent cross-shard frontier. A shard with no live host
        degrades to zeros + ``TIER_DEFAULT`` (the §8 ladder), never an
        error."""
        raw = np.atleast_1d(np.asarray(raw_ids)).reshape(-1)
        rec = self._rec_of(version)
        self_pinned = rec is None
        if self_pinned:
            rec = self._pin_current()
        try:
            dim, dtype = self._shapes.get(group, (0, np.float32))
            if raw.size == 0:
                return (np.empty((0, dim), dtype), np.empty(0, np.int8))
            sigs = signature_np(group, raw)
            parts = self.router.split(sigs)
            calls = []
            for s, idx in parts:
                shard, pin = self.shards[s], rec.shard_pins[s]
                calls.append((s, (lambda sh=shard, ids=raw[idx], pv=pin:
                                  sh.lookup_ex(group, ids, version=pv))))
            results = self.client.scatter(calls)
            rows = np.zeros((raw.size, dim), dtype)
            tiers = np.full(raw.size, TIER_DEFAULT, np.int8)
            sink = self._take_fanout_sink()
            for (s, idx), (_s, out, meta) in zip(parts, results):
                st = self.shard_stats[s]
                st["calls"] += 1
                st["rows"] += int(idx.size)
                if out is None:          # every host down: stay degraded
                    st["degraded_rows"] += int(idx.size)
                else:
                    r, t = out
                    rows[idx] = r
                    tiers[idx] = t
                sink.append({"shard": s, "host": meta.get("host"),
                             "n_keys": int(idx.size),
                             "hedged": bool(meta.get("hedged")),
                             "failed": bool(meta.get("failed")),
                             "t0": meta["t0"], "t1": meta["t1"]})
            return rows, tiers
        finally:
            if self_pinned:
                self._pin_release(rec.version)

    def lookup(self, group: int, raw_ids,
               version: Optional[PinnedVersion] = None) -> np.ndarray:
        rows, _ = self.lookup_ex(group, raw_ids, version=version)
        return rows

    def contains(self, group: int, raw_ids,
                 version: Optional[PinnedVersion] = None) -> np.ndarray:
        """Local metadata probe against each owning shard's primary index
        at the pinned frontier (see module docstring for why this does
        not cross the transport)."""
        raw = np.atleast_1d(np.asarray(raw_ids)).reshape(-1)
        rec = self._rec_of(version)
        self_pinned = rec is None
        if self_pinned:
            rec = self._pin_current()
        try:
            out = np.zeros(raw.size, bool)
            if raw.size == 0:
                return out
            for s, idx in self.router.split(signature_np(group, raw)):
                out[idx] = self.shards[s].contains(
                    group, raw[idx], version=rec.shard_pins[s])
            return out
        finally:
            if self_pinned:
                self._pin_release(rec.version)

    # ------------------------------------------------------------ writes
    def load_table(self, group: int, table: np.ndarray,
                   raw_ids: Optional[np.ndarray] = None) -> int:
        table = np.asarray(table)
        ids = np.asarray(raw_ids) if raw_ids is not None \
            else np.arange(table.shape[0])
        ids = np.atleast_1d(ids).reshape(-1)
        with self._w_lock:
            self._shapes[group] = (table.shape[1], table.dtype)
            for s, idx in self.router.split(signature_np(group, ids)):
                self.shards[s].load_table(group, table[idx],
                                          raw_ids=ids[idx])
            return self._republish()

    def apply_batch(self, parts) -> int:
        """Split one delta batch per owning shard, apply every shard-local
        batch (each its own §6.6 atomic shard publish), THEN bump the
        mesh version with one record swap — readers pinning the old
        record keep the whole old frontier; readers pinning the new one
        see the whole batch on every shard."""
        parts = list(parts)
        with self._w_lock:
            shapes = dict(self._shapes)
            norm = []
            for group, raw_ids, rows, delete_ids in parts:
                ids = vals = dels = None
                if raw_ids is not None and np.asarray(raw_ids).size:
                    ids = np.atleast_1d(np.asarray(raw_ids)).reshape(-1)
                    vals = np.asarray(rows)
                    if vals.ndim != 2 or vals.shape[0] != ids.size:
                        raise ValueError(
                            f"rows shape {vals.shape} does not match "
                            f"{ids.size} upsert ids")
                    dim, dtype = shapes.get(group,
                                            (vals.shape[1], vals.dtype))
                    if vals.shape[1] != dim:
                        raise ValueError(
                            f"group {group} rows are dim {dim}, delta has "
                            f"{vals.shape[1]}")
                    shapes[group] = (dim, dtype)
                if delete_ids is not None and np.asarray(delete_ids).size:
                    dels = np.atleast_1d(np.asarray(delete_ids)).reshape(-1)
                norm.append((group, ids, vals, dels))
            shard_parts: dict[int, list] = {}
            for group, ids, vals, dels in norm:
                per_shard: dict[int, list] = {}
                if ids is not None:
                    for s, idx in self.router.split(
                            signature_np(group, ids)):
                        per_shard.setdefault(s, [None, None])[0] = \
                            (ids[idx], vals[idx])
                if dels is not None:
                    for s, idx in self.router.split(
                            signature_np(group, dels)):
                        per_shard.setdefault(s, [None, None])[1] = dels[idx]
                for s, (up, dl) in per_shard.items():
                    u_ids, u_rows = up if up is not None else (None, None)
                    shard_parts.setdefault(s, []).append(
                        (group, u_ids, u_rows, dl))
            for s, sp in sorted(shard_parts.items()):
                self.shards[s].apply_batch(sp)
            self._shapes = shapes
            return self._republish()

    def apply_delta(self, group: int, raw_ids=None, rows=None,
                    delete_ids=None) -> int:
        return self.apply_batch([(group, raw_ids, rows, delete_ids)])

    # ------------------------------------------------------- maintenance
    @property
    def overlay_blocks(self) -> int:
        return sum(s.overlay_blocks for s in self.shards)

    def compact(self, max_rows_per_pass: Optional[int] = None) -> int:
        with self._w_lock:
            total = sum(s.compact(max_rows_per_pass=max_rows_per_pass)
                        for s in self.shards)
            self._republish()
            return total

    def reclaim(self):
        for s in self.shards:
            with s._p_lock:
                s.reclaim()

    # ------------------------------------------------------ fleet control
    def attach_health(self, registry):
        """Attach a ``(host, shard)``-keyed HealthRegistry the transport
        consults before probing a host (one dead host = one strike
        fleet-wide via ``record_host_failure``)."""
        self.health = registry
        self.client.health = registry
        return registry

    def kill_host(self, host_id: str):
        self.hosts[host_id].alive = False

    def revive_host(self, host_id: str):
        self.hosts[host_id].alive = True

    def fail_over(self, host_id: str) -> ShardTopology:
        """Control-plane failover: republish the topology with the dead
        host demoted to the back of every preference list. The
        signature→shard mapping is untouched — no keys move, no reader
        re-pins."""
        return self.router.publish(
            self.router.topology.with_host_down(host_id))

    def shutdown(self):
        self.client.shutdown()
