"""The Distributed Sparse Parameter Cube (paper §5.1 + §7).

A distributed KV store for the sparse sub-network:
  * key    — compact feature signature (universal hash; repro.sparse.hashing)
  * value  — model weights (+ feedback statistics) for that sparse feature
  * keys live purely in memory (to hide hash-probe latency); values are
    grouped into ~1 GB blocks placed in MEMORY or DISK (SSD) — a tunable
    latency/hardware trade-off (the "cube cache ratio" knob moves it)
  * sharded over servers by key hash; every block replicated ``replication``
    ways → fault tolerant (server failure reroutes to replicas)
  * generation-stamped (model hot-loading swaps whole generations)

Lookups are **batch-native** (DESIGN.md §3): a request's signatures are
deduplicated once (`np.unique`), grouped by shard with a single argsort,
probed against each server's *sorted signature index* with one
`np.searchsorted`, and each touched block is gathered with a single
fancy-index. Latency is accounted per *block touch* + per *server RPC*,
not per row — batching is exactly what amortizes those costs.

Streaming updates (DESIGN.md §6): the cube is MVCC-versioned. The publish
unit is the WHOLE delta batch (``apply_batch``; ``apply_delta`` is the
single-group convenience): every touched group's upserts land in fresh
in-memory *overlay blocks* (plus tombstone index entries for deletes)
staged under one writer-lock hold, then published by an atomic swap of
the ONE ``(version, sigs, srv, blk, off)`` snapshot tuple — one version
bump covering ALL groups, so a pinned reader provably sees every group of
a multi-group batch at the same version (the DESIGN.md §7.3 cross-group
torn-read window is closed at the cube layer). Blocks are append-only, so
a reader that grabbed the snapshot at entry — or pinned a version with
``pin()`` — keeps reading exactly the state it started on while new
versions publish underneath it. ``compact()`` folds accumulated overlays
back into consolidated base blocks off the hot path — in ONE writer-lock
hold, or incrementally across many short holds with a
``max_rows_per_pass`` budget (DESIGN.md §6.6) so a TB-scale fold never
pauses the writer path for the whole rebuild; superseded blocks are freed
only once no pinned reader can still see them.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.faults.crash import crash_point
from repro_torch.sparse.hashing import signature_np

# serving-tier codes for lookup_ex (DESIGN.md §8.3): the graceful-
# degradation ladder. 2 (stale cache) is assigned by CubeFetchStage —
# the cube itself cannot see the cache tier.
TIER_PRIMARY = 0
TIER_REPLICA = 1
TIER_STALE_CACHE = 2
TIER_DEFAULT = 3


def _merge_last_wins(sigs: np.ndarray, *arrays: np.ndarray):
    """Sort parallel index arrays by signature, resolving duplicate
    signatures to the LAST insertion — THE dedup rule for every cube index
    (primary snapshot, per-server indexes, within-delta dedup). One
    implementation: which copy of a duplicate wins is correctness-critical
    and must never diverge between the folds."""
    order = np.argsort(sigs, kind="stable")
    sigs = sigs[order]
    arrays = tuple(a[order] for a in arrays)
    if sigs.size > 1:
        last = np.ones(sigs.size, bool)
        last[:-1] = sigs[1:] != sigs[:-1]
        sigs = sigs[last]
        arrays = tuple(a[last] for a in arrays)
    return (sigs,) + arrays


@dataclass
class CubeMetrics:
    lookups: int = 0
    mem_block_hits: int = 0      # batched path: distinct mem blocks touched
    disk_block_hits: int = 0     # batched path: distinct disk blocks touched
    failovers: int = 0
    replica_rows: int = 0        # rows served from a replica snapshot
    unavailable_rows: int = 0    # rows no live replica could serve
    simulated_latency_s: float = 0.0
    # streaming-update subsystem
    deltas_applied: int = 0
    rows_upserted: int = 0
    rows_deleted: int = 0
    compactions: int = 0
    compact_passes: int = 0          # writer-lock holds spent compacting
    compact_max_hold_s: float = 0.0  # longest single compaction lock hold
    blocks_freed: int = 0


class _Block:
    """One value block: contiguous (n, dim) array, in RAM or memmapped."""

    def __init__(self, values: np.ndarray, on_disk: bool, tmpdir: str, bid: str):
        self.on_disk = on_disk
        self.path: Optional[str] = None
        if on_disk:
            self.path = os.path.join(tmpdir, f"block_{bid}.npy")
            mm = np.lib.format.open_memmap(self.path, mode="w+",
                                           dtype=values.dtype, shape=values.shape)
            mm[:] = values
            mm.flush()
            self.values = mm
        else:
            self.values = values
        # plain-ndarray view for gathers: same mapped pages for disk blocks,
        # but skips np.memmap's per-__getitem__ subclass machinery
        self.view = np.asarray(self.values)


class _FreedBlock:
    """Sentinel left where a compacted-away block used to be: any access is
    a routing bug (an index referenced a block past its retire version)."""

    on_disk = False

    @property
    def view(self):
        raise RuntimeError("touched a freed (compacted) cube block — "
                           "a reader escaped its version pin")

    values = view


class CubeServer:
    """One shard holder. The key index is three parallel arrays sorted by
    signature — ``sigs`` (uint64), ``blk``/``off`` (block id, row offset) —
    probed with np.searchsorted; no per-key Python dict. The index is held
    as ONE tuple swapped atomically (readers run concurrently with delta
    ingestion from the update thread), with a fold lock serializing merges."""

    def __init__(self, server_id: int, tmpdir: str):
        self.server_id = server_id
        self.tmpdir = tmpdir
        self.blocks: list = []       # _Block | _FreedBlock, append-only slots
        self.alive = True
        # fault-injection dials (repro.faults): per-RPC latency added while
        # a spike is active; multiplier on this server's disk-block latency
        self.extra_latency_s = 0.0
        self.disk_latency_mult = 1.0
        self._index = (np.empty(0, np.uint64), np.empty(0, np.int32),
                       np.empty(0, np.int32))
        self._pending: list[tuple[np.ndarray, int]] = []   # ingested, unsorted
        self._idx_lock = threading.Lock()
        # versioned index snapshots: (version, (sigs, blk, off)) appended by
        # ``publish_version`` at every cube version bump that touched this
        # server. A pinned reader failing over probes the newest snapshot
        # ≤ its pinned version — the DESIGN.md §6.2 exact-failover contract
        # (replica reads are bit-identical to the primary's at that
        # version, never the replica's freshest row). Append-only between
        # prunes; readers capture the list reference lock-free.
        self._snaps: list[tuple[int, tuple]] = [(0, self._index)]
        # slot ids whose blocks were reclaimed: reused by the next ingest
        # so a perpetual delta stream + compaction cadence doesn't grow the
        # block list (and its _FreedBlock sentinels) without bound. Safe:
        # a slot only reaches this list once no pinned snapshot can route
        # to it, and writers (the only add_block/reclaim callers) serialize
        # on the cube's writer lock.
        self.free_slots: list[int] = []
        self._slot_seq = 0          # unique suffix for memmap filenames

    def add_block(self, sigs: np.ndarray, values: np.ndarray, on_disk: bool,
                  index: bool = True) -> int:
        # filename carries the server id — servers share a tmpdir; the
        # sequence number keeps reused slots from colliding on disk
        self._slot_seq += 1
        block = _Block(values, on_disk, self.tmpdir,
                       f"s{self.server_id}_{self._slot_seq}")
        if self.free_slots:
            bid = self.free_slots.pop()
            self.blocks[bid] = block
        else:
            bid = len(self.blocks)
            self.blocks.append(block)
        if index:
            with self._idx_lock:
                self._pending.append((np.asarray(sigs, dtype=np.uint64), bid))
        return bid

    def install_index(self, sigs: np.ndarray, blk: np.ndarray,
                      off: np.ndarray):
        """Replace the whole index (compactor): entries must be dup-free;
        sorts by signature and swaps atomically, dropping any pending."""
        order = np.argsort(sigs, kind="stable")
        with self._idx_lock:
            self._index = (sigs[order], blk[order].astype(np.int32),
                           off[order].astype(np.int32))
            self._pending.clear()

    def _ensure_index(self):
        """Merge pending ingests into the sorted index (lazy: load_table may
        add many blocks back-to-back; sort once at first probe). Returns one
        consistent (sigs, blk, off) tuple."""
        if not self._pending:
            return self._index
        with self._idx_lock:
            if not self._pending:
                return self._index
            isigs, iblk, ioff = self._index
            sigs = np.concatenate([isigs] + [s for s, _ in self._pending])
            blk = np.concatenate([iblk] + [
                np.full(s.size, b, np.int32) for s, b in self._pending])
            off = np.concatenate([ioff] + [
                np.arange(s.size, dtype=np.int32) for s, _ in self._pending])
            # last insertion wins on duplicate signatures, so overlay rows
            # shadow the base rows they supersede.
            # swap BEFORE clearing: a concurrent reader's lock-free fast
            # path is "pending empty → use _index" — clearing first would
            # let it read the PRE-fold index for already-cleared ingests
            self._index = _merge_last_wins(sigs, blk, off)
            self._pending.clear()
            return self._index

    # ------------------------------------------------ versioned snapshots
    def publish_version(self, version: int):
        """Record the server's index as of cube ``version``: folds pending
        ingests and appends a (version, index) snapshot. Called by every
        cube writer at its version bump; appending nothing when the index
        is unchanged keeps the snapshot list proportional to the versions
        that actually touched this server."""
        idx = self._ensure_index()
        with self._idx_lock:
            last_ver, last_idx = self._snaps[-1]
            if last_idx is idx:
                return                         # nothing new landed here
            if last_ver == version:            # same-version re-publish
                self._snaps[-1] = (version, idx)
            else:
                self._snaps.append((version, idx))

    def _index_at(self, version: int) -> tuple:
        """Newest snapshot ≤ ``version`` (lock-free: capture the list
        reference once; publishers only append)."""
        snaps = self._snaps
        lo, hi = 0, len(snaps)
        while lo < hi:
            mid = (lo + hi) // 2
            if snaps[mid][0] <= version:
                lo = mid + 1
            else:
                hi = mid
        if lo == 0:          # pinned before this server's first publish
            return (np.empty(0, np.uint64), np.empty(0, np.int32),
                    np.empty(0, np.int32))
        return snaps[lo - 1][1]

    def prune_snapshots(self, min_version: int):
        """Drop snapshots no pinned reader can reach: keep the newest one
        ≤ ``min_version`` (still the answer for a reader pinned there) and
        everything newer. Writer-driven, like block reclaim."""
        with self._idx_lock:
            snaps = self._snaps
            keep_from = 0
            for i, (ver, _) in enumerate(snaps):
                if ver <= min_version:
                    keep_from = i
                else:
                    break
            if keep_from:
                self._snaps = snaps[keep_from:]

    # ------------------------------------------------------------ probing
    def get(self, sig: int) -> Optional[tuple[np.ndarray, bool]]:
        """Scalar probe (debugging)."""
        sigs, blk_a, off_a = self._ensure_index()
        s = np.uint64(sig)
        pos = int(np.searchsorted(sigs, s))
        if pos >= sigs.size or sigs[pos] != s:
            return None
        blk = self.blocks[int(blk_a[pos])]
        return np.asarray(blk.values[int(off_a[pos])]), blk.on_disk

    def get_batch(self, sigs: np.ndarray, version: Optional[int] = None
                  ) -> tuple[Optional[np.ndarray], np.ndarray, int, int]:
        """Vectorized probe. Returns (rows, found, mem_touches, disk_touches):
        ``found`` is a boolean mask over ``sigs``; ``rows`` holds the values
        of the found signatures in order (one fancy-index gather per touched
        block); touch counts are DISTINCT blocks read, for latency accounting.

        ``version``: resolve against the index snapshot published at the
        newest cube version ≤ it (exact failover for pinned readers);
        None probes the latest index.
        """
        isigs, iblk, ioff = (self._ensure_index() if version is None
                             else self._index_at(version))
        m = sigs.size
        if isigs.size == 0:
            return None, np.zeros(m, bool), 0, 0
        pos = np.searchsorted(isigs, sigs)
        pos = np.minimum(pos, isigs.size - 1)
        found = isigs[pos] == sigs
        if not found.any():
            return None, found, 0, 0
        fpos = pos[found]
        fblk, foff = iblk[fpos], ioff[fpos]
        # group rows by block with one argsort, then slice-gather per block
        order = np.argsort(fblk, kind="stable")
        sblk, soff = fblk[order], foff[order]
        starts = np.concatenate(([0], np.flatnonzero(sblk[1:] != sblk[:-1]) + 1,
                                 [sblk.size]))
        # one probe batch is always single-group (lookup hashes one group),
        # so every touched block shares the first one's row shape — blocks[0]
        # may belong to a DIFFERENT group with another dim/dtype
        first = self.blocks[int(sblk[0])].view
        gathered = np.empty((fpos.size, first.shape[1]), first.dtype)
        mem_t = disk_t = 0
        for lo, hi in zip(starts[:-1], starts[1:]):
            block = self.blocks[int(sblk[lo])]
            gathered[lo:hi] = block.view[soff[lo:hi]]  # one gather per block
            if block.on_disk:
                disk_t += 1
            else:
                mem_t += 1
        rows = np.empty_like(gathered)
        rows[order] = gathered
        return rows, found, mem_t, disk_t


class PinnedVersion:
    """Handle returned by ``ParameterCube.pin()``: every lookup made with it
    sees exactly the cube state published as ``version``, regardless of
    deltas/compactions landing concurrently."""

    __slots__ = ("snap",)

    def __init__(self, snap):
        self.snap = snap

    @property
    def version(self) -> int:
        return self.snap[0]


class ParameterCube:
    """Build from feature-group embedding tables; serve batched lookups;
    ingest streaming delta updates with version-consistent reads."""

    def __init__(self, n_servers: int = 4, replication: int = 2,
                 block_rows: int = 65536, mem_block_fraction: float = 0.5,
                 mem_latency_s: float = 2e-6, disk_latency_s: float = 50e-6,
                 net_latency_s: float = 300e-6, generation: int = 0,
                 tmpdir: Optional[str] = None):
        assert replication <= n_servers
        self.n_servers = n_servers
        self.replication = replication
        self.block_rows = block_rows
        self.mem_block_fraction = mem_block_fraction
        self.lat = {"mem": mem_latency_s, "disk": disk_latency_s,
                    "net": net_latency_s}
        self.generation = generation
        self.tmpdir = tmpdir or tempfile.mkdtemp(prefix="cube_")
        self.servers = [CubeServer(i, self.tmpdir) for i in range(n_servers)]
        self.metrics = CubeMetrics()
        self._dim: Optional[int] = None
        self._dtype = np.float32
        self._shapes: dict[int, tuple[int, np.dtype]] = {}  # per-group row shape
        # cube-wide PRIMARY index: every r=0 placement, sorted by signature.
        # Keys are all-in-memory per the paper, so the router can resolve a
        # whole batch (sig → primary server, block, offset) with ONE
        # searchsorted; replicas are only probed for misses/dead primaries.
        # MVCC: the index is published as ONE (version, sigs, srv, blk, off)
        # tuple swapped atomically — a reader must never see sigs from one
        # version with srv/blk/off from another (that routes to the wrong
        # block — silent corruption), and a version-pinned reader must keep
        # resolving against exactly the tuple it pinned. srv == -1 marks a
        # TOMBSTONE (the signature was deleted by a delta).
        self._snap = (0, np.empty(0, np.uint64), np.empty(0, np.int32),
                      np.empty(0, np.int32), np.empty(0, np.int32))
        self._p_pending: list[tuple[np.ndarray, int, int]] = []
        # RLock: writers (load_table / apply_delta / compact) fold the
        # pending list while already holding the lock
        self._p_lock = threading.RLock()
        # version pinning: version → count of readers inside that version.
        # Compaction retires blocks at a version; a retired block is freed
        # only once min(pinned) reaches its retire version.
        self._pins: dict[int, int] = {}
        self._pin_lock = threading.Lock()
        self._garbage: list[tuple[int, int, int]] = []  # (retire_ver, sid, bid)
        # chunked compaction releases the writer lock BETWEEN passes, so a
        # second compactor could interleave with a half-drained one — this
        # outer lock serializes whole compactions (writers still only wait
        # per-pass: apply_delta/apply_batch never take it)
        self._compact_lock = threading.Lock()
        self.overlay_blocks = 0       # blocks added by deltas since compact()
        # optional circuit-breaker registry (repro.faults.HealthRegistry):
        # when attached, routing consults it before probing a server — an
        # open breaker skips the server without paying the failed probe
        self.health = None

    def attach_health(self, registry):
        """Attach a ``repro.faults.HealthRegistry`` (one breaker per
        server) that routing consults before touching a server."""
        assert len(registry) == self.n_servers
        self.health = registry
        return registry

    # ------------------------------------------------------------- build
    @property
    def version(self) -> int:
        return self._snap[0]

    def row_shape(self, group: int) -> Optional[tuple]:
        """(dim, dtype) of a group's rows, or None if the group is unknown
        — the update manager's pre-apply validation hook."""
        return self._shapes.get(group)

    def _place_shard(self, sid: int, s_sigs: np.ndarray, s_rows: np.ndarray,
                     fresh_index: bool):
        """THE single block-placement implementation (load_table and the
        compactor must never diverge — a floor-vs-ceil mismatch here once
        sent tail blocks to disk at mem_block_fraction=1.0): split one
        primary shard's rows into block_rows-sized blocks, place the first
        mem_block_fraction of them in memory and the rest on disk, and add
        every block to the shard's ``replication`` servers. Returns
        (primary, per_server): ``primary`` = [(blk_sigs, bid)] for the r=0
        copies; ``per_server`` = [(server_id, blk_sigs, bid)] for EVERY
        copy when ``fresh_index`` (the compactor builds indexes from
        scratch; otherwise copies register in each server's pending
        index)."""
        n_blocks = max(1, -(-len(s_sigs) // self.block_rows))   # ceil
        primary, per_server = [], []
        for start in range(0, len(s_sigs), self.block_rows):
            blk_s = s_sigs[start:start + self.block_rows]
            blk_v = s_rows[start:start + self.block_rows]
            on_disk = (start // self.block_rows) >= max(
                1, int(n_blocks * self.mem_block_fraction))
            for r in range(self.replication):
                hsid = (sid + r) % self.n_servers
                bid = self.servers[hsid].add_block(
                    blk_s, blk_v, on_disk, index=not fresh_index)
                if fresh_index:
                    per_server.append((hsid, blk_s, bid))
                if r == 0:
                    primary.append((blk_s, bid))
        return primary, per_server

    def load_table(self, group: int, table: np.ndarray,
                   raw_ids: Optional[np.ndarray] = None):
        """Ingest rows of one feature group. Values are the rows; keys are
        signature(group, row_id)."""
        ids = raw_ids if raw_ids is not None else np.arange(table.shape[0])
        sigs = signature_np(group, ids)
        order = np.argsort(sigs % np.uint64(self.n_servers), kind="stable")
        sigs, rows = sigs[order], table[order]
        shard = (sigs % np.uint64(self.n_servers)).astype(np.int64)
        self._dim, self._dtype = table.shape[1], table.dtype
        self._shapes[group] = (table.shape[1], table.dtype)
        # the WHOLE placement runs under the writer lock: a compact()
        # concurrent with an unlocked load would enumerate the half-placed
        # blocks into its retire list and wipe their replica-index
        # registrations — the folded primary index would then route to
        # blocks the next reclaim frees. (Also: a concurrent index fold
        # iterates and clears _p_pending — an unlocked append could be
        # wiped before ever being folded.)
        with self._p_lock:
            for sid in range(self.n_servers):
                sel = shard == sid
                primary, _ = self._place_shard(sid, sigs[sel], rows[sel],
                                               fresh_index=False)
                for blk_s, bid in primary:
                    self._p_pending.append((blk_s, sid, bid))

    # ------------------------------------------------------------ lookup
    def _ensure_primary_index(self):
        """Fold pending placements into the index and return a consistent
        (version, sigs, srv, blk, off) snapshot. Thread-safe: concurrent
        stage workers serialize on the build lock; the double-check inside
        keeps the common no-pending call lock-free-ish and cheap. Folding
        bumps the version: newly ingested rows become visible only at the
        bumped snapshot, never half-way."""
        if not self._p_pending:
            return self._snap
        with self._p_lock:
            if not self._p_pending:
                return self._snap
            ver, psigs, psrv, pblk, poff = self._snap
            sigs = np.concatenate([psigs] + [s for s, _, _ in self._p_pending])
            srv = np.concatenate([psrv] + [
                np.full(s.size, sid, np.int32) for s, sid, _ in self._p_pending])
            blk = np.concatenate([pblk] + [
                np.full(s.size, b, np.int32) for s, _, b in self._p_pending])
            off = np.concatenate([poff] + [
                np.arange(s.size, dtype=np.int32) for s, _, _ in self._p_pending])
            # publish BEFORE clearing pending: a concurrent reader's
            # lock-free fast path is "pending empty → use _snap"; clearing
            # first opens a window where it reads the PRE-fold snapshot
            # server snapshots FIRST: a reader that pins ver+1 the instant
            # _snap swaps may immediately fail over — the replica index at
            # ver+1 must already exist (at ≤ ver it is unreachable: no
            # reader can pin ver+1 before the swap below)
            for srv_ in self.servers:
                srv_.publish_version(ver + 1)
            self._snap = (ver + 1,) + _merge_last_wins(sigs, srv, blk, off)
            self._p_pending.clear()
            return self._snap

    # ------------------------------------------------------------ pinning
    def _pin_current(self):
        """Atomically (snapshot read + pin registration under ONE _pin_lock
        hold) pin the published version. Reading _snap outside the lock and
        pinning after would race the compactor's garbage collection: it
        could free the snapshot's blocks in the unpinned window."""
        self._ensure_primary_index()          # fold pending placements first
        with self._pin_lock:
            snap = self._snap                 # publishers swap the whole tuple
            self._pins[snap[0]] = self._pins.get(snap[0], 0) + 1
        return snap

    def _pin_release(self, ver: int):
        # NOTE: no garbage collection here — this runs on READER threads
        # (every lookup unpins), and freeing blocks means os.remove plus
        # dirty-memmap flushes: filesystem latency injected straight into
        # the serving path. Writers reclaim instead (apply_delta/compact
        # entry), so deferred garbage is freed within one stream tick.
        with self._pin_lock:
            n = self._pins.get(ver, 0) - 1
            if n <= 0:
                self._pins.pop(ver, None)
            else:
                self._pins[ver] = n

    @contextlib.contextmanager
    def pin(self):
        """Pin the currently published version for a sequence of lookups:
        ``with cube.pin() as v: cube.lookup(g, ids, version=v)`` — every
        lookup inside the block reads the same snapshot even while deltas
        publish and the compactor folds overlays concurrently."""
        snap = self._pin_current()
        try:
            yield PinnedVersion(snap)
        finally:
            self._pin_release(snap[0])

    def lookup(self, group: int, raw_ids: np.ndarray,
               version: Optional[PinnedVersion] = None) -> np.ndarray:
        """Batched gather: (...,) raw ids → (N, dim) rows (inputs are
        flattened; callers reshape). Deduplicates repeated ids before any
        server is touched and re-scatters afterwards, so a dup-heavy batch
        pays each distinct row once. The whole batch is routed with one
        probe of the cube-wide primary index; only misses and signatures on
        dead primaries take the per-server replica path.

        ``version``: a ``pin()`` handle — the lookup resolves against that
        snapshot. Without one, the call pins the current version for its own
        duration (an in-flight lookup never sees a half-published delta or
        loses a block to the compactor mid-gather)."""
        raw = np.atleast_1d(np.asarray(raw_ids)).reshape(-1)
        sigs = signature_np(group, raw)
        n_req = sigs.size
        if n_req == 0:
            dim, dtype = self._shapes.get(group, (self._dim or 0, self._dtype))
            return np.empty((0, dim), dtype)
        if version is not None:
            return self._lookup_pinned(group, sigs, version.snap)
        snap = self._pin_current()
        try:
            return self._lookup_pinned(group, sigs, snap)
        finally:
            self._pin_release(snap[0])

    def lookup_ex(self, group: int, raw_ids: np.ndarray,
                  version: Optional[PinnedVersion] = None
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Degradation-aware batched gather (DESIGN.md §8.3): like
        ``lookup`` but NEVER raises on a fault — returns ``(rows, tiers)``
        where ``tiers[i]`` says how row i was served: ``TIER_PRIMARY``
        (healthy primary, HBM-adjacent, or an authoritative tombstone
        zero), ``TIER_REPLICA`` (versioned failover — bit-identical to the
        primary at the pinned version), or ``TIER_DEFAULT`` (no live
        replica could serve it; the row is zeros and the caller decides
        whether a stale cache entry beats it)."""
        raw = np.atleast_1d(np.asarray(raw_ids)).reshape(-1)
        sigs = signature_np(group, raw)
        if sigs.size == 0:
            dim, dtype = self._shapes.get(group, (self._dim or 0, self._dtype))
            return np.empty((0, dim), dtype), np.empty(0, np.int8)
        if version is not None:
            return self._lookup_pinned_ex(group, sigs, version.snap,
                                          strict=False)
        snap = self._pin_current()
        try:
            return self._lookup_pinned_ex(group, sigs, snap, strict=False)
        finally:
            self._pin_release(snap[0])

    def _alive_mask(self) -> tuple[np.ndarray, float]:
        """Effective server availability for one routing decision, and the
        latency the decision itself cost. Without a health registry this is
        the raw ``alive`` flags for free (the historical behaviour). With
        one, each CLOSED/HALF-OPEN breaker admits a probe — a dead server's
        failed probe costs one net RPC and is recorded (opening the breaker
        after enough failures) — while an OPEN breaker reroutes instantly
        and for free."""
        if self.health is None:
            return np.fromiter((s.alive for s in self.servers), bool,
                               self.n_servers), 0.0
        now = self.health.clock()
        out = np.empty(self.n_servers, bool)
        cost = 0.0
        for i, s in enumerate(self.servers):
            h = self.health.servers[i]
            if not h.allow_request(now):
                out[i] = False               # open breaker: free reroute
            elif s.alive:
                h.record_success(now)
                out[i] = True
            else:
                h.record_failure(now)        # paid probe, found it dead
                out[i] = False
                cost += self.lat["net"]
        return out, cost

    def _lookup_pinned(self, group: int, sigs: np.ndarray, snap) -> np.ndarray:
        return self._lookup_pinned_ex(group, sigs, snap, strict=True)[0]

    def _lookup_pinned_ex(self, group: int, sigs: np.ndarray, snap,
                          strict: bool = True
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Resolve ``sigs`` against one pinned snapshot. Returns
        (rows, tiers) aligned with ``sigs``; tiers are the ladder codes
        (TIER_PRIMARY / TIER_REPLICA / TIER_DEFAULT). ``strict`` keeps the
        historical ``lookup`` contract — KeyError on a deleted or
        unavailable signature; non-strict (``lookup_ex``) zero-fills and
        stamps TIER_DEFAULT instead, so a fetch stage can degrade rather
        than error."""
        _, psigs, psrv, pblk, poff = snap
        n_req = sigs.size
        uniq, inverse = np.unique(sigs, return_inverse=True)
        nu = uniq.size
        dim, dtype = self._shapes.get(group, (self._dim or 0, self._dtype))
        rows = np.empty((nu, dim), dtype)
        tiers = np.zeros(nu, np.int8)
        primary = (uniq % np.uint64(self.n_servers)).astype(np.int64)
        t = 0.0

        # ---- fast path: one searchsorted over the primary index
        alive, probe_cost = self._alive_mask()
        t += probe_cost
        pos = np.searchsorted(psigs, uniq)
        np.minimum(pos, max(0, psigs.size - 1), out=pos)
        found = (psigs[pos] == uniq) if psigs.size else \
            np.zeros(nu, bool)
        # tombstones: deleted signatures are KNOWN-missing at this version —
        # they must not fall through to the replica path (replica indexes
        # still hold the pre-delete row)
        tomb = found & (psrv[pos] == -1) if psigs.size else found
        dead_primary = ~alive[primary]
        if dead_primary.any():
            # failover accounted at batch granularity: every distinct
            # signature rerouted off its dead primary
            self.metrics.failovers += int(dead_primary.sum())
        served = found & ~tomb & ~dead_primary
        sidx = np.flatnonzero(served)
        if sidx.size:
            spos = pos[sidx]
            gsrv, gblk, goff = psrv[spos], pblk[spos], poff[spos]
            # group by (server, block) with one argsort → one fancy-index
            # gather per touched block, one RPC per touched server
            comp = (gsrv.astype(np.int64) << 32) | gblk
            order = np.argsort(comp, kind="stable")
            scomp, soff = comp[order], goff[order]
            starts = np.concatenate(
                ([0], np.flatnonzero(scomp[1:] != scomp[:-1]) + 1,
                 [scomp.size]))
            gathered = np.empty((sidx.size, dim), dtype)
            touched_srv = set()
            mem_t = disk_t = 0
            disk_lat = 0.0
            for lo, hi in zip(starts[:-1], starts[1:]):
                c = int(scomp[lo])
                srv_id, blk_id = c >> 32, c & 0xFFFFFFFF
                block = self.servers[srv_id].blocks[blk_id]
                gathered[lo:hi] = block.view[soff[lo:hi]]
                touched_srv.add(srv_id)
                if block.on_disk:
                    disk_t += 1
                    # slow-disk fault: the owning server's memmap reads
                    # pay a multiplied latency for the fault's duration
                    disk_lat += (self.lat["disk"]
                                 * self.servers[srv_id].disk_latency_mult)
                else:
                    mem_t += 1
            rows[sidx[order]] = gathered
            self.metrics.mem_block_hits += mem_t
            self.metrics.disk_block_hits += disk_t
            t += (len(touched_srv) * self.lat["net"]
                  + mem_t * self.lat["mem"] + disk_lat
                  + sum(self.servers[s].extra_latency_s
                        for s in touched_srv))

        # ---- slow path: replica probing for misses / dead primaries.
        # Replica indexes ARE versioned (the DESIGN.md §6.2 relaxation is
        # closed): the probe resolves against the snapshot published at the
        # pinned version, so a failover read is bit-identical to what the
        # primary would have served at that version — never the replica's
        # fresher row, never a torn or freed one.
        pinned_ver = snap[0]
        pending = np.flatnonzero(~served & ~tomb)
        for r in range(1, self.replication):
            if pending.size == 0:
                break
            srv_of = (primary[pending] + r) % self.n_servers
            order = np.argsort(srv_of, kind="stable")   # group by shard, once
            sp, so = pending[order], srv_of[order]
            bounds = np.searchsorted(so, np.arange(self.n_servers + 1))
            missed: list[np.ndarray] = []
            for sid in range(self.n_servers):
                lo, hi = bounds[sid], bounds[sid + 1]
                if lo == hi:
                    continue
                idxs = sp[lo:hi]
                srv = self.servers[sid]
                if not alive[sid]:
                    missed.append(idxs)
                    continue
                got, fmask, mem_t, disk_t = srv.get_batch(
                    uniq[idxs], version=pinned_ver)
                t += self.lat["net"] + srv.extra_latency_s  # one RPC/server
                if got is not None:
                    rows[idxs[fmask]] = got
                    tiers[idxs[fmask]] = TIER_REPLICA
                    self.metrics.replica_rows += int(fmask.sum())
                self.metrics.mem_block_hits += mem_t
                self.metrics.disk_block_hits += disk_t
                t += (mem_t * self.lat["mem"]
                      + disk_t * self.lat["disk"] * srv.disk_latency_mult)
                if not fmask.all():
                    missed.append(idxs[~fmask])
            pending = (np.concatenate(missed) if missed
                       else np.empty(0, np.int64))
        if pending.size:
            if strict:
                raise KeyError(
                    f"signature {uniq[pending[0]]} unavailable "
                    f"(group {group})")
            rows[pending] = 0
            tiers[pending] = TIER_DEFAULT
            self.metrics.unavailable_rows += int(pending.size)
        if tomb.any():
            if strict:
                raise KeyError(
                    f"signature {uniq[np.flatnonzero(tomb)[0]]} deleted "
                    f"(group {group})")
            # a tombstone is an authoritative answer at this version — the
            # zero row IS the value, not a degradation
            rows[tomb] = 0
        self.metrics.lookups += n_req
        self.metrics.simulated_latency_s += t
        return rows[inverse], tiers[inverse]

    def contains(self, group: int, raw_ids: np.ndarray,
                 version: Optional[PinnedVersion] = None) -> np.ndarray:
        """Vectorized membership against the primary index (tombstones count
        as absent). Used by update tooling to split upserts from inserts."""
        raw = np.atleast_1d(np.asarray(raw_ids)).reshape(-1)
        sigs = signature_np(group, raw)
        snap = version.snap if version is not None \
            else self._ensure_primary_index()
        _, psigs, psrv, _, _ = snap
        if psigs.size == 0:
            return np.zeros(sigs.size, bool)
        pos = np.searchsorted(psigs, sigs)
        np.minimum(pos, psigs.size - 1, out=pos)
        return (psigs[pos] == sigs) & (psrv[pos] != -1)

    # ---------------------------------------------------- streaming deltas
    def apply_delta(self, group: int, raw_ids: Optional[np.ndarray] = None,
                    rows: Optional[np.ndarray] = None,
                    delete_ids: Optional[np.ndarray] = None) -> int:
        """Single-group convenience over :meth:`apply_batch`: one group's
        upserts/deletes published with one atomic version bump."""
        return self.apply_batch([(group, raw_ids, rows, delete_ids)])

    def apply_batch(self, parts) -> int:
        """Apply one delta batch — ``parts`` is an iterable of
        ``(group, raw_ids, rows, delete_ids)`` — and publish ALL of it with
        ONE atomic version bump. This is THE publish unit (DESIGN.md §6.6):
        every group's upserts land in fresh in-memory overlay blocks
        (replicated like base blocks) and deletes become tombstone entries,
        all staged under the writer lock, then the primary snapshot swaps
        once. A reader pinning any version therefore sees every group of
        the batch at that same version — never group g new and group g+1
        old (the former §7.3 cross-group torn-read window). Within one
        batch, a group's deletes apply AFTER its upserts. Returns the newly
        published version. In-flight/pinned readers keep the snapshot they
        started on — nothing is mutated in place."""
        parts = list(parts)
        with self._p_lock:
            self.reclaim()          # writer-side: free drained-pin garbage
            snap = self._ensure_primary_index()
            ver, psigs, psrv, pblk, poff = snap
            # ---- validate EVERY part before placing ANY block: a shape
            # error surfacing after an earlier group placed its overlays
            # would leak replica-probeable blocks for rows that never
            # publish — a torn state the batch API exists to rule out
            norm: list[tuple] = []
            shapes = dict(self._shapes)
            for group, raw_ids, rows, delete_ids in parts:
                ids = vals = dels = None
                if raw_ids is not None and np.asarray(raw_ids).size:
                    ids = np.atleast_1d(np.asarray(raw_ids)).reshape(-1)
                    vals = np.asarray(rows)
                    if vals.ndim != 2 or vals.shape[0] != ids.size:
                        raise ValueError(
                            f"rows shape {vals.shape} does not match "
                            f"{ids.size} upsert ids")
                    dim, dtype = shapes.get(
                        group, (vals.shape[1], vals.dtype))
                    if vals.shape[1] != dim:
                        raise ValueError(
                            f"group {group} rows are dim {dim}, delta has "
                            f"{vals.shape[1]}")
                    shapes[group] = (dim, dtype)
                if delete_ids is not None and np.asarray(delete_ids).size:
                    dels = np.atleast_1d(np.asarray(delete_ids)).reshape(-1)
                norm.append((group, ids, vals, dels))
            # ---- stage: overlay blocks + index entries for every group
            add_sigs: list[np.ndarray] = []
            add_srv: list[np.ndarray] = []
            add_blk: list[np.ndarray] = []
            add_off: list[np.ndarray] = []
            n_up = n_del = 0
            for group, ids, vals, dels in norm:
                if ids is not None:
                    dim, dtype = self._shapes.get(
                        group, (vals.shape[1], vals.dtype))
                    self._shapes[group] = (dim, dtype)
                    if self._dim is None:
                        self._dim, self._dtype = dim, dtype
                    vals = vals.astype(dtype, copy=False)
                    sigs = signature_np(group, ids)
                    shard = (sigs % np.uint64(self.n_servers)) \
                        .astype(np.int64)
                    order = np.argsort(shard, kind="stable")
                    sigs, vals, shard = sigs[order], vals[order], shard[order]
                    bounds = np.searchsorted(shard,
                                             np.arange(self.n_servers + 1))
                    for sid in range(self.n_servers):
                        lo, hi = bounds[sid], bounds[sid + 1]
                        if lo == hi:
                            continue
                        s_sigs, s_rows = sigs[lo:hi], vals[lo:hi]
                        # overlay blocks are memory-resident: fresh rows
                        # are hot
                        for r in range(self.replication):
                            bid = self.servers[(sid + r) % self.n_servers] \
                                .add_block(s_sigs, s_rows, on_disk=False)
                            if r == 0:
                                add_sigs.append(s_sigs)
                                add_srv.append(
                                    np.full(s_sigs.size, sid, np.int32))
                                add_blk.append(
                                    np.full(s_sigs.size, bid, np.int32))
                                add_off.append(
                                    np.arange(s_sigs.size, dtype=np.int32))
                        self.overlay_blocks += self.replication
                    n_up += ids.size
                if dels is not None:
                    d_sigs = signature_np(group, dels)
                    add_sigs.append(d_sigs)
                    add_srv.append(np.full(d_sigs.size, -1, np.int32))
                    add_blk.append(np.full(d_sigs.size, -1, np.int32))
                    add_off.append(np.full(d_sigs.size, -1, np.int32))
                    n_del += dels.size
            if not add_sigs:                       # empty batch: still a bump
                self._snap = (ver + 1, psigs, psrv, pblk, poff)
                self.metrics.deltas_applied += 1
                return ver + 1
            dsigs = np.concatenate(add_sigs)
            dsrv = np.concatenate(add_srv)
            dblk = np.concatenate(add_blk)
            doff = np.concatenate(add_off)
            # last-wins dedup WITHIN the batch (per group, upserts precede
            # tombstones; cross-group signatures never collide by key)
            dsigs, dsrv, dblk, doff = _merge_last_wins(
                dsigs, dsrv, dblk, doff)
            # STREAMING merge into the sorted base: a delta touches a tiny
            # slice of a huge index, so never re-sort the whole thing —
            # copy the base (readers share the old arrays; MVCC forbids
            # in-place), overwrite matched positions, np.insert the rest:
            # O(base memcpy + delta log delta) vs O(base log base)
            if psigs.size:
                pos = np.searchsorted(psigs, dsigs)
                posc = np.minimum(pos, psigs.size - 1)
                match = psigs[posc] == dsigs
                nsigs, nsrv = psigs.copy(), psrv.copy()
                nblk, noff = pblk.copy(), poff.copy()
                if match.any():
                    mp = posc[match]
                    nsrv[mp], nblk[mp], noff[mp] = \
                        dsrv[match], dblk[match], doff[match]
                if not match.all():
                    ins, m = pos[~match], ~match
                    nsigs = np.insert(nsigs, ins, dsigs[m])
                    nsrv = np.insert(nsrv, ins, dsrv[m])
                    nblk = np.insert(nblk, ins, dblk[m])
                    noff = np.insert(noff, ins, doff[m])
            else:
                nsigs, nsrv, nblk, noff = dsigs, dsrv, dblk, doff
            # replica indexes at ver+1 must exist before any reader can pin
            # ver+1 (same ordering rule as _ensure_primary_index)
            for srv_ in self.servers:
                srv_.publish_version(ver + 1)
            self._snap = (ver + 1, nsigs, nsrv, nblk, noff)
            self.metrics.deltas_applied += 1
            self.metrics.rows_upserted += n_up
            self.metrics.rows_deleted += n_del
            return ver + 1

    # ---------------------------------------------------------- compaction
    def compact(self, max_rows_per_pass: Optional[int] = None) -> int:
        """Fold overlay blocks (and tombstones) back into consolidated base
        blocks, off the hot path. ``max_rows_per_pass=None`` is the
        monolithic fold: one writer-lock hold rebuilds every block — fine
        at bench scale, a stop-the-world pause risk at TB scale. With a
        budget, the fold is INCREMENTAL (DESIGN.md §6.6): each pass drains
        whole source blocks up to ~``max_rows_per_pass`` primary rows
        under one short lock hold and publishes its own version bump;
        between passes, pinned readers keep serving and delta batches
        land freely. Either way, every pre-compaction block is retired and
        its storage freed once no reader pins an older version; per-pass
        lock holds are recorded in ``metrics.compact_max_hold_s`` (the
        bench gate for the pause bound). Returns the final published
        version."""
        # serialize whole compactions: chunked mode releases the writer
        # lock between passes, and a second compactor interleaving with a
        # half-drained one would retire each other's fresh blocks
        with self._compact_lock:
            if max_rows_per_pass is None:
                return self._compact_monolithic()
            return self._compact_chunked(max(1, int(max_rows_per_pass)))

    def _hold_finished(self, t0: float):
        """Record one compaction writer-lock hold (call BEFORE release)."""
        hold = time.monotonic() - t0
        self.metrics.compact_passes += 1
        self.metrics.compact_max_hold_s = max(
            self.metrics.compact_max_hold_s, hold)

    def _compact_monolithic(self) -> int:
        """One-pass fold: gather every live row from the current snapshot,
        redistribute into fresh block_rows-sized blocks with the same
        placement policy as load_table, install fresh per-server indexes,
        and publish with a version bump."""
        with self._p_lock:
            t_hold = time.monotonic()
            snap = self._ensure_primary_index()
            ver, psigs, psrv, pblk, poff = snap
            new_ver = ver + 1
            live = psrv >= 0
            lsigs, lsrv = psigs[live], psrv[live]
            lblk, loff = pblk[live], poff[live]
            # group live entries by source block, gather once per block, and
            # bucket rows into (dim, dtype) families — block shapes differ
            # across feature groups and a consolidated block is single-family
            families: dict[tuple, list] = {}
            comp = (lsrv.astype(np.int64) << 32) | lblk
            order = np.argsort(comp, kind="stable")
            scomp, soff, ssigs = comp[order], loff[order], lsigs[order]
            # zero live entries (fresh cube / everything tombstoned):
            # starts collapses to a single bound so the gather loop runs
            # zero times and the cube compacts to empty instead of
            # indexing into an empty array
            starts = np.concatenate(
                ([0], np.flatnonzero(scomp[1:] != scomp[:-1]) + 1,
                 [scomp.size])) if scomp.size else np.array([0])
            for lo, hi in zip(starts[:-1], starts[1:]):
                c = int(scomp[lo])
                block = self.servers[c >> 32].blocks[c & 0xFFFFFFFF]
                fam = (block.view.shape[1], block.view.dtype)
                families.setdefault(fam, []).append(
                    (ssigs[lo:hi], block.view[soff[lo:hi]]))
            # retire EVERY current block slot (old base + overlays) — except
            # slots a previous compact already queued while a pin held them:
            # re-adding those would double-free and double-count blocks_freed
            with self._pin_lock:
                already = {(s, b) for _, s, b in self._garbage}
            retired = [(sid, bid)
                       for sid, srv_ in enumerate(self.servers)
                       for bid, b in enumerate(srv_.blocks)
                       if isinstance(b, _Block) and (sid, bid) not in already]
            new_entries: list[tuple[np.ndarray, int, int]] = []
            per_server: dict[int, list] = {s: [] for s in range(self.n_servers)}
            for (dim, dtype), parts in families.items():
                fsigs = np.concatenate([p[0] for p in parts])
                frows = np.concatenate([p[1] for p in parts])
                shard = (fsigs % np.uint64(self.n_servers)).astype(np.int64)
                order = np.argsort(shard, kind="stable")
                fsigs, frows, shard = fsigs[order], frows[order], shard[order]
                bounds = np.searchsorted(shard,
                                         np.arange(self.n_servers + 1))
                for sid in range(self.n_servers):
                    lo, hi = bounds[sid], bounds[sid + 1]
                    if lo == hi:
                        continue
                    primary, per_srv = self._place_shard(
                        sid, fsigs[lo:hi], frows[lo:hi], fresh_index=True)
                    for blk_s, bid in primary:
                        new_entries.append((blk_s, sid, bid))
                    for hsid, blk_s, bid in per_srv:
                        per_server[hsid].append(
                            (blk_s, np.full(blk_s.size, bid, np.int32),
                             np.arange(blk_s.size, dtype=np.int32)))
            # install fresh per-server indexes referencing ONLY new blocks —
            # no stale entry can ever route a replica probe to a freed block
            for sid, parts in per_server.items():
                if parts:
                    self.servers[sid].install_index(
                        np.concatenate([p[0] for p in parts]),
                        np.concatenate([p[1] for p in parts]),
                        np.concatenate([p[2] for p in parts]))
                else:
                    self.servers[sid].install_index(
                        np.empty(0, np.uint64), np.empty(0, np.int32),
                        np.empty(0, np.int32))
            # snapshot the fresh replica indexes at new_ver before the
            # primary swap makes new_ver pinnable; older snapshots stay
            # for readers still pinned behind the compaction
            for srv_ in self.servers:
                srv_.publish_version(new_ver)
            if new_entries:
                nsigs = np.concatenate([s for s, _, _ in new_entries])
                nsrv = np.concatenate([
                    np.full(s.size, sid, np.int32)
                    for s, sid, _ in new_entries])
                nblk = np.concatenate([
                    np.full(s.size, b, np.int32) for s, _, b in new_entries])
                noff = np.concatenate([
                    np.arange(s.size, dtype=np.int32)
                    for s, _, _ in new_entries])
                self._snap = (new_ver,) + _merge_last_wins(
                    nsigs, nsrv, nblk, noff)
            else:
                self._snap = (new_ver, np.empty(0, np.uint64),
                              np.empty(0, np.int32), np.empty(0, np.int32),
                              np.empty(0, np.int32))
            with self._pin_lock:
                self._garbage.extend(
                    (new_ver, sid, bid) for sid, bid in retired)
            self.overlay_blocks = 0
            self.metrics.compactions += 1
            # reclaim under the writer lock (RLock): slot reuse must not
            # race a concurrent writer's add_block
            self.reclaim()
            self._hold_finished(t_hold)
        return new_ver

    def _compact_chunked(self, max_rows_per_pass: int) -> int:
        """Incremental fold. Plan: snapshot the set of pre-compaction
        blocks once; each pass re-homes the live primary entries of a few
        source blocks (≈``max_rows_per_pass`` rows, always ≥1 whole block)
        into fresh consolidated blocks and re-points the primary snapshot
        at them — the rows are bit-identical, so a reader pinned at ANY
        intermediate version reads the same values whichever copy its
        index routes to. The final pass rebuilds each server's index
        without entries routing to pre-compaction blocks, drops tombstones
        whose pre-delete rows no index can reach any more, retires every
        pre-compaction block, and publishes. Overlay blocks created by
        deltas landing BETWEEN passes are left for the next compaction —
        they are not in the plan's retire set."""
        with self._p_lock:
            self._ensure_primary_index()
            with self._pin_lock:
                already = {(s, b) for _, s, b in self._garbage}
            # every live block right now — old base + overlays, replica
            # copies included — is the retire set; (sid, bid) identifies
            # a copy, and sid<<32|bid matches the primary's routing code
            initial = {(sid, bid)
                       for sid, srv_ in enumerate(self.servers)
                       for bid, b in enumerate(srv_.blocks)
                       if isinstance(b, _Block) and (sid, bid) not in already}
            init_codes = np.sort(np.fromiter(
                ((sid << 32) | bid for sid, bid in initial),
                np.int64, len(initial))) if initial else np.empty(0, np.int64)
            overlay_start = self.overlay_blocks

        while True:
            # recovery-drill abort boundary (DESIGN.md §9): a crash here —
            # after some passes re-homed rows and published intermediate
            # versions — loses only IN-MEMORY state; compaction never
            # touches the durable snapshot/delta artifacts, so a restarted
            # node replays the same deltas onto uncompacted blocks and
            # serves the identical rows
            crash_point("cube.compact_pass")
            with self._p_lock:
                t_hold = time.monotonic()
                ver, psigs, psrv, pblk, poff = self._ensure_primary_index()
                live = psrv >= 0
                comp = np.where(
                    live, (psrv.astype(np.int64) << 32) | pblk, -1)
                in_src = np.isin(comp, init_codes) if init_codes.size \
                    else np.zeros(comp.shape, bool)
                if not in_src.any():
                    final_ver = self._compact_finish(
                        ver, psigs, psrv, pblk, poff, initial, overlay_start)
                    self._hold_finished(t_hold)
                    return final_ver
                # group the remaining source entries by source block and
                # drain whole blocks until the pass budget is spent
                spos = np.flatnonzero(in_src)
                order = np.argsort(comp[spos], kind="stable")
                spos = spos[order]
                scomp = comp[spos]
                starts = np.concatenate(
                    ([0], np.flatnonzero(scomp[1:] != scomp[:-1]) + 1,
                     [scomp.size]))
                take = 1
                while (take < starts.size - 1
                       and starts[take] < max_rows_per_pass):
                    take += 1
                chosen = spos[:starts[take]]
                cstarts = starts[:take + 1]
                # gather the chosen entries once per source block, bucketed
                # into (dim, dtype) families — consolidated blocks are
                # single-family (block shapes differ across feature groups)
                families: dict[tuple, list] = {}
                ccomp, csigs, coff = comp[chosen], psigs[chosen], poff[chosen]
                for lo, hi in zip(cstarts[:-1], cstarts[1:]):
                    c = int(ccomp[lo])
                    block = self.servers[c >> 32].blocks[c & 0xFFFFFFFF]
                    fam = (block.view.shape[1], block.view.dtype)
                    families.setdefault(fam, []).append(
                        (csigs[lo:hi], block.view[coff[lo:hi]]))
                # re-place per family; fresh_index=False registers every
                # copy in its server's pending index, so replica failover
                # at this pass's version resolves the moved rows
                moved: list[tuple[np.ndarray, int, int]] = []
                for (dim, dtype), parts in families.items():
                    fsigs = np.concatenate([p[0] for p in parts])
                    frows = np.concatenate([p[1] for p in parts])
                    shard = (fsigs % np.uint64(self.n_servers)) \
                        .astype(np.int64)
                    order = np.argsort(shard, kind="stable")
                    fsigs, frows, shard = (fsigs[order], frows[order],
                                           shard[order])
                    bounds = np.searchsorted(
                        shard, np.arange(self.n_servers + 1))
                    for sid in range(self.n_servers):
                        lo, hi = bounds[sid], bounds[sid + 1]
                        if lo == hi:
                            continue
                        primary, _ = self._place_shard(
                            sid, fsigs[lo:hi], frows[lo:hi],
                            fresh_index=False)
                        moved.extend((blk_s, sid, bid)
                                     for blk_s, bid in primary)
                # re-point the drained entries: their sigs are unchanged,
                # so this is a pure overwrite of copied routing arrays
                msigs = np.concatenate([s for s, _, _ in moved])
                msrv = np.concatenate([np.full(s.size, sid, np.int32)
                                       for s, sid, _ in moved])
                mblk = np.concatenate([np.full(s.size, b, np.int32)
                                       for s, _, b in moved])
                moff = np.concatenate([np.arange(s.size, dtype=np.int32)
                                       for s, _, _ in moved])
                morder = np.argsort(msigs, kind="stable")
                msigs = msigs[morder]
                pos = np.searchsorted(psigs, msigs)
                nsrv, nblk, noff = psrv.copy(), pblk.copy(), poff.copy()
                nsrv[pos] = msrv[morder]
                nblk[pos] = mblk[morder]
                noff[pos] = moff[morder]
                for srv_ in self.servers:
                    srv_.publish_version(ver + 1)
                self._snap = (ver + 1, psigs, nsrv, nblk, noff)
                self._hold_finished(t_hold)
            # lock released: readers pin, deltas land, then the next pass

    def _compact_finish(self, ver, psigs, psrv, pblk, poff,
                        initial: set, overlay_start: int) -> int:
        """Last chunked pass (caller holds the writer lock, no source
        entries left): rebuild per-server indexes without retired routes,
        clear unreachable tombstones, retire the plan's blocks, publish."""
        new_ver = ver + 1
        retired_by_sid: dict[int, set] = {}
        for sid, bid in initial:
            retired_by_sid.setdefault(sid, set()).add(bid)
        # install each server's folded index minus entries routing to a
        # block this compaction retires — after this, no replica probe at
        # ≥ new_ver can reach a pre-compaction block (older pinned
        # versions keep their snapshots, and their blocks stay allocated
        # until those pins drain)
        for sid, srv_ in enumerate(self.servers):
            isigs, iblk, ioff = srv_._ensure_index()
            dead = retired_by_sid.get(sid)
            if dead and isigs.size:
                keep = ~np.isin(iblk, np.fromiter(dead, np.int64, len(dead)))
                isigs, iblk, ioff = isigs[keep], iblk[keep], ioff[keep]
            srv_.install_index(isigs, iblk, ioff)
        # a tombstone must survive as long as ANY server's current index
        # still holds the pre-delete row (dropping it early would let the
        # replica path resurrect the deleted value); after the filter
        # above, that is exactly "the sig still appears in some index" —
        # e.g. a concurrent delta upserted-then-re-deleted it, leaving the
        # row in a fresh overlay block this compaction does not retire
        tomb = psrv == -1
        if tomb.any():
            tsigs = psigs[tomb]
            reachable = np.zeros(tsigs.size, bool)
            for srv_ in self.servers:
                isigs = srv_._index[0]
                if isigs.size:
                    pos = np.searchsorted(isigs, tsigs)
                    pos = np.minimum(pos, isigs.size - 1)
                    reachable |= isigs[pos] == tsigs
            drop = tomb.copy()
            drop[tomb] = ~reachable
            if drop.any():
                keep = ~drop
                psigs, psrv = psigs[keep], psrv[keep]
                pblk, poff = pblk[keep], poff[keep]
        for srv_ in self.servers:
            srv_.publish_version(new_ver)
        self._snap = (new_ver, psigs, psrv, pblk, poff)
        with self._pin_lock:
            self._garbage.extend((new_ver, sid, bid) for sid, bid in initial)
        self.overlay_blocks = max(0, self.overlay_blocks - overlay_start)
        self.metrics.compactions += 1
        self.reclaim()
        return new_ver

    def reclaim(self):
        """Free retired blocks no pinned reader can still reference: a block
        retired at version v is reachable only through snapshots < v, so it
        frees once every active pin is ≥ v. Called from writer paths (and
        available to maintenance loops) — never from readers, whose unpin
        must stay free of filesystem work."""
        freed = []
        with self._pin_lock:
            min_pinned = min(self._pins) if self._pins else self._snap[0]
            keep = []
            for retire_ver, sid, bid in self._garbage:
                if min_pinned >= retire_ver:
                    freed.append((sid, bid))
                else:
                    keep.append((retire_ver, sid, bid))
            self._garbage = keep
        # versioned replica snapshots age out with the same min-pin rule
        # as retired blocks (writer-driven; readers never prune)
        for srv in self.servers:
            srv.prune_snapshots(min_pinned)
        for sid, bid in freed:
            block = self.servers[sid].blocks[bid]
            if not isinstance(block, _Block):
                continue                      # defensively skip double-frees
            self.servers[sid].blocks[bid] = _FreedBlock()
            self.servers[sid].free_slots.append(bid)
            if getattr(block, "path", None):
                try:
                    os.remove(block.path)
                except OSError:
                    pass
            self.metrics.blocks_freed += 1

    # ----------------------------------------------------- fault injection
    def kill_server(self, sid: int):
        self.servers[sid].alive = False

    def revive_server(self, sid: int):
        self.servers[sid].alive = True
