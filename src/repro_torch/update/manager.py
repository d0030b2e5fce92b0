"""UpdateManager: one delta batch in, every storage/cache layer coherent
out (DESIGN.md §6).

Apply order per batch — chosen so no reader can observe a NEW cache entry
over OLD cube rows, or OLD cache rows attributed to a NEW version. Every
step runs at BATCH granularity (all groups together, DESIGN.md §6.6):

  1. caches      — targeted ``invalidate_keys`` / ``invalidate_items`` of
                   exactly the touched keys/items of EVERY group, BEFORE
                   the publish (LFU counts persist);
  2. cube        — ``ParameterCube.apply_batch`` publishes ALL groups'
                   rows with ONE atomic version bump (pinned/in-flight
                   readers keep their snapshot — and a pin taken at any
                   instant sees every group at the same version);
  3. HBM head    — in-place donated-buffer scatter for the touched
                   signatures currently resident; deletes demote;
  4. caches      — the same targeted invalidation AGAIN, post-publish.

The double invalidation brackets the publish: pass 1 closes the window
where a reader pinning the new version could cache-hit a not-yet-
invalidated pre-delta row (old rows stamped with the new version — torn
attribution); pass 4 plus the serving ops' cache-aside guards remove any
entry a racing reader re-inserted around the publish itself. A request
racing the apply therefore either reads the old rows coherently (old
cache + old pinned version) or misses and refetches; it can never
cache-hit its way to a torn mix. Because the bracket spans the WHOLE
batch, the per-version touched-key log carries one entry per batch —
the serving ops' guards see all groups' touched keys under the single
published version, matching the cube's batch-atomic swap.

The manager is also the DoubleBuffer ``on_swap`` subscriber: a whole-
generation hot swap bumps the caches' model version — the fix for the
latent staleness bug where a swap kept serving the previous generation's
scores out of the query cache for up to its TTL window.

``rebalance`` runs the frequency-driven tier migration: cube-cache LFU
counts → ``PromoteDemotePolicy`` → head promote/demote, rows sourced from
the cube tail. ``maybe_compact`` folds cube overlay blocks back into base
blocks once they pile past a threshold. Both belong OFF the request path
(the serving loop calls them from the update thread).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.update.delta import DeltaBatch
from repro_torch.update.policy import (PromoteDemotePolicy, merged_lfu_counts,
                                 slice_group_counts)


@dataclass
class UpdateStats:
    deltas_applied: int = 0
    deltas_skipped: int = 0        # stale/duplicate versions (replay)
    rows_upserted: int = 0
    rows_deleted: int = 0
    head_rows_updated: int = 0
    cube_keys_invalidated: int = 0
    query_entries_invalidated: int = 0
    promotions: int = 0
    demotions: int = 0
    compactions: int = 0
    generation_swaps: int = 0
    last_version: int = -1
    # apply/compaction timings (obs registry: jizhi_update_stats{...})
    apply_s_total: float = 0.0     # cumulative wall time under the apply lock
    apply_s_last: float = 0.0      # duration of the most recent apply
    compact_s_total: float = 0.0   # cumulative compaction wall time
    compact_s_last: float = 0.0    # duration of the most recent compaction


def _default_cache_key_fn(group: int, ids: np.ndarray):
    """Cube-cache keys for a group's raw ids. The serving stack keys its
    cube cache by the bare (hashed) id for the primary group and by
    (group, id) otherwise — override per deployment."""
    if group == 0:
        return [int(i) for i in ids]
    return [(group, int(i)) for i in ids]


class UpdateManager:
    def __init__(self, cube, cube_cache=None, query_cache=None, head=None,
                 policy: Optional[PromoteDemotePolicy] = None,
                 policies: Optional[dict] = None,
                 cache_key_fn: Callable = _default_cache_key_fn,
                 qcache_items_fn: Optional[Callable] = None,
                 compact_after_blocks: int = 256,
                 compact_max_rows_per_pass: Optional[int] = None,
                 swap_invalidates_cube_cache: bool = False):
        self.cube = cube
        self.cube_cache = cube_cache
        self.query_cache = query_cache
        self.head = head
        self.policy = policy
        # per-group promote/demote policies (multi-scenario substrates
        # split the head budget across groups); ``policy`` stays as the
        # single-group default when a group has no dedicated entry
        self.policies: dict = dict(policies or {})
        self.cache_key_fn = cache_key_fn
        # (group, touched cube ids) → the RAW item keys the query cache is
        # scored under. When the cube id space is a hash of the item space
        # (the serving stack), the deployment must supply the reverse
        # mapping — falling back to GroupDelta.item_ids / the cube ids
        # themselves is only correct when the two spaces coincide.
        self.qcache_items_fn = qcache_items_fn
        self.compact_after_blocks = compact_after_blocks
        # None → monolithic one-pass compaction; an int bounds the rows
        # moved per writer-lock hold (incremental compaction, DESIGN.md
        # §6.6) so maybe_compact never stalls concurrent delta appliers
        # or reader pin churn for a full-rebuild pause
        self.compact_max_rows_per_pass = compact_max_rows_per_pass
        # a dense-generation hot swap does NOT change cube rows (those only
        # move via apply_delta, already invalidated key-by-key) — wiping
        # the warm ~84%-hit cube cache on every swap buys no coherence and
        # costs a remote-refetch burst. Opt in only for deployments whose
        # generation payload swaps the sparse tier too.
        self.swap_invalidates_cube_cache = swap_invalidates_cube_cache
        self.stats = UpdateStats()
        self._lock = threading.Lock()      # appliers serialize
        # per-group raw ids currently holding head slots (rebalance assumes
        # the cube cache is keyed by the group's raw ids — the serving
        # convention for the primary group)
        self._resident_ids: dict[int, set] = {}
        # per-version touched-key log: the serving ops' cache-aside guards
        # consult it to drop ONLY the entries a racing delta actually
        # touched — a batch-wide drop would fire on nearly every batch
        # under a continuous stream and collapse the query-cache hit ratio
        self._touched_log: deque = deque()
        self._touched_floor = -1       # log is complete for versions > floor
        self._touched_cap = 512

    # ------------------------------------------------------------- deltas
    def apply(self, batch: DeltaBatch) -> int:
        """Apply one versioned delta batch across all layers. Idempotent
        under replay: versions at or below the last applied one are
        skipped (the watcher may re-offer a delta after a crash)."""
        with self._lock:
            if batch.version <= self.stats.last_version:
                self.stats.deltas_skipped += 1
                return self.stats.last_version
            t_apply0 = time.perf_counter()
            # validate EVERY group before applying ANY: last_version only
            # advances after the whole batch lands, so a malformed group
            # failing mid-batch would otherwise leave the earlier groups
            # applied — and every watcher retry would re-apply them
            # (duplicate overlay blocks, double-counted stats)
            for g in batch.groups:
                ids = np.atleast_1d(np.asarray(g.ids)).reshape(-1)
                if ids.size:
                    rows = np.asarray(g.rows)
                    if rows.ndim != 2 or rows.shape[0] != ids.size:
                        raise ValueError(
                            f"delta v{batch.version} group {g.group}: rows "
                            f"{rows.shape} vs {ids.size} ids")
                    shape = self.cube.row_shape(g.group)
                    if shape is not None and rows.shape[1] != shape[0]:
                        raise ValueError(
                            f"delta v{batch.version} group {g.group}: dim "
                            f"{rows.shape[1]} != cube dim {shape[0]}")
            # fold every group's touched key/item sets FIRST so the whole
            # batch shares ONE invalidation bracket around ONE cube publish
            parts = []        # (group, ids, rows, dels) per group, in order
            keys: list = []
            items_set: set = set()
            for g in batch.groups:
                ids = np.atleast_1d(np.asarray(g.ids)).reshape(-1)
                dels = np.atleast_1d(np.asarray(g.delete_ids)).reshape(-1)
                parts.append((g.group, ids,
                              np.asarray(g.rows) if ids.size else None,
                              dels))
                touched = np.concatenate([ids, dels]) if dels.size else ids
                if touched.size:
                    keys.extend(self.cache_key_fn(g.group, touched))
                if self.qcache_items_fn is not None:
                    items_set |= set(self.qcache_items_fn(g.group, touched))
                    # the training side may ship the raw item ids alongside
                    # the delta (GroupDelta.item_ids): union them in so
                    # invalidation no longer depends on the serving side
                    # having SEEN an item since start — a delta landing
                    # before an item's first request still invalidates any
                    # warm-started query-cache entry for it
                    if g.item_ids is not None:
                        items_set |= {int(i)
                                      for i in np.atleast_1d(g.item_ids)}
                else:
                    items_set |= {int(i) for i in g.touched_item_ids()}
            items = list(items_set)
            # FIRST invalidation pass, BEFORE the cube publish — once for
            # the whole batch. The old invalidate-after-publish order had
            # a torn-attribution window: a reader pinning the NEW version
            # could probe the cache before the invalidation landed and
            # cache-hit a pre-delta row, stamping old rows with the new
            # version. Invalidating first closes it — a reader that
            # re-inserts after this pass is inserting rows that are still
            # current (nothing has published yet), and the SECOND pass
            # below plus the serving ops' own cache-aside guards cover
            # every insert that races the publish itself.
            if self.cube_cache is not None and keys:
                self.stats.cube_keys_invalidated += \
                    self.cube_cache.invalidate_keys(keys)
            if self.query_cache is not None and items:
                self.stats.query_entries_invalidated += \
                    self.query_cache.invalidate_items(items)
            # ONE atomic publish covering every group: a reader pinning at
            # any instant sees either no group or all groups at the batch
            # version — the §7.3 cross-group torn window cannot open
            v_after = self.cube.apply_batch(
                [(grp, ids if ids.size else None, rows,
                  dels if dels.size else None)
                 for grp, ids, rows, dels in parts])
            # log BEFORE the post-publish invalidation: the serving-side
            # guards read this concurrently — appended after, a guard
            # checking in the window between invalidate and append would
            # see an empty span and keep a just-resurrected stale entry.
            # Appended first, it can only over-report (harmless drop).
            # ONE entry per batch, at the single published version.
            self._touched_log.append(
                (v_after, frozenset(keys), frozenset(items)))
            while len(self._touched_log) > self._touched_cap:
                self._touched_floor = self._touched_log.popleft()[0]
            # SECOND invalidation pass, AFTER the publish (and before the
            # head scatter — the head never reads the caches, so earlier
            # is strictly a smaller stale window): catches entries a
            # concurrent reader re-inserted during the publish window
            # whose own cache-aside guard ran before the new version
            # became visible to it.
            if self.cube_cache is not None and keys:
                self.stats.cube_keys_invalidated += \
                    self.cube_cache.invalidate_keys(keys)
            if self.query_cache is not None and items:
                self.stats.query_entries_invalidated += \
                    self.query_cache.invalidate_items(items)
            for grp, ids, rows, dels in parts:
                if self.head is not None:
                    if ids.size:
                        self.stats.head_rows_updated += self.head.update_rows(
                            grp, ids, rows)
                    if dels.size:
                        self.head.demote(grp, dels)
                        # keep the policy's membership view in sync — a
                        # drifted resident set undercounts free slots and
                        # wastes hysteresis evictions on already-gone keys
                        if grp in self._resident_ids:
                            self._resident_ids[grp] -= \
                                {int(i) for i in dels}
                self.stats.rows_upserted += int(ids.size)
                self.stats.rows_deleted += int(dels.size)
            self.stats.deltas_applied += 1
            self.stats.last_version = batch.version
            self.stats.apply_s_last = time.perf_counter() - t_apply0
            self.stats.apply_s_total += self.stats.apply_s_last
            return batch.version

    @contextmanager
    def pinned_capture(self):
        """Atomic capture for the snapshotter (DESIGN.md §9): under the
        apply lock — so no delta batch is mid-flight — pin the cube and
        read the delta cursor + touched-key log, then RELEASE the lock and
        yield. Serialization happens outside the lock under the pin: the
        pin keeps every captured block and versioned server index alive
        against reclaim/compaction while appliers keep publishing.

        Yields ``(pinned_version, (last_version, touched_log,
        touched_floor))``. The lock is plain (non-reentrant); nothing
        inside the critical section may call back into the manager."""
        from repro_torch.core.cube import PinnedVersion
        with self._lock:
            snap = self.cube._pin_current()
            state = (self.stats.last_version, list(self._touched_log),
                     self._touched_floor)
        try:
            yield PinnedVersion(snap), state
        finally:
            self.cube._pin_release(snap[0])

    def restore_state(self, last_version: int, touched_log=None,
                      touched_floor: Optional[int] = None):
        """Recovery-side inverse of ``pinned_capture``: position the delta
        cursor (replay resumes at ``last_version + 1``; older versions hit
        the idempotence skip) and rehydrate the touched-key log. With no
        persisted aux state the floor snaps to ``last_version`` so
        ``touched_since`` answers None — conservative invalidation —
        instead of a falsely-empty span for pre-snapshot versions."""
        with self._lock:
            self.stats.last_version = int(last_version)
            self._touched_log.clear()
            if touched_log:
                self._touched_log.extend(
                    (int(v), frozenset(ks), frozenset(its))
                    for v, ks, its in touched_log)
            self._touched_floor = int(
                last_version if touched_floor is None else touched_floor)

    def touched_since(self, version: int):
        """(cube_keys, item_keys) touched by deltas published at versions >
        ``version``, or None when the log no longer reaches back that far
        (callers must then invalidate conservatively). Versions bumped by
        index folds and compaction touch nothing and legitimately have no
        log entry."""
        if version < self._touched_floor:
            return None
        keys: set = set()
        items: set = set()
        for v, ks, its in list(self._touched_log):
            if v > version:
                keys |= ks
                items |= its
        return keys, items

    # -------------------------------------------------------- generations
    def on_generation_swap(self, gen=None):
        """DoubleBuffer on_swap hook: the dense model changed, so every
        cached SCORE is stale at once; cube ROWS survive unless this
        deployment swaps the sparse tier with the generation."""
        if self.query_cache is not None:
            self.query_cache.bump_model_version()
        if self.cube_cache is not None and self.swap_invalidates_cube_cache:
            self.cube_cache.bump_generation()
        self.stats.generation_swaps += 1

    # -------------------------------------------------- background passes
    def rebalance(self, group: int = 0,
                  _merged: Optional[dict] = None) -> tuple[int, int]:
        """One promote/demote pass for ``group``: the group's slice of the
        cube-cache LFU counts → the group's policy plan → head migration
        (rows gathered from the cube tail in one batched lookup, scattered
        into HBM in one donated launch). Returns (promoted, demoted).
        ``_merged`` lets ``rebalance_all`` fold the two cache tiers once
        and share the result across every group's slice."""
        policy = self.policies.get(group, self.policy)
        if self.head is None or policy is None or self.cube_cache is None:
            return (0, 0)
        with self._lock:
            counts = slice_group_counts(
                merged_lfu_counts(self.cube_cache) if _merged is None
                else _merged, group)
            resident_ids = self._resident_ids.setdefault(group, set())
            plan = policy.plan(counts, resident_ids)
            promoted = demoted = 0
            if plan.demote:
                ids = np.asarray([k for k in plan.demote], np.int64)
                demoted = self.head.demote(group, ids)
                resident_ids -= set(plan.demote)
            if plan.promote:
                ids = np.asarray([k for k in plan.promote], np.int64)
                live = self.cube.contains(group, ids)
                ids = ids[live]                 # only rows the tail still has
                if ids.size:
                    rows = self.cube.lookup(group, ids)
                    promoted = self.head.promote(group, ids, rows)
                    resident_ids |= {int(i) for i in ids}
            self.stats.promotions += promoted
            self.stats.demotions += demoted
            return (promoted, demoted)

    def rebalance_all(self) -> dict:
        """One promote/demote pass per group that owns a policy (or group
        0 under the legacy single-policy wiring). The mem+disk LFU count
        fold runs ONCE and is sliced per group — this runs after every
        applied delta batch, so N full folds per apply would dominate."""
        if self.head is None or self.cube_cache is None:
            return {}
        groups = sorted(self.policies) if self.policies else [0]
        merged = merged_lfu_counts(self.cube_cache)
        return {g: self.rebalance(g, _merged=merged) for g in groups}

    def maybe_compact(self) -> bool:
        """Fold cube overlays once enough have piled up — off the hot path;
        readers keep their pinned snapshots throughout."""
        if self.cube.overlay_blocks < self.compact_after_blocks:
            return False
        t0 = time.perf_counter()
        self.cube.compact(max_rows_per_pass=self.compact_max_rows_per_pass)
        self.stats.compact_s_last = time.perf_counter() - t0
        self.stats.compact_s_total += self.stats.compact_s_last
        self.stats.compactions += 1
        return True
