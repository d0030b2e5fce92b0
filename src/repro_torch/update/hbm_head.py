"""The HBM-resident head tier of the sparse store (DESIGN.md §6.3).

A fixed-slot device table mirroring the hottest cube rows: the cube tail
(host/disk) stays the source of truth for every row; the head holds copies
of the rows worth HBM. Membership is a host-side signature → slot map (the
same compact signatures the cube keys by, so both tiers agree on identity);
row data moves with ``sparse.sharded.sharded_row_update`` — an in-place
``index_copy_`` into the live table, so promotions, demotions and delta
updates touch rows *in place*, never rebuilding it.

The table is a torch tensor on ``cuda`` unless the caller passes
``device="cpu"``; membership (the map and the free list) is host numpy, as
in the reference, so slot assignment is the same in both packages.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.sparse.hashing import signature_np
from repro_torch.sparse.sharded import sharded_row_update


@dataclass
class HeadStats:
    promotions: int = 0
    demotions: int = 0
    inplace_updates: int = 0
    hits: int = 0
    misses: int = 0
    scatters: int = 0            # device scatter launches (batched)

    @property
    def hit_ratio(self):
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class HBMHead:
    """Fixed-capacity device row store with host-side membership.

    The sig → slot map is kept as parallel sorted numpy arrays (one
    ``searchsorted`` resolves a whole batch, mirroring the cube's index
    discipline) and swapped atomically as one tuple; membership changes
    (promote/demote) rebuild it off the hot path."""

    def __init__(self, n_slots: int, dim: int, dtype=torch.float32,
                 device=None):
        self.n_slots = n_slots
        self.dim = dim
        self.device = default_device(device)
        self.table = torch.zeros((n_slots, dim), dtype=dtype,
                                 device=self.device)
        self._map = (np.empty(0, np.uint64), np.empty(0, np.int32))
        self._free = list(range(n_slots - 1, -1, -1))   # pop() → lowest first
        self._lock = threading.Lock()                   # writers serialize
        self.stats = HeadStats()

    # ---------------------------------------------------------- membership
    @property
    def resident_count(self) -> int:
        return self._map[0].size

    def resident_sigs(self) -> np.ndarray:
        return self._map[0].copy()

    def _resolve(self, sigs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(slots, found) for a batch of signatures against the current map
        snapshot; slots are valid only where found."""
        msigs, mslots = self._map
        if msigs.size == 0:
            return np.zeros(sigs.size, np.int32), np.zeros(sigs.size, bool)
        pos = np.searchsorted(msigs, sigs)
        np.minimum(pos, msigs.size - 1, out=pos)
        found = msigs[pos] == sigs
        return mslots[pos], found

    def resident(self, group: int, raw_ids: np.ndarray) -> np.ndarray:
        ids = np.atleast_1d(np.asarray(raw_ids)).reshape(-1)
        _, found = self._resolve(signature_np(group, ids))
        return found

    # ------------------------------------------------------------- access
    def lookup(self, group: int, raw_ids: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
        """(rows, found): device-gathered rows for the resident subset
        (rows at non-found positions are zeros — callers fall back to the
        cube tail for those). Resolves, gathers and copies to the host under
        the writer lock: a demote followed by a promote reuses a slot, so an
        unlocked reader could gather a row that now belongs to another
        signature."""
        ids = np.atleast_1d(np.asarray(raw_ids)).reshape(-1)
        with self._lock:
            slots, found = self._resolve(signature_np(group, ids))
            idx = torch.as_tensor(np.where(found, slots, 0), dtype=torch.int64)
            rows = self.table.index_select(
                0, idx.to(self.device)).cpu().numpy()
        rows[~found] = 0
        self.stats.hits += int(found.sum())
        self.stats.misses += int((~found).sum())
        return rows, found

    # ------------------------------------------------------------ updates
    def update_rows(self, group: int, raw_ids: np.ndarray,
                    rows: np.ndarray) -> int:
        """Delta application: in-place scatter of new row values for the
        signatures ALREADY resident (non-resident ids are the cube tail's
        problem). One device scatter per call. Duplicate ids are resolved
        here, last occurrence wins — a repeated-index scatter applies in
        UNSPECIFIED order, which would let the head diverge from the cube
        (whose merge is last-wins). Returns rows updated."""
        ids = np.atleast_1d(np.asarray(raw_ids)).reshape(-1)
        rows = np.asarray(rows)
        if ids.size > 1:
            _, first_in_rev = np.unique(ids[::-1], return_index=True)
            last = ids.size - 1 - first_in_rev
            ids, rows = ids[last], rows[last]
        with self._lock:
            slots, found = self._resolve(signature_np(group, ids))
            n = int(found.sum())
            if n == 0:
                return 0
            self.table = sharded_row_update(
                self.table, slots[found], rows[found])
            self.stats.inplace_updates += n
            self.stats.scatters += 1
            return n

    def promote(self, group: int, raw_ids: np.ndarray,
                rows: np.ndarray) -> int:
        """Migrate rows INTO the head: assign free slots (already-resident
        ids degrade to an in-place refresh) and scatter the row data in one
        device launch. Promotes at most the free-slot budget — callers
        demote first to make room. Returns rows newly promoted."""
        ids = np.atleast_1d(np.asarray(raw_ids)).reshape(-1)
        rows = np.asarray(rows)
        with self._lock:
            sigs = np.asarray(signature_np(group, ids))
            slots, found = self._resolve(sigs)
            fresh = np.flatnonzero(~found)[:len(self._free)]
            new_slots = np.array([self._free.pop() for _ in fresh], np.int32)
            scatter_slots = np.concatenate([slots[found], new_slots])
            scatter_rows = np.concatenate([rows[found], rows[fresh]])
            if scatter_slots.size:
                self.table = sharded_row_update(
                    self.table, scatter_slots, scatter_rows)
                self.stats.scatters += 1
            if fresh.size:
                msigs, mslots = self._map
                order = np.argsort(np.concatenate([msigs, sigs[fresh]]),
                                   kind="stable")
                self._map = (np.concatenate([msigs, sigs[fresh]])[order],
                             np.concatenate([mslots, new_slots])[order])
            self.stats.promotions += int(fresh.size)
            self.stats.inplace_updates += int(found.sum())
            return int(fresh.size)

    def demote(self, group: int, raw_ids: np.ndarray) -> int:
        """Migrate rows OUT of the head: membership-only — the row data
        already lives in the cube tail, so demotion frees the slot without
        touching HBM. Returns rows demoted."""
        ids = np.atleast_1d(np.asarray(raw_ids)).reshape(-1)
        with self._lock:
            sigs = np.asarray(signature_np(group, ids))
            slots, found = self._resolve(sigs)
            if not found.any():
                return 0
            gone = np.unique(sigs[found])
            msigs, mslots = self._map
            # vectorized membership: this runs under the lock the serving
            # path's lookup() contends on — a per-element Python scan would
            # stall requests for O(resident) at every delete/rebalance
            keep = ~np.isin(msigs, gone)
            self._free.extend(int(s) for s in mslots[~keep])
            self._map = (msigs[keep], mslots[keep])
            self.stats.demotions += int(gone.size)
            return int(gone.size)
