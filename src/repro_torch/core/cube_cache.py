"""Cube cache (paper §5.2): two-tier local LFU over cube key-values.

  * memory tier  — hottest ~0.1% of keys, avoids even disk I/O
  * disk tier    — hottest ~1%, hides remote-cube network I/O
  * LFU replacement (paper's choice — access counts, not recency, match the
    heavy-tailed, slowly-drifting feature popularity of Fig. 5a)

The paper reports ~84% hit ratio, avoiding up to 90% of remote accesses →
~10% average latency reduction. benchmarks/fig8 reproduces this on Zipf
traffic.

Cache coherence with the streaming-update subsystem (DESIGN.md §6): every
entry is stamped with the cache ``version`` current at insert. A delta that
touches a set of signatures calls ``invalidate_keys`` (targeted — exactly
the touched keys drop, LFU statistics persist); a whole-generation hot swap
calls ``bump_generation`` (lazy — the floor rises and stale entries fall
out on their next probe, no O(capacity) sweep).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class TierStats:
    hits: int = 0
    misses: int = 0

    @property
    def hit_ratio(self):
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class _LFU:
    """O(log n) LFU via lazy heap; counts persist across evictions (paper
    replaces *entries*, not statistics)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.data: dict[Any, Any] = {}
        self.counts: dict[Any, int] = {}
        self._heap: list = []
        self._tick = itertools.count()

    def get(self, key):
        self.counts[key] = self.counts.get(key, 0) + 1
        if key in self.data:
            heapq.heappush(self._heap, (self.counts[key], next(self._tick), key))
            return self.data[key]
        return None

    def put(self, key, value):
        if self.capacity <= 0:
            return None
        evicted = None
        if key not in self.data and len(self.data) >= self.capacity:
            while self._heap:
                cnt, _, k = heapq.heappop(self._heap)
                if k in self.data and cnt >= self.counts.get(k, 0):
                    evicted = (k, self.data.pop(k))
                    break
            if evicted is None and self.data:
                k = min(self.data, key=lambda k: self.counts.get(k, 0))
                evicted = (k, self.data.pop(k))
        self.data[key] = value
        self.counts[key] = self.counts.get(key, 0) + 1
        heapq.heappush(self._heap, (self.counts[key], next(self._tick), key))
        return evicted


class TwoTierLFUCache:
    """get() probes memory → disk (promoting on disk hit); put() inserts to
    memory, demoting memory evictions to the disk tier. Values are stored
    internally as ``(version, value)`` — the version stamp is how a model
    generation swap invalidates the whole cache lazily while a delta batch
    invalidates exactly the keys it touched."""

    def __init__(self, mem_capacity: int, disk_capacity: int,
                 mem_latency_s: float = 1e-6, disk_latency_s: float = 40e-6):
        self.mem = _LFU(mem_capacity)
        self.disk = _LFU(disk_capacity)
        self.stats = {"mem": TierStats(), "disk": TierStats()}
        self.lat = {"mem": mem_latency_s, "disk": disk_latency_s}
        self.simulated_latency_s = 0.0
        self.version = 0           # stamp applied to inserts
        self._min_valid = 0        # entries stamped below this are stale
        self.invalidations = 0     # entries dropped by coherence events
        # bumped by every coherence event: the disk→mem promote checks it
        # so a hit that RACED an invalidation is not re-inserted (the
        # transient read is fine — equivalent to reading just before the
        # delta — but a resurrected entry would serve stale rows forever)
        self._inval_epoch = 0

    # ------------------------------------------------------- invalidation
    def invalidate_keys(self, keys) -> int:
        """Targeted coherence: drop exactly these keys from both tiers (a
        delta just rewrote their cube rows). LFU counts persist — the key's
        popularity did not change, only its value did. Returns drops."""
        self._inval_epoch += 1
        n = 0
        for key in keys:
            if self.mem.data.pop(key, None) is not None:
                n += 1
            if self.disk.data.pop(key, None) is not None:
                n += 1
        self.invalidations += n
        return n

    def bump_generation(self):
        """Whole-generation coherence (hot swap): raise the validity floor;
        every pre-bump entry becomes a miss on its next probe and is dropped
        then — O(1) now, no sweep over capacity."""
        self._inval_epoch += 1
        self.version += 1
        self._min_valid = self.version

    def _fresh(self, tier: _LFU, key, entry) -> bool:
        if entry[0] >= self._min_valid:
            return True
        tier.data.pop(key, None)          # lazily drop the stale entry
        self.invalidations += 1
        return False

    # ------------------------------------------------------------- access
    def get(self, key) -> Optional[Any]:
        v = self.mem.get(key)
        if v is not None and self._fresh(self.mem, key, v):
            self.stats["mem"].hits += 1
            self.simulated_latency_s += self.lat["mem"]
            return v[1]
        self.stats["mem"].misses += 1
        epoch = self._inval_epoch
        v = self.disk.get(key)
        if v is not None and self._fresh(self.disk, key, v):
            self.stats["disk"].hits += 1
            self.simulated_latency_s += self.lat["disk"]
            if self._inval_epoch == epoch:      # no invalidation raced us
                dem = self.mem.put(key, v)      # promote (stamp rides along)
                if dem is not None:
                    self.disk.put(*dem)
            return v[1]
        self.stats["disk"].misses += 1
        return None

    def put(self, key, value):
        dem = self.mem.put(key, (self.version, value))
        if dem is not None:
            self.disk.put(*dem)

    # ------------------------------------------------------------ batched
    def get_many(self, keys) -> list:
        """Multi-get for one batch: single pass with locally-bound tier
        methods, stats/latency folded in once at the end. Probe order per key
        is IDENTICAL to sequential get() calls — in particular a duplicate
        of a disk-resident key hits the memory tier after the first
        occurrence promotes it, not the disk tier twice. Returns a list
        aligned with ``keys`` (None per miss)."""
        mem_get, disk_get = self.mem.get, self.disk.get
        mem_put, disk_put = self.mem.put, self.disk.put
        fresh = self._fresh
        out = []
        mem_hits = mem_misses = disk_hits = disk_misses = 0
        lat = 0.0
        for key in keys:
            v = mem_get(key)
            if v is not None and fresh(self.mem, key, v):
                mem_hits += 1
                lat += self.lat["mem"]
                out.append(v[1])
                continue
            mem_misses += 1
            epoch = self._inval_epoch
            v = disk_get(key)
            if v is not None and fresh(self.disk, key, v):
                disk_hits += 1
                lat += self.lat["disk"]
                if self._inval_epoch == epoch:      # no raced invalidation
                    dem = mem_put(key, v)           # promote
                    if dem is not None:
                        disk_put(*dem)
                out.append(v[1])
            else:
                disk_misses += 1
                out.append(None)
        self.stats["mem"].hits += mem_hits
        self.stats["mem"].misses += mem_misses
        self.stats["disk"].hits += disk_hits
        self.stats["disk"].misses += disk_misses
        self.simulated_latency_s += lat
        return out

    def put_many(self, keys, values):
        """Vectorized multi-put: memory-tier inserts with demotions flushed
        to the disk tier, one pass for the whole batch."""
        mem_put, disk_put = self.mem.put, self.disk.put
        ver = self.version
        for key, value in zip(keys, values):
            dem = mem_put(key, (ver, value))
            if dem is not None:
                disk_put(*dem)

    @property
    def overall_hit_ratio(self) -> float:
        m, d = self.stats["mem"], self.stats["disk"]
        total = m.hits + m.misses
        return (m.hits + d.hits) / total if total else 0.0


def capacity_from_ratio(vocab: int, cache_ratio_pct: float,
                        mem_share: float = 0.1) -> tuple[int, int]:
    """Paper defaults: disk tier = cache_ratio (~1%) of keys, memory tier =
    top tenth of that (~0.1%). Both are offline-tunable (Table 6)."""
    disk = max(1, int(vocab * cache_ratio_pct / 100.0))
    mem = max(1, int(disk * mem_share))
    return mem, disk
