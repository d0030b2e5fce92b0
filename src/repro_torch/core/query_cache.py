"""Query cache (paper §5.2): LRU + TTL cache of user-item SCORES.

Insight: the user-item score is stable over a short window (Fig. 5b: ≥60% of
scores invariant within 2 minutes), so a recently computed score can be
reused — a hit eliminates the WHOLE downstream inference computation.

  * purely in-memory, LRU (recency matters here, unlike the cube cache)
  * entries expire after a tunable window (Table 6: [60, 600] s; default
    120 s, offline-tuned to 143 s in the paper's Service A)
  * any user feedback (click, unlike, …) invalidates that user's entries —
    preference just changed
  * conditioned insertion: only scores worth reusing (e.g. high-relevance
    items) are cached, via an admission predicate

Coherence with the streaming-update subsystem (DESIGN.md §6): a cached
score embeds the MODEL that produced it, so every entry carries the
``model_version`` current at insert. ``bump_model_version`` (wired to the
hot-swap double buffer) lazily invalidates everything computed by the old
generation — previously a hot swap kept serving old-model scores out of
this cache for up to ``window_s`` seconds. ``invalidate_items`` is the
targeted form for parameter deltas: exactly the items whose rows a delta
touched drop, via a reverse item → users index.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Optional


@dataclass
class QueryCacheStats:
    hits: int = 0
    misses: int = 0
    expirations: int = 0
    invalidations: int = 0
    stale_version: int = 0     # entries dropped by model-version coherence

    @property
    def hit_ratio(self):
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class QueryCache:
    def __init__(self, capacity: int = 1_000_000, window_s: float = 120.0,
                 admit: Optional[Callable[[float], bool]] = None):
        self.capacity = capacity
        self.window_s = window_s
        self.admit = admit or (lambda score: True)
        # key → (score, insert_time, model_version)
        self._data: OrderedDict[tuple, tuple[float, float, int]] = OrderedDict()
        self._by_user: dict[Any, set] = {}
        self._by_item: dict[Any, set] = {}
        self.stats = QueryCacheStats()
        self.model_version = 0
        self._min_valid = 0

    @staticmethod
    def _unlink(index: dict, key, member):
        """Drop ``member`` from a reverse-index set, removing the key when
        the set empties — bare .discard() would leak one empty set per
        distinct user/item ever cached (unbounded on a large catalog)."""
        s = index.get(key)
        if s is not None:
            s.discard(member)
            if not s:
                del index[key]

    @staticmethod
    def _link(index: dict, key, member):
        """Add ``member`` to a reverse-index set, re-checking the set is
        still INSTALLED afterwards: an invalidation (update thread) can pop
        the set between our setdefault and our add, which would strand the
        member in an orphaned set — the cached entry would then be
        unreachable by every future targeted invalidation (including the
        serving op's own post-insert race guard) and serve stale until
        TTL. Each step is GIL-atomic; invalidations are rare, so the loop
        converges immediately in practice."""
        while True:
            s = index.setdefault(key, set())
            s.add(member)
            if index.get(key) is s:
                return

    # ------------------------------------------------------- invalidation
    def bump_model_version(self) -> int:
        """A new model generation was hot-swapped in: every cached score was
        computed by the OLD model — raise the validity floor so they all
        miss (and drop) on their next probe. O(1); no sweep."""
        self.model_version += 1
        self._min_valid = self.model_version
        return self.model_version

    def invalidate_items(self, items) -> int:
        """Targeted coherence for a parameter delta: scores for exactly
        these items are stale (their sparse rows just changed); everyone
        else's cache entries survive. Returns entries dropped."""
        n = 0
        for item in items:
            users = self._by_item.pop(item, None)
            if not users:
                continue
            for user in users:
                if self._data.pop((user, item), None) is not None:
                    self._unlink(self._by_user, user, item)
                    n += 1
        self.stats.invalidations += n
        return n

    # ------------------------------------------------------------- access
    def get(self, user: Any, item: Any, now: float) -> Optional[float]:
        key = (user, item)
        hit = self._data.get(key)
        if hit is None:
            self.stats.misses += 1
            return None
        score, stamp, ver = hit
        if ver < self._min_valid:
            self._evict(key)
            self.stats.stale_version += 1
            self.stats.misses += 1
            return None
        if now - stamp > self.window_s:
            self._evict(key)
            self.stats.expirations += 1
            self.stats.misses += 1
            return None
        self._data.move_to_end(key)          # LRU touch
        self.stats.hits += 1
        return score

    def put(self, user: Any, item: Any, score: float, now: float,
            version: Optional[int] = None):
        """``version``: the model_version the score was COMPUTED at (capture
        it before binding the generation); defaults to the current one. A
        swap racing the insert then leaves the entry stamped pre-bump —
        lazily dropped, never a stale score marked fresh."""
        if not self.admit(score):
            return
        key = (user, item)
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = (score, now,
                           self.model_version if version is None else version)
        self._link(self._by_user, user, item)
        self._link(self._by_item, item, user)
        while len(self._data) > self.capacity:
            old_key, _ = self._data.popitem(last=False)
            self._unlink(self._by_user, old_key[0], old_key[1])
            self._unlink(self._by_item, old_key[1], old_key[0])

    # ------------------------------------------------------------ batched
    def get_many(self, users, items, now: float) -> list:
        """Vectorized multi-get for one event batch: single pass over the
        store with locally-bound dict methods, stats folded in once. Returns
        a list of Optional[float] aligned with the inputs."""
        data = self._data
        out = []
        hits = misses = expired = stale = 0
        for user, item in zip(users, items):
            key = (user, item)
            entry = data.get(key)
            if entry is None:
                misses += 1
                out.append(None)
                continue
            score, stamp, ver = entry
            if ver < self._min_valid:
                self._evict(key)
                stale += 1
                misses += 1
                out.append(None)
                continue
            if now - stamp > self.window_s:
                self._evict(key)
                expired += 1
                misses += 1
                out.append(None)
                continue
            data.move_to_end(key)                # LRU touch
            hits += 1
            out.append(score)
        self.stats.hits += hits
        self.stats.misses += misses
        self.stats.expirations += expired
        self.stats.stale_version += stale
        return out

    def put_many(self, users, items, scores, now: float,
                 version: Optional[int] = None):
        """Vectorized multi-put: admission filter + insert for a whole batch,
        deferring capacity trimming to one pass at the end. ``version`` as
        in put(): stamp with the model version the scores were computed at."""
        data, by_user, by_item = self._data, self._by_user, self._by_item
        admit = self.admit
        ver = self.model_version if version is None else version
        for user, item, score in zip(users, items, scores):
            if not admit(score):
                continue
            key = (user, item)
            if key in data:
                data.move_to_end(key)
            data[key] = (score, now, ver)
            self._link(by_user, user, item)
            self._link(by_item, item, user)
        while len(data) > self.capacity:
            old_key, _ = data.popitem(last=False)
            self._unlink(by_user, old_key[0], old_key[1])
            self._unlink(by_item, old_key[1], old_key[0])

    def user_feedback(self, user: Any):
        """Click/unlike/… → the user's cached scores are stale (paper §5.2)."""
        items = self._by_user.pop(user, set())
        for it in items:
            self._data.pop((user, it), None)
            self._unlink(self._by_item, it, user)
        self.stats.invalidations += len(items)

    def _evict(self, key):
        self._data.pop(key, None)
        self._unlink(self._by_user, key[0], key[1])
        self._unlink(self._by_item, key[1], key[0])

    def __len__(self):
        return len(self._data)
