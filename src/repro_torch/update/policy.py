"""Frequency-driven promote/demote policy (DESIGN.md §6.3).

Decides which cube-tail rows deserve HBM head slots. The signal is free:
the two-tier LFU cube cache (paper §5.2) already maintains per-key access
counts that persist across evictions — exactly the heavy-tailed popularity
estimate Fig. 5a says drifts slowly. The policy reads those counts,
computes the desired head membership, and emits a (promote, demote) plan;
``UpdateManager.rebalance`` executes it against the head + cube.

Hysteresis: a resident row keeps its slot unless the head is full AND a
strictly hotter candidate (by ``hysteresis``×) needs it — popularity drift
is slow, so ping-ponging rows across tiers would pay two migrations for
zero hit-rate gain.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List


@dataclass
class TierPlan:
    promote: List = field(default_factory=list)   # keys to move into HBM
    demote: List = field(default_factory=list)    # keys to drop back to tail

    @property
    def empty(self) -> bool:
        return not (self.promote or self.demote)


class PromoteDemotePolicy:
    def __init__(self, capacity: int, min_count: int = 2,
                 hysteresis: float = 2.0):
        assert capacity >= 0 and hysteresis >= 1.0
        self.capacity = capacity
        self.min_count = min_count
        self.hysteresis = hysteresis

    def plan(self, counts: Dict, resident: Iterable) -> TierPlan:
        """counts: key → LFU access count (e.g. merged cube-cache tiers);
        resident: keys currently holding head slots. Deterministic: ties
        break on the key itself."""
        resident = set(resident)
        hot = sorted(((c, k) for k, c in counts.items()
                      if c >= self.min_count),
                     key=lambda ck: (-ck[0], repr(ck[1])))
        desired = [k for _, k in hot[:self.capacity]]
        desired_set = set(desired)
        candidates = [k for k in desired if k not in resident]
        free = max(0, self.capacity - len(resident))
        promote = candidates[:free]          # free slots fill unconditionally
        overflow = candidates[free:]         # each needs an eviction
        cold = sorted((k for k in resident if k not in desired_set),
                      key=lambda k: (counts.get(k, 0), repr(k)))
        demote: List = []
        for newcomer, victim in zip(overflow, cold):
            # hysteresis gate: displace only for a decisively hotter row
            if counts.get(newcomer, 0) >= \
                    self.hysteresis * max(1, counts.get(victim, 0)):
                demote.append(victim)
                promote.append(newcomer)
        return TierPlan(promote=promote, demote=demote)


def slice_group_counts(merged: Dict, group: int) -> Dict:
    """One feature group's slice of merged LFU counts, keyed by RAW id.
    Follows the ``_default_cache_key_fn`` convention the serving stack
    uses: bare keys belong to group 0, ``(group, id)`` tuples to their
    group — so each group's promote/demote policy ranks only its own rows
    instead of competing against every other group's popularity."""
    out: Dict = {}
    for k, c in merged.items():
        if group == 0:
            if isinstance(k, tuple):
                continue
            out[k] = c
        elif isinstance(k, tuple) and len(k) == 2 and k[0] == group:
            out[k[1]] = c
    return out


def group_lfu_counts(cube_cache, group: int) -> Dict:
    return slice_group_counts(merged_lfu_counts(cube_cache), group)


def merged_lfu_counts(cube_cache) -> Dict:
    """Fold both cache tiers' persistent LFU counts into one popularity
    estimate. Elementwise MAX, not sum: `_LFU.get` increments a tier's
    counter on every probe — hit or miss — so a non-mem-resident key
    accumulates counts in BOTH tiers per access (mem miss + disk probe)
    while a mem-hot key touches only one; summing would double-weight
    exactly the keys the policy should rank lower."""
    counts: Dict = dict(cube_cache.disk.counts)
    # list(): serving threads insert into counts concurrently with this
    # (update-thread) pass — a bare Python-level .items() loop would raise
    # "dictionary changed size during iteration"
    for k, c in list(cube_cache.mem.counts.items()):
        if c > counts.get(k, 0):
            counts[k] = c
    return counts
