"""Typed stage processors for the scenario API (DESIGN.md §7).

The old ``InferenceService`` hard-coded one DIN re-rank pipeline: stage
logic lived in closures inside ``_build()``, requests were raw payload
dicts with magic keys, and every cube/feature/invalidation path assumed
embedding group 0. This module is the decomposition: each stage is a
configurable class that

  * owns its piece of the serving-correctness machinery (version pinning,
    cache-aside guards, tombstone handling, reverse-map recording), and
  * DECLARES its payload contract — ``requires`` (keys it reads) and
    ``provides`` (keys it writes) — so ``PipelineBuilder`` (scenario.py)
    can reject a mis-wired pipeline at build time instead of letting it
    KeyError mid-traffic.

Stages are scenario-agnostic: they read everything model- or
deployment-specific off the ``ScenarioRuntime`` handed to them, so one
stage class serves DIN, DIEN and retrieval scenarios alike.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.obs.trace import add_child_spans, annotate, shard_fanout_spans
from repro_torch.core.cube import (TIER_DEFAULT, TIER_PRIMARY, TIER_REPLICA,
                             TIER_STALE_CACHE)
from repro_torch.sparse.hashing import hash_bucket_np

# ---------------------------------------------------------------- payloads

#: Keys every Request carries into the pipeline (the ingress contract).
#: ``hist`` and ``candidates`` are optional per scenario — the builder
#: includes them in the ingress key set only when the request generator
#: attaches them.
REQUEST_KEYS = ("user_id", "item_id", "user_fields", "item_fields",
                "scenario")

_CORE_FIELDS = ("user_id", "item_id", "user_fields", "item_fields",
                "hist", "candidates", "scenario")


@dataclass
class Request:
    """One inference request — the typed replacement for the raw payload
    dict. Core fields are declared; stage-attached intermediates (hashed
    ids, cube rows, scores, topk, ...) live in ``extras``.

    The mapping protocol (``req["hashed"]``, ``"score" in req``,
    ``req.get("candidates")``) is kept so generic SEDP machinery — the
    shedder, the multi-tenant fanout, existing tests — works on Requests
    and plain dicts interchangeably; an unset optional core field
    (``hist``/``candidates`` = None) behaves as an absent key."""
    user_id: int = 0
    item_id: int = 0
    user_fields: dict = field(default_factory=dict)
    item_fields: dict = field(default_factory=dict)
    hist: Optional[np.ndarray] = None
    candidates: Optional[list] = None
    scenario: str = ""
    extras: dict = field(default_factory=dict)

    # ------------------------------------------------- mapping protocol
    def __getitem__(self, key):
        if key in _CORE_FIELDS:
            v = getattr(self, key)
            if v is None:
                raise KeyError(key)
            return v
        return self.extras[key]

    def __setitem__(self, key, value):
        if key in _CORE_FIELDS:
            setattr(self, key, value)
        else:
            self.extras[key] = value

    def __contains__(self, key):
        try:
            self[key]
            return True
        except KeyError:
            return False

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def keys(self):
        return ([k for k in _CORE_FIELDS if getattr(self, k) is not None]
                + list(self.extras))

    def __iter__(self):
        return iter(self.keys())

    def copy(self) -> "Request":
        """Shallow clone with an independent extras dict — what the
        multi-tenant fanout uses so per-scenario stages never write into a
        sibling clone's payload."""
        return Request(user_id=self.user_id, item_id=self.item_id,
                       user_fields=self.user_fields,
                       item_fields=self.item_fields, hist=self.hist,
                       candidates=(list(self.candidates)
                                   if self.candidates is not None else None),
                       scenario=self.scenario, extras=dict(self.extras))


@dataclass
class Response:
    """Typed view of a served event, attached by ``RespondStage`` at
    ``event.meta["response"]``."""
    scenario: str
    req_id: int
    user_id: Optional[int] = None
    item_id: Optional[int] = None
    score: Optional[float] = None
    topk: Optional[list] = None
    generation: Optional[int] = None
    cube_version: Optional[int] = None
    from_cache: bool = False
    # graceful-degradation ladder rung this answer was served from
    # (DESIGN.md §8.5): 0 primary, 1 versioned replica, 2 stale-cache
    # row, 3 default embedding. 0 also for cache hits (they bypass the
    # cube stage entirely).
    degraded_tier: int = 0
    # the request blew its deadline budget: the event was short-circuited
    # to the sink without a score (DESIGN.md §8.4)
    timed_out: bool = False

    @classmethod
    def from_event(cls, ev) -> "Response":
        p = ev.payload
        get = p.get if hasattr(p, "get") else (lambda k, d=None: d)
        return cls(scenario=get("scenario", ""), req_id=ev.req_id,
                   user_id=get("user_id"), item_id=get("item_id"),
                   score=get("score"), topk=get("topk"),
                   generation=get("generation"),
                   cube_version=get("cube_version"),
                   from_cache=("score" in p and "generation" not in p),
                   degraded_tier=int(get("degraded_tier", 0) or 0),
                   timed_out=bool(ev.meta.get("timed_out")))


# ------------------------------------------------------------- stage base

class Stage:
    """One SEDP stage processor with a declared payload contract.

    ``op(batch, ctx)`` is handed to ``SEDP.add_stage``; ``requires`` /
    ``provides`` are validated by the builder against every path that can
    reach the stage. Class attributes carry the default tuning knobs
    (paper Table 6); the builder may override per scenario."""
    name: str = "stage"
    requires: tuple = ()
    provides: tuple = ()
    batch_size: int = 8
    parallelism: int = 2

    def op(self, batch, ctx):           # pragma: no cover - abstract
        raise NotImplementedError


def stage_of(op) -> Optional[Stage]:
    """Recover the Stage instance behind a stage op callable (bound method
    or a builder wrapper that stamped ``_stage``)."""
    st = getattr(op, "_stage", None)
    if isinstance(st, Stage):
        return st
    owner = getattr(op, "__self__", None)
    return owner if isinstance(owner, Stage) else None


# ----------------------------------------------------------------- stages

class QueryCacheStage(Stage):
    """HHS query cache probe: hits short-circuit straight to the respond
    stage with the cached score; misses continue down the pipeline.

    Scenario-scoped: in a multi-scenario service the user key is
    ``(scenario, user_id)`` so DIN's cached score can never answer a DIEN
    request (items stay raw so one delta invalidates every scenario's
    scores for the touched rows)."""
    name = "query_cache"
    requires = ("user_id", "item_id")
    provides = ()
    batch_size = 16
    parallelism = 2

    def __init__(self, rt, hit_route: str = "respond",
                 miss_route: Optional[str] = None):
        self.rt = rt
        self.hit_route = hit_route
        self.miss_route = miss_route

    def op(self, batch, ctx):
        now = ctx.now()     # executor clock: wall (Async) or virtual (Sim)
        scores = self.rt.substrate.query_cache.get_many(
            [self.rt.user_key(ev.payload) for ev in batch],
            [ev.payload["item_id"] for ev in batch], now)
        for ev, s in zip(batch, scores):
            if s is not None:
                ev.payload["score"] = s
                ev.route = self.hit_route
            else:
                ev.route = self.miss_route
            annotate(ev, cache_hit=s is not None)
        return batch


class FeatureHashStage(Stage):
    """Feature extraction: hash EVERY single-valued item field into its
    cube feature group (not just group 0) and record the per-group
    bucket → raw-items reverse map that makes query-cache invalidation
    targeted. The maps are bounded (``BoundedReverseMap``): pruning
    invalidates the dropped items first, so forgetting a mapping can only
    ever over-invalidate, never leave a stale score behind."""
    name = "features"
    requires = ("item_id", "item_fields")
    provides = ("hashed",)
    batch_size = 8
    parallelism = 2

    def __init__(self, rt):
        self.rt = rt

    def op(self, batch, ctx):
        sub = self.rt.substrate
        items = np.fromiter((ev.payload["item_id"] for ev in batch),
                            np.int64, len(batch))
        hashed_all = [dict() for _ in batch]
        for fname, group, vocab in self.rt.cube_groups:
            values = np.fromiter(
                (int(np.asarray(ev.payload["item_fields"][fname]).reshape(-1)[0])
                 for ev in batch), np.int64, len(batch))
            hashed = hash_bucket_np(group, values, vocab)
            rmap = sub.bucket_items[group]
            for hv, h, item in zip(hashed_all, hashed, items):
                hv[fname] = int(h)
                # reverse map for targeted query-cache invalidation (GIL-
                # atomic set/dict ops; bounded — see BoundedReverseMap)
                rmap.add(int(h), int(item))
            pruned = rmap.maybe_prune()
            if pruned:
                # invalidate-and-forget: the dropped mappings' items leave
                # the query cache NOW, so the bound never costs coherence
                sub.query_cache.invalidate_items(pruned)
        for ev, hv in zip(batch, hashed_all):
            ev.payload["hashed"] = hv
        return batch


class CubeFetchStage(Stage):
    """Parameter-cube resolve for ALL of the scenario's item-field groups
    under ONE pinned cube version.

    Per group: cache probe and misses happen inside the pin (probing
    before pinning would let a pre-delta cached row ride out stamped with
    the post-delta version, sneaking past both cache-aside guards); the
    HBM head tier answers promoted hot rows; tombstoned rows serve as the
    zero/default row (a delete is a legitimate serving state, not a
    KeyError that kills the stage worker); and the post-insert version
    check drops exactly the cache entries a racing delta touched.

    Pinning once for the whole group sweep gives every group's rows on
    one event a single version attribution: the cube publishes a
    multi-group delta batch as ONE atomic snapshot swap
    (``apply_batch``, DESIGN.md §6.6), so the single pin resolves EVERY
    group at exactly the pinned version — batch-atomic across groups,
    not merely coherent within each (the §7.3 cross-group relaxation is
    closed).

    Graceful degradation (DESIGN.md §8.5): the cube resolves misses via
    ``lookup_ex``, which walks the ladder healthy-primary → versioned
    replica (bit-identical at the pinned version) → TIER_DEFAULT when no
    holder is reachable. This stage inserts one more rung between those
    last two: a bounded stale-row side buffer (most recent authoritative
    row seen per key, ANY version) answers TIER_DEFAULT keys as
    TIER_STALE_CACHE before falling back to the default embedding. The
    event's worst rung is stamped into ``payload["degraded_tier"]`` (→
    ``Response.degraded_tier``) and counted in ``StageStats.degraded``
    via the ``_degraded`` meta marker."""
    name = "cube"
    requires = ("hashed",)
    provides = ("cube_rows", "cube_rows_all", "cube_version",
                "degraded_tier")
    batch_size = 8
    parallelism = 2

    def __init__(self, rt, stale_cap: int = 4096):
        self.rt = rt
        # stale-row side buffer: cache_key → last authoritative row. LRU-
        # bounded; deliberately NOT invalidated by deltas (its whole point
        # is answering when nothing current is reachable — staleness is
        # the contract, and the tier stamp declares it to the caller).
        self.stale_cap = stale_cap
        self._stale: OrderedDict = OrderedDict()
        self._stale_lock = threading.Lock()

    # ------------------------------------------- stale-row side buffer
    def _stale_get(self, ck):
        with self._stale_lock:
            row = self._stale.get(ck)
            if row is not None:
                self._stale.move_to_end(ck)
            return row

    def _stale_put(self, sub, group: int, rows: dict):
        if not rows:
            return
        with self._stale_lock:
            for k, r in rows.items():
                ck = sub.cache_key(group, k)
                self._stale[ck] = r
                self._stale.move_to_end(ck)
            while len(self._stale) > self.stale_cap:
                self._stale.popitem(last=False)

    def _fetch_group(self, group: int, keys: list, pv
                     ) -> tuple[dict, dict]:
        """Resolve one group's hashed keys at the pinned version; returns
        (key → row, key → degradation tier) for every key (cached rows
        included, tier 0)."""
        sub = self.rt.substrate
        cache_keys = [sub.cache_key(group, k) for k in keys]
        fetched: dict = {}
        tiers: dict = {}
        cached = sub.cube_cache.get_many(cache_keys)
        by_key = {k: c[0] for k, c in zip(keys, cached) if c is not None}
        tier_by_key = {k: TIER_PRIMARY for k in by_key}
        miss = sorted({k for k, c in zip(keys, cached) if c is None})
        if miss:
            pending = np.asarray(miss, np.int64)
            head = sub.updates.head
            if head is not None and head.resident_count:
                # HBM head tier first: promoted hot rows skip the host
                # cube entirely (updated in place at delta-apply)
                hrows, hfound = head.lookup(group, pending)
                for k, r, f in zip(pending.tolist(), hrows, hfound):
                    if f:
                        fetched[int(k)] = r
                        tiers[int(k)] = TIER_PRIMARY
                pending = pending[~hfound]
            if pending.size:
                live = sub.cube.contains(group, pending, version=pv)
                if not live.all():
                    dim = (sub.cube.row_shape(group) or (4,))[0]
                    zero = np.zeros(dim, np.float32)
                    for k in pending[~live].tolist():
                        # tombstone: the zero row IS the authoritative
                        # answer at this version — tier 0, not degraded
                        fetched[int(k)] = zero
                        tiers[int(k)] = TIER_PRIMARY
                    pending = pending[live]
            if pending.size:
                rows, row_tiers = sub.cube.lookup_ex(group, pending,
                                                     version=pv)
                for i, k in enumerate(pending.tolist()):
                    t = int(row_tiers[i])
                    if t == TIER_DEFAULT:
                        srow = self._stale_get(sub.cache_key(group, k))
                        if srow is not None:
                            fetched[k] = srow
                            tiers[k] = TIER_STALE_CACHE
                            continue
                    fetched[k] = rows[i]
                    tiers[k] = t
            # only version-accurate rows (primary/replica — bit-identical
            # at the pin) may enter the cube cache; stale/default rows
            # would poison later requests with silently-wrong tier-0 hits
            ok = {k: r for k, r in fetched.items()
                  if tiers[k] <= TIER_REPLICA}
            if ok and sub.cube.version != pv.version:
                # a delta already published since the pin: filter the
                # known-stale keys out BEFORE inserting — an insert-then-
                # drop would expose them to concurrent readers for the
                # window between put_many and the drop. A cold touched-key
                # log forces the conservative skip-all.
                touched = sub.updates.touched_since(pv.version)
                ok = ({} if touched is None else
                      {k: r for k, r in ok.items()
                       if sub.cache_key(group, k) not in touched[0]})
            if ok:
                sub.cube_cache.put_many(
                    [sub.cache_key(group, k) for k in ok],
                    [ok[k][None] for k in ok])
                # close the remaining cache-aside race: a delta may have
                # published (and run its targeted invalidation) between
                # the pre-insert check and the insert above, which would
                # resurrect pre-delta rows as fresh entries. Drop our own
                # inserts for exactly the keys deltas touched since the
                # pin; a cold touched-key log forces the conservative
                # full drop.
                if sub.cube.version != pv.version:
                    touched = sub.updates.touched_since(pv.version)
                    own = {sub.cache_key(group, k): k for k in ok}
                    drop = (list(own) if touched is None else
                            [ck for ck in own if ck in touched[0]])
                    if drop:
                        sub.cube_cache.invalidate_keys(drop)
            by_key.update(fetched)
            tier_by_key.update(tiers)
        # refresh the stale side buffer with every version-accurate row
        # this sweep resolved (cache hits included)
        self._stale_put(sub, group,
                        {k: by_key[k] for k in by_key
                         if tier_by_key[k] <= TIER_REPLICA})
        return by_key, tier_by_key

    def op(self, batch, ctx):
        sub = self.rt.substrate
        primary = self.rt.cube_groups[0][0] if self.rt.cube_groups else None
        worst = [TIER_PRIMARY] * len(batch)
        with sub.cube.pin() as pv:
            rows_all = [dict() for _ in batch]
            for fname, group, _vocab in self.rt.cube_groups:
                keys = [int(ev.payload["hashed"][fname]) for ev in batch]
                by_key, tier_by_key = self._fetch_group(group, keys, pv)
                for i, (out, k) in enumerate(zip(rows_all, keys)):
                    out[fname] = np.asarray(by_key[k], np.float32)
                    worst[i] = max(worst[i], tier_by_key[k])
            # recovery warm-up (DESIGN.md §9): while the substrate is
            # replaying its delta log, every row it serves may predate the
            # log head — honest answers, stale attribution. Floor the tier
            # at TIER_STALE_CACHE so responses declare it (the service
            # serves degraded rather than failing), without masking a
            # ladder rung that is already worse.
            if getattr(sub, "recovering", False):
                worst = [max(t, TIER_STALE_CACHE) for t in worst]
            for ev, out, tier in zip(batch, rows_all, worst):
                ev.payload["cube_rows_all"] = out
                if primary is not None:
                    # the primary group's row keeps its historical payload
                    # slot (and the packed batch's ``cube_tail``)
                    ev.payload["cube_rows"] = out[primary]
                ev.payload["cube_version"] = pv.version
                ev.payload["degraded_tier"] = int(tier)
                annotate(ev, cube_version=pv.version,
                         degraded_tier=int(tier))
                if tier > TIER_PRIMARY:
                    ev.meta["_degraded"] = True
            if getattr(sub.cube, "is_mesh", False):
                # attach this batch's shard scatter/gather as child spans
                # (one shard_fanout parent + one shard_fetch per shard
                # sub-batch) to every traced event — `critical_path` /
                # `shard_profile` then attribute the fetch tail to the
                # slowest shard. Inserted before the open exec span; each
                # event gets its own copies.
                fan = sub.cube.take_fanout()
                if fan:
                    proto = shard_fanout_spans(fan)
                    for ev in batch:
                        add_child_spans(ev, [dict(s, attrs=dict(s["attrs"]))
                                             for s in proto])
        # post-fetch deadline check: a fetch that burned the whole budget
        # on breaker probes / slow disk marks the event now, so the NEXT
        # dispatch sheds it before it ever occupies the model stage
        now = ctx.now() if ctx is not None and hasattr(ctx, "now") else None
        if now is not None:
            for ev in batch:
                if ev.deadline_at is not None and now >= ev.deadline_at:
                    ev.meta["timed_out"] = True
        return batch


class ShedStage(Stage):
    """Online load shedding: the IRM pruning DNN + live quota controller
    wrapped as a typed stage (the shedder also serves as the bounded-
    channel overflow policy — see ``OnlineShedder.on_overflow``)."""
    name = "shed"
    requires = ("candidates",)
    provides = ()
    batch_size = 8
    parallelism = 1

    def __init__(self, shedder):
        self.shedder = shedder

    def op(self, batch, ctx):
        return self.shedder.op(batch, ctx)


class RerankStage(Stage):
    """The DNN stage of a ranking scenario: pointwise scores for the whole
    micro-batch through the jitted ``serve_scores`` (batch padded to a
    bucket), plus the fused one-user-many-candidates re-rank of each
    request's surviving candidate set.

    Owns the query-cache insert and BOTH its staleness guards: scores are
    stamped with the model version captured before binding the generation
    (a racing hot swap can only over-invalidate), and the delta-side
    cache-aside guard drops exactly the batch items deltas touched since
    the events' pinned cube versions."""
    name = "rerank"
    requires = ("user_id", "item_id", "user_fields", "item_fields",
                "cube_rows")
    provides = ("score", "generation", "topk")
    batch_size = 16
    parallelism = 1

    def __init__(self, rt, keep: int = 12):
        self.rt = rt
        self.keep = keep
        if rt.model_cfg.seq_len:
            self.requires = self.requires + ("hist",)
        if rt.rerank is None or not rt.model_cfg.seq_len:
            self.provides = ("score", "generation")

    def op(self, batch, ctx):
        rt = self.rt
        sub = rt.substrate
        # capture the query-cache model version BEFORE binding the
        # generation: a hot swap racing this batch can only over-invalidate
        qv = sub.query_cache.model_version
        gen = rt.buffer.active          # ONE generation for the batch
        params = gen.payload
        B = len(batch)
        payloads = [ev.payload for ev in batch]
        # pad to the covering batch bucket (bounded jit-trace count);
        # scores are per-row, so slicing [:B] discards the filler exactly
        padded = rt.batch_buckets.pad_rows(payloads)
        b = rt.pack_batch(padded)
        scores = rt.serve(params, b).cpu().numpy()[:B]
        now = ctx.now() if ctx is not None else 0.0
        for ev, s in zip(batch, scores):
            ev.payload["score"] = float(s)
            ev.payload["generation"] = gen.stamp
            annotate(ev, batch_bucket=len(padded), generation=gen.stamp)
            rt.rerank_candidates(params, ev.payload, keep=self.keep)
        sub.query_cache.put_many(
            [rt.user_key(ev.payload) for ev in batch],
            [ev.payload["item_id"] for ev in batch],
            [float(s) for s in scores], now, version=qv)
        # delta-side cache-aside guard (the query-cache twin of the cube
        # stage's): these scores embed cube rows fetched at the events'
        # pinned versions — if a delta published since, its
        # invalidate_items may have run BEFORE our insert, resurrecting a
        # stale score. Drop exactly the batch items deltas touched since
        # the earliest pin; a cold touched-key log forces the drop.
        vmin = min((ev.payload.get("cube_version", 0) for ev in batch),
                   default=0)
        if sub.cube.version != vmin:
            items = {ev.payload["item_id"] for ev in batch}
            touched = sub.updates.touched_since(vmin)
            if touched is not None:
                items &= touched[1]
            if items:
                sub.query_cache.invalidate_items(items)
        return batch


class RetrievalStage(Stage):
    """Terminal stage of a retrieval scenario (MIND / two-tower): one
    query against the request's candidate set through the scenario's
    ``retrieve`` head, shape-bucketed like the fused re-rank. No
    pointwise score and no query-cache insert — retrieval responses are
    top-k lists, not (user, item) scores."""
    name = "retrieve"
    requires = ("user_fields", "candidates")
    provides = ("topk", "generation")
    batch_size = 8
    parallelism = 1

    def __init__(self, rt, keep: int = 12):
        self.rt = rt
        self.keep = keep
        if rt.model_cfg.seq_len:
            self.requires = self.requires + ("hist",)

    def op(self, batch, ctx):
        rt = self.rt
        gen = rt.buffer.active
        for ev in batch:
            ev.payload["topk"] = rt.retrieve_candidates(
                gen.payload, ev.payload, keep=self.keep)
            ev.payload["generation"] = gen.stamp
        return batch


class RespondStage(Stage):
    """Sink: stamps a typed ``Response`` onto every event's meta."""
    name = "respond"
    requires = ()
    provides = ()
    batch_size = 32
    parallelism = 1

    def op(self, batch, ctx):
        for ev in batch:
            ev.meta["response"] = Response.from_event(ev)
        return batch
