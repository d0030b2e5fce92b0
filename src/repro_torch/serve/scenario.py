"""Scenario API: declarative multi-scenario serving (DESIGN.md §7).

JiZHI serves twenty-plus heterogeneous recommendation services through ONE
staged-pipeline abstraction. This module is that surface for the repro:

  * ``ScenarioSpec`` — a declarative description of one serving scenario
    (arch id, pipeline shape, bucketing menus, cache/shed knobs). Adding a
    scenario is composition, not a fork of service.py.
  * ``ScenarioRuntime`` — the per-scenario model state (params buffer,
    jitted entry points, shape bucketers, cube feature groups) compiled
    from a spec against a shared :class:`ServingSubstrate`.
  * ``ServingSubstrate`` — ONE cube / cube-cache / query-cache / update
    subsystem shared by N scenario pipelines. Feature groups are keyed by
    ``(field_name, vocab)`` so scenarios with common fields share rows
    (paper §8.6: Service E's three tenants share >80% of feature groups).
  * ``PipelineBuilder`` — compiles specs into one SEDP DAG out of the
    typed stage processors (serve/stages.py), validating every stage's
    payload contract at BUILD time (`ContractError`), not mid-traffic.

``InferenceService`` (core/service.py) is a thin compatibility wrapper
over a single-scenario build.

In the port, each runtime's model lives on one torch device (``cuda``
unless the caller passes ``device="cpu"``) and every model input is built
there. The scenarios whose models are ported are DIN's; the HBM head
tier, snapshots/recovery and the mesh cube tier are not ported yet and
raise ``NotImplementedError`` (ROADMAP A4/A5).
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.configs import registry
from repro_torch.obs.log import log_event
from repro_torch.core import sedp as sedp_lib
from repro_torch.core.cube import ParameterCube
from repro_torch.core.cube_cache import TwoTierLFUCache, capacity_from_ratio
from repro_torch.core.irm.shedding import (OnlineShedder, QuotaController,
                                     train_pruning_dnn)
from repro_torch.core.query_cache import QueryCache
from repro_torch.core.sedp import SEDP, Event, GraphError
from repro_torch.serve.bucketing import (ShapeBucketer, TracedJit,
                                   bucketed_candidate_rerank, pow2_buckets,
                                   step_buckets)
from repro_torch.models.recsys import din
from repro_torch.serve.hotload import DoubleBuffer, Generation
from repro_torch.serve.stages import (REQUEST_KEYS, CubeFetchStage,
                                FeatureHashStage, QueryCacheStage,
                                RerankStage, RespondStage, RetrievalStage,
                                Request, Response, ShedStage, Stage,
                                stage_of)
from repro_torch.update import (DeltaWatcher, PromoteDemotePolicy,
                                UpdateManager)

log = logging.getLogger(__name__)

__all__ = [
    "Request", "Response", "ScenarioSpec", "ScenarioRuntime",
    "ServingSubstrate", "PipelineBuilder", "ContractError",
    "BoundedReverseMap", "SubstrateDeltaWatcher", "register_scenario",
    "get_scenario", "registered_scenarios", "make_request_events",
]


class ContractError(GraphError):
    """A stage's payload contract cannot be satisfied on every path that
    reaches it — raised at build time, never mid-traffic."""


# ------------------------------------------------------------------ spec

@dataclass(frozen=True)
class ScenarioSpec:
    """Declarative description of one serving scenario.

    ``pipeline`` picks the terminal model stage: ``"rerank"`` (pointwise
    scores + fused candidate re-rank — DIN/DIEN-style ranking) or
    ``"retrieval"`` (top-k against the candidate set, no pointwise score —
    MIND/two-tower recall). The data-plane stages (query cache, feature
    hashing, cube fetch, shedding) are toggled per scenario; every enabled
    stage runs against the shared substrate."""
    name: str
    arch_id: str
    pipeline: str = "rerank"              # "rerank" | "retrieval"
    query_cache: bool = True
    cube_fetch: bool = True
    shed: bool = True
    priority: int = 1                     # fanout tier; 0 = never shed
    batch_size: int = 16
    keep: int = 12                        # response top-k size
    batch_buckets: Optional[tuple] = None  # DNN batch dimension B
    cand_buckets: Optional[tuple] = None   # candidate count C
    hist_bucket_step: int = 8              # history length T menu step
    seed: int = 0

    def __post_init__(self):
        if self.pipeline not in ("rerank", "retrieval"):
            raise ValueError(f"scenario {self.name!r}: unknown pipeline "
                             f"{self.pipeline!r}")


_REGISTRY: dict[str, ScenarioSpec] = {}


def register_scenario(spec: ScenarioSpec, replace: bool = False) -> ScenarioSpec:
    if spec.name in _REGISTRY and not replace:
        raise ValueError(f"scenario {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_scenario(name: str) -> ScenarioSpec:
    # registrations live in configs/jizhi_service.py; import lazily so the
    # registry is populated on first lookup without an import cycle
    if name not in _REGISTRY:
        import repro_torch.configs.jizhi_service  # noqa: F401  (registers)
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def registered_scenarios() -> tuple[ScenarioSpec, ...]:
    import repro_torch.configs.jizhi_service  # noqa: F401
    return tuple(_REGISTRY.values())


# ------------------------------------------------------ bounded reverse map

class BoundedReverseMap:
    """Per-group hashed-bucket → raw-items reverse map with a bound.

    The unbounded version was a slow memory leak: a long-lived service
    accumulates one entry per distinct raw item ever seen (item churn
    never shrinks it). The bound prunes whole buckets once ``total`` items
    exceed ``max_items`` — coldest first when an LFU signal is available
    (``counts_fn``, fed by the cube cache's persistent counts), insertion
    order otherwise.

    Coherence: the map exists to find which query-cache items a delta
    invalidates, so FORGETTING a mapping silently would under-invalidate.
    ``maybe_prune`` therefore returns the dropped raw items and the caller
    must invalidate them from the query cache first — pruning can only
    over-invalidate (safe, mildly wasteful), never leave a stale score.

    Every accessor takes the lock: stage workers ``add`` and the update
    thread reads ``items_for`` concurrently with pruning — an unlocked
    add racing a prune could land an item in a just-popped set (a mapping
    silently lost WITHOUT invalidation — exactly the stale-score hole the
    prune contract exists to prevent), and an unlocked read could iterate
    a set mid-mutation. The critical sections are tiny (per-batch dict
    ops), so the lock is cheap next to the stage's model work."""

    def __init__(self, max_items: int = 65536, prune_fraction: float = 0.25,
                 counts_fn: Optional[Callable] = None):
        assert max_items > 0 and 0.0 < prune_fraction < 1.0
        self.max_items = max_items
        self.prune_fraction = prune_fraction
        self.counts_fn = counts_fn
        self.buckets: dict[int, set] = {}
        self.total = 0
        self._lock = threading.Lock()

    def add(self, bucket: int, item: int):
        with self._lock:
            s = self.buckets.get(bucket)
            if s is None:
                s = self.buckets.setdefault(bucket, set())
            if item not in s:
                s.add(item)
                self.total += 1

    def items_for(self, hashed_ids) -> list:
        out: list = []
        with self._lock:
            for h in hashed_ids:
                out.extend(self.buckets.get(int(h), ()))
        return out

    def export(self) -> dict:
        """Locked deep copy of bucket → items, for snapshot persistence
        (DESIGN.md §9: persisted reverse maps make warm-start invalidation
        exact after a restart)."""
        with self._lock:
            return {b: set(s) for b, s in self.buckets.items()}

    def maybe_prune(self) -> list:
        """Evict down to ``max_items * (1 - prune_fraction)`` once over the
        cap; returns the raw items whose mappings were dropped (the caller
        invalidates them — over-invalidation is safe)."""
        if self.total <= self.max_items:      # racy fast path: prune is
            return []                         # re-checked under the lock
        with self._lock:
            if self.total <= self.max_items:
                return []
            victims = list(self.buckets)
            if self.counts_fn is not None:
                counts = {b: self.counts_fn(b) for b in victims}
                victims.sort(key=counts.__getitem__)
            target = int(self.max_items * (1.0 - self.prune_fraction))
            dropped: list = []
            for b in victims:
                if self.total <= target:
                    break
                s = self.buckets.pop(b, None)
                if s:
                    self.total -= len(s)
                    dropped.extend(s)
            return dropped


# -------------------------------------------------------------- substrate

class ServingSubstrate:
    """The shared data plane: ONE parameter cube, cube cache, query cache,
    HBM head and update manager serving every scenario pipeline.

    Feature groups register through :meth:`group_for`, keyed by
    ``(field_name, vocab)`` — two scenarios naming the same field share the
    group's rows, cache entries and delta stream. Each registration loads
    the group's tail table, grows the cube-cache capacity, creates the
    group's bounded reverse map, and re-splits the HBM head budget across
    the per-group promote/demote policies."""

    def __init__(self, cube_cache_ratio: float = 1.0,
                 query_window_s: float = 120.0, tail_dim: int = 4,
                 n_servers: int = 4, replication: int = 2,
                 block_rows: int = 4096, head_slots: int = 0,
                 compact_after_blocks: int = 64,
                 compact_max_rows_per_pass: Optional[int] = None,
                 reverse_map_items: int = 65536, seed: int = 0):
        if head_slots:
            raise NotImplementedError(
                "the HBM head tier (update/hbm_head.py) is not ported yet "
                "(ROADMAP A5); use head_slots=0")
        self.tail_dim = tail_dim
        self.cube_cache_ratio = cube_cache_ratio
        self.head_slots = head_slots
        self.reverse_map_items = reverse_map_items
        self.query_cache = QueryCache(window_s=query_window_s)
        self.cube_cache = TwoTierLFUCache(0, 0)
        self.cube = ParameterCube(
            n_servers=n_servers, replication=replication,
            block_rows=block_rows)
        # warm-up state (DESIGN.md §9): while True, CubeFetchStage floors
        # every fetch at the stale-cache degradation tier and the quota
        # controllers shed against the warm-up quota; cleared once delta
        # replay reaches ``recovery_target``
        self.recovering = False
        self.recovery_target = -1
        self.last_replay_s = 0.0     # duration of the last delta-log replay
        self._rng = np.random.default_rng(seed)
        self._groups: dict[tuple[str, int], int] = {}
        self.bucket_items: dict[int, BoundedReverseMap] = {}
        self.updates = UpdateManager(
            self.cube, cube_cache=self.cube_cache,
            query_cache=self.query_cache, head=None,
            qcache_items_fn=self.items_for_buckets,
            compact_after_blocks=compact_after_blocks,
            compact_max_rows_per_pass=compact_max_rows_per_pass)

    # ---------------------------------------------------------- groups
    def cache_key(self, group: int, key: int):
        """Cube-cache key convention (must match the UpdateManager's
        ``cache_key_fn``): bare id for group 0, (group, id) otherwise."""
        return key if group == 0 else (group, key)

    def group_for(self, field_name: str, vocab: int) -> int:
        key = (field_name, int(vocab))
        if key in self._groups:
            return self._groups[key]
        g = len(self._groups)
        self._groups[key] = g
        self.cube.load_table(g, self._rng.normal(
            0, 0.01, (int(vocab), self.tail_dim)).astype(np.float32))
        mem, disk = capacity_from_ratio(int(vocab) * self.tail_dim,
                                        self.cube_cache_ratio)
        self.cube_cache.mem.capacity += mem
        self.cube_cache.disk.capacity += disk
        self.bucket_items[g] = BoundedReverseMap(
            max_items=self.reverse_map_items,
            counts_fn=lambda b, g=g: self._lfu_count(g, b))
        if self.updates.head is not None:
            # re-split the head budget: every registered group gets an
            # equal slice of the shared slot pool
            cap = max(1, self.head_slots // len(self._groups))
            self.updates.policies = {
                gid: PromoteDemotePolicy(capacity=cap)
                for gid in self._groups.values()}
        return g

    def replay_update_log(self, update_dir: str) -> int:
        """Apply every published delta past the current cursor, strictly
        in version order (the recovery replay — same ``read_delta`` /
        ``apply`` path as live tailing, same idempotence under re-offer).
        Clears ``recovering`` once the cursor reaches the recovery target.
        Returns the number of deltas applied."""
        from repro_torch.update.delta import list_deltas, read_delta, verify_delta
        t0 = time.perf_counter()
        n = 0
        for _ver, path in list_deltas(
                update_dir,
                after_version=self.updates.stats.last_version):
            verify_delta(path)
            self.updates.apply(read_delta(path))
            n += 1
        if n:
            self.last_replay_s = time.perf_counter() - t0
            log_event(log, "delta_log_replayed", n_deltas=n,
                      version=self.updates.stats.last_version,
                      duration_s=self.last_replay_s)
        if (self.recovering
                and self.updates.stats.last_version
                >= self.recovery_target):
            self.finish_recovery()
        return n

    def finish_recovery(self):
        """Replay caught up: leave warm-up mode (full tiers, full quota)."""
        self.recovering = False

    @property
    def groups(self) -> dict[tuple[str, int], int]:
        return dict(self._groups)

    def _lfu_count(self, group: int, bucket: int) -> int:
        k = self.cache_key(group, bucket)
        return max(self.cube_cache.mem.counts.get(k, 0),
                   self.cube_cache.disk.counts.get(k, 0))

    def items_for_buckets(self, group: int, hashed_ids) -> list:
        """Raw item ids whose cached scores embed the given cube rows —
        the UpdateManager's query-cache invalidation key set, per group."""
        rmap = self.bucket_items.get(group)
        return [] if rmap is None else rmap.items_for(hashed_ids)


class SubstrateDeltaWatcher(DeltaWatcher):
    """The live-update stage of a substrate: tail the delta log, apply
    through the shared UpdateManager, then run the off-hot-path
    maintenance a fresh batch warrants — overlay compaction, the
    per-group promote/demote pass, and (when a ``snapshotter`` is wired)
    the periodic durable snapshot.

    With a snapshotter, ``prune_applied`` is forced OFF: recovery must
    find the delta suffix past the newest snapshot on disk, so retention
    moves to the snapshotter's GC (which floors pruning on this watcher's
    cursor). The cursor starts at the substrate's delta cursor — on a
    recovered substrate the watcher resumes exactly where replay left
    off."""

    def __init__(self, substrate: ServingSubstrate, update_dir: str,
                 snapshotter=None, **kw):
        if snapshotter is not None:
            kw["prune_applied"] = False
        else:
            # the substrate is its delta log's only consumer → prune
            # applied deltas so the log directory (and each poll's scan)
            # stays bounded
            kw.setdefault("prune_applied", True)
        kw.setdefault("start_after_version",
                      substrate.updates.stats.last_version)
        super().__init__(update_dir, substrate.updates.apply, **kw)
        self._sub = substrate
        self.snapshotter = snapshotter
        if snapshotter is not None:
            snapshotter.register_watcher(self)

    def check_once(self) -> bool:
        applied = super().check_once()
        if applied:
            self._sub.updates.maybe_compact()
            if self._sub.updates.head is not None:
                self._sub.updates.rebalance_all()
            if self.snapshotter is not None:
                self.snapshotter.maybe_snapshot()
        if (self._sub.recovering
                and self._sub.updates.stats.last_version
                >= self._sub.recovery_target):
            self._sub.finish_recovery()
        return applied


# ---------------------------------------------------------------- runtime

#: Recsys model modules of the port, by ``RecsysConfig.model``.
MODELS = {"din": din}

class ScenarioRuntime:
    """Per-scenario model state compiled from a spec: params buffer,
    shape-bucketed (and signature-counted) model entry points on one torch
    device, and the scenario's cube feature groups on the shared substrate.

    ``model_cfg`` and ``params`` may be injected (parity tests carry the
    reference's weights across; a deployment may serve the published
    widths); otherwise the config is the arch's reduced one and the
    params are drawn from a generator seeded with ``spec.seed``, as the
    reference does."""

    def __init__(self, spec: ScenarioSpec, substrate: ServingSubstrate,
                 qcache_scope: bool = False, device=None, model_cfg=None,
                 params=None):
        self.spec = spec
        self.substrate = substrate
        self.device = default_device(device)
        if model_cfg is None:
            arch = registry.get(spec.arch_id)
            model_cfg = arch.reduced(arch.config)
        self.model_cfg = model_cfg
        if model_cfg.model not in MODELS:
            raise NotImplementedError(
                f"model {model_cfg.model!r} is not ported yet (ROADMAP A4); "
                f"ported: {sorted(MODELS)}")
        self.mod = MODELS[model_cfg.model]
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(spec.seed)
            params = self.mod.init(gen, model_cfg, device=self.device)
        self.buffer = DoubleBuffer(Generation(0, params))
        # any scenario's generation swap bumps the shared query cache's
        # model version (over-invalidation across scenarios: safe)
        self.buffer.on_swap.append(substrate.updates.on_generation_swap)
        self.qcache_scope = spec.name if qcache_scope else None
        self.shedder: Optional[OnlineShedder] = None
        mc = self.model_cfg
        self.batch_buckets = ShapeBucketer(
            spec.batch_buckets or pow2_buckets(spec.batch_size))
        self.cand_buckets = ShapeBucketer(
            spec.cand_buckets or pow2_buckets(64, min_size=16))
        # step-8 history buckets (DESIGN.md §5.3): padded history rows
        # still pay the full attention MLP, so tight T buckets win
        self.hist_buckets = (ShapeBucketer(
            step_buckets(mc.seq_len, step=spec.hist_bucket_step))
            if mc.seq_len else None)
        self.serve = TracedJit(
            lambda p, b: self.mod.serve_scores(p, b, self.model_cfg))
        # fused one-user-many-candidates re-rank (kernels/rerank_score via
        # score_candidates): full ranking of each request's candidate set
        self.rerank = (TracedJit(
            lambda p, u, c: self.mod.score_candidates(
                p, u, c, self.model_cfg, top_k=c["item_id"].shape[0]))
            if hasattr(self.mod, "score_candidates") else None)
        retrieve_fn = getattr(self.mod, "retrieve", None)
        self.retrieve = None if retrieve_fn is None else TracedJit(
            lambda p, u, c: retrieve_fn(
                p, u, c, self.model_cfg, top_k=c["item_id"].shape[0]))
        # every single-valued item field becomes a cube feature group on
        # the shared substrate (bag>1 fields have no single tail row)
        self.cube_groups = [
            (f.name, substrate.group_for(f.name, f.vocab), f.vocab)
            for f in mc.item_fields if f.bag == 1]

    # -------------------------------------------------------- helpers
    def user_key(self, payload):
        """Query-cache user key — scenario-scoped in a multi-scenario
        service so one scenario's score never answers another's probe."""
        uid = payload["user_id"]
        return (self.qcache_scope, uid) if self.qcache_scope else uid

    def _to_device(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def pack_batch(self, payloads: list) -> dict:
        """Stack the payloads' model inputs into one batch of tensors on
        the runtime's device (ids int64, cube rows float32)."""
        mc = self.model_cfg
        batch = {"user": {"fields": {
            f.name: self._to_device(np.stack([p["user_fields"][f.name]
                                              for p in payloads]))
            for f in mc.user_fields}},
            "item": {f.name: self._to_device(np.stack(
                [p["item_fields"][f.name] for p in payloads]))
                for f in mc.item_fields}}
        # cube output attached upstream becomes a model input: the primary
        # group's host-tier rows keep their historical ``cube_tail`` slot,
        # and the full multi-group fetch rides along concatenated
        if all("cube_rows" in p for p in payloads):
            batch["item"]["cube_tail"] = self._to_device(
                np.stack([p["cube_rows"] for p in payloads]), torch.float32)
        if all("cube_rows_all" in p for p in payloads) and payloads and \
                len(payloads[0]["cube_rows_all"]) > 1:
            names = sorted(payloads[0]["cube_rows_all"])
            batch["item"]["cube_tail_all"] = self._to_device(np.stack(
                [np.concatenate([p["cube_rows_all"][n] for n in names])
                 for p in payloads]), torch.float32)
        if mc.seq_len:
            batch["user"]["hist"] = self._to_device(
                np.stack([p["hist"] for p in payloads]))
        return batch

    def rerank_candidates(self, params, payload, keep: int = 12):
        """Full re-rank of the request's surviving candidate set through
        the fused shared-history scorer, every dimension bucketed."""
        mc = self.model_cfg
        cands = payload.get("candidates")
        if not cands or self.rerank is None or not mc.seq_len:
            return
        payload["topk"] = bucketed_candidate_rerank(
            self.rerank, params, payload["hist"],
            {f.name: payload["user_fields"][f.name] for f in mc.user_fields},
            cands, self.cand_buckets, self.hist_buckets,
            item_fields=[(f.name, f.bag) for f in mc.item_fields
                         if f.name != "item_id"], keep=keep,
            device=self.device)

    def retrieve_candidates(self, params, payload, keep: int = 12) -> list:
        """One query against the candidate set through the scenario's
        ``retrieve`` head (bucketed C and, when the model uses history,
        bucketed T)."""
        mc = self.model_cfg
        cands = payload.get("candidates")
        if not cands or self.retrieve is None:
            return []
        return bucketed_candidate_rerank(
            self.retrieve, params,
            payload["hist"] if mc.seq_len else None,
            {f.name: payload["user_fields"][f.name] for f in mc.user_fields},
            cands, self.cand_buckets, self.hist_buckets,
            item_fields=[(f.name, f.bag) for f in mc.item_fields
                         if f.name != "item_id"], keep=keep,
            device=self.device)


# ---------------------------------------------------------------- builder

def validate_contracts(plan, ingress_keys) -> dict:
    """Walk the compiled DAG in topo order and prove every typed stage's
    ``requires`` is available on EVERY path that can reach it (multi-pred
    stages take the intersection — an event may arrive from any one).
    Returns the per-stage available-key map; raises ContractError."""
    avail: dict[str, set] = {}
    for n in plan.order:
        if not plan.preds[n]:
            incoming = set(ingress_keys)
        else:
            sets = []
            for p in plan.preds[n]:
                ps = stage_of(plan.stages[p].op)
                sets.append(avail[p] | set(ps.provides if ps else ()))
            incoming = set.intersection(*sets)
        st = stage_of(plan.stages[n].op)
        if st is not None:
            missing = [k for k in st.requires if k not in incoming]
            if missing:
                raise ContractError(
                    f"stage {n!r} requires payload keys {missing} that are "
                    f"not guaranteed on every path into it "
                    f"(available: {sorted(incoming)})")
        avail[n] = incoming
    return avail


def _tag_entry(op, scenario: str):
    """Wrap a scenario's entry-stage op to stamp the scenario name on each
    event (fanout clones arrive untagged)."""
    def wrapped(batch, ctx):
        for ev in batch:
            ev.payload["scenario"] = scenario
            ev.meta["tenant"] = scenario
        return op(batch, ctx)
    wrapped._stage = stage_of(op)
    return wrapped


class PipelineBuilder:
    """Compiles ScenarioSpecs into one SEDP DAG over a shared substrate.

    ``add_scenario`` instantiates the spec's stage chain (namespaced
    ``<name>.<stage>`` in a multi-scenario graph, bare names otherwise —
    the InferenceService compatibility surface), wires it into the shared
    ``respond`` sink, and returns the ScenarioRuntime. ``compile``
    validates every payload contract and returns (graph, plan).

    Every scenario's model (and the shared pruning DNN) lives on
    ``device``: ``cuda`` unless the caller passes ``device="cpu"``."""

    def __init__(self, substrate: ServingSubstrate, max_queue: int = 512,
                 batch_wait_s: float = 0.002, device=None):
        self.substrate = substrate
        self.device = default_device(device)
        self.g = SEDP()
        self.kw = dict(max_queue=max_queue, max_wait_s=batch_wait_s)
        self.runtimes: dict[str, ScenarioRuntime] = {}
        self.entries: dict[str, str] = {}
        self.terminals: dict[str, str] = {}
        self._has_respond = False
        self._shed_dnn = None

    # ------------------------------------------------------- shared bits
    def ensure_respond(self) -> str:
        if not self._has_respond:
            st = RespondStage()
            self.g.add_stage("respond", st.op, batch_size=st.batch_size,
                             parallelism=st.parallelism, **self.kw)
            self._has_respond = True
        return "respond"

    def add_ingress(self, name: str = "ingress", op=None,
                    batch_size: int = 8, parallelism: int = 2) -> str:
        self.g.add_stage(name, op or sedp_lib.passthrough,
                         batch_size=batch_size, parallelism=parallelism,
                         **self.kw)
        return name

    def shed_dnn(self, seed: int = 0):
        """One pruning DNN shared by every scenario's shedder (the
        OnlineShedder state stays per scenario)."""
        if self._shed_dnn is None:
            self._shed_dnn, _ = train_pruning_dnn(n_samples=800, seed=seed,
                                                  device=self.device)
        return self._shed_dnn

    # --------------------------------------------------------- scenarios
    def add_scenario(self, spec: ScenarioSpec, namespaced: bool = True,
                     shedder: Optional[OnlineShedder] = None,
                     model_cfg=None, params=None, pruning_dnn=None
                     ) -> ScenarioRuntime:
        """``model_cfg`` / ``params`` are handed to the ScenarioRuntime;
        ``pruning_dnn`` replaces the builder's trained shared pruning DNN
        for this scenario's shedder (e.g. a DNN carried across from the
        reference for a parity run)."""
        if spec.name in self.runtimes:
            raise GraphError(f"scenario {spec.name!r} already added")
        rt = ScenarioRuntime(spec, self.substrate, qcache_scope=namespaced,
                             device=self.device, model_cfg=model_cfg,
                             params=params)
        respond = self.ensure_respond()
        prefix = f"{spec.name}." if namespaced else ""
        terminal: Stage = (RerankStage(rt, keep=spec.keep)
                           if spec.pipeline == "rerank"
                           else RetrievalStage(rt, keep=spec.keep))
        terminal_name = prefix + terminal.name
        stages: list[Stage] = []
        if spec.query_cache:
            stages.append(QueryCacheStage(rt, hit_route=respond))
        stages.append(FeatureHashStage(rt))
        if spec.cube_fetch:
            stages.append(CubeFetchStage(rt))
        if spec.shed:
            # warmup_fn ties the controller to the substrate's recovery
            # state: while replay catches up, admission is clamped to the
            # warm-up quota (serve degraded, not saturated)
            rt.shedder = shedder or OnlineShedder(
                pruning_dnn or self.shed_dnn(seed=spec.seed),
                downstream=terminal_name,
                controller=QuotaController(
                    terminal_name, depth_capacity=64.0,
                    warmup_fn=lambda: self.substrate.recovering))
            stages.append(ShedStage(rt.shedder))
        stages.append(terminal)
        names = [prefix + st.name for st in stages]
        if spec.query_cache:
            stages[0].miss_route = names[1]
        for i, (st, nm) in enumerate(zip(stages, names)):
            op = _tag_entry(st.op, spec.name) if i == 0 else st.op
            bs = spec.batch_size if st is terminal else st.batch_size
            self.g.add_stage(nm, op, batch_size=bs,
                             parallelism=st.parallelism, **self.kw)
        for a, b in zip(names, names[1:]):
            self.g.add_edge(a, b)
        if spec.query_cache:
            self.g.add_edge(names[0], respond)
        self.g.add_edge(names[-1], respond)
        self.runtimes[spec.name] = rt
        self.entries[spec.name] = names[0]
        self.terminals[spec.name] = terminal_name
        return rt

    # ------------------------------------------------------------ compile
    def default_ingress_keys(self) -> set:
        keys = set(REQUEST_KEYS) | {"candidates"}
        if any(rt.model_cfg.seq_len for rt in self.runtimes.values()):
            keys.add("hist")
        return keys

    def compile(self, ingress_keys=None):
        plan = self.g.compile()
        validate_contracts(plan, ingress_keys if ingress_keys is not None
                           else self.default_ingress_keys())
        return self.g, plan


# ------------------------------------------------------------ request gen

def make_request_events(model_cfgs, n: int, seed: int = 0,
                        n_candidates: int = 64,
                        deadline_s: Optional[float] = None) -> list[Event]:
    """Synthetic typed Requests covering the UNION of the given model
    configs' feature fields — one request stream that every scenario in a
    multi-scenario service can consume (each pipeline reads only the
    fields its config names).

    ``deadline_s`` attaches a per-request latency budget
    (``meta["deadline_s"]``): the executor stamps an absolute deadline at
    ingress and sheds the event at any later dispatch once it expires
    (DESIGN.md §8.4)."""
    from repro_torch.data import synthetic
    rng = np.random.default_rng(seed)
    user_fields: dict = {}
    item_fields: dict = {}
    for mc in model_cfgs:
        for f in mc.user_fields:
            user_fields.setdefault(f.name, f)
        for f in mc.item_fields:
            item_fields.setdefault(f.name, f)
    uf = synthetic.recsys_ids(rng, list(user_fields.values()), n)
    itf = synthetic.recsys_ids(rng, list(item_fields.values()), n)
    seq = max((mc.seq_len or 0) for mc in model_cfgs)
    hist = None
    if seq:
        h = synthetic.zipf_ids(rng, n * seq,
                               model_cfgs[0].item_fields[0].vocab
                               ).reshape(n, seq)
        lengths = rng.integers(1, seq + 1, n)
        mask = np.arange(seq)[None, :] < lengths[:, None]
        hist = np.where(mask, h, -1).astype(np.int32)
    uid_field = next(iter(user_fields.values()))
    evs = []
    for i in range(n):
        req = Request(
            user_id=(int(uf[uid_field.name][i]) if uid_field.bag == 1
                     else i),
            item_id=int(itf["item_id"][i]) if "item_id" in itf else i,
            user_fields={name: uf[name][i] for name in uf},
            item_fields={name: itf[name][i] for name in itf},
            hist=hist[i] if hist is not None else None,
            candidates=[(j, float(rng.random()))
                        for j in range(n_candidates)])
        ev = Event(payload=req)
        if deadline_s is not None:
            ev.meta["deadline_s"] = float(deadline_s)
        evs.append(ev)
    return evs
