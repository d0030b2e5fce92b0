"""The deployable JiZHI services, composed from the scenario API.

Two surfaces (DESIGN.md §7):

  * :class:`MultiScenarioService` — the Model-as-a-Service composition:
    N declaratively-registered scenarios (DIN re-rank, DIEN sequential
    scoring, MIND/two-tower retrieval, ...) compiled into ONE SEDP DAG
    behind the quota-aware multi-tenant fanout, all sharing one
    cube / cube-cache / query-cache / streaming-update substrate.
  * :class:`InferenceService` — the single-scenario surface:
    ``InferenceService(cfg)`` builds one scenario from a
    :class:`ServiceConfig` with the historic stage names (ingress →
    query_cache → features → cube → shed → rerank → respond) and
    attribute layout.

Models, and the HBM head table where one is configured, run on ``cuda``
unless the caller passes ``device="cpu"``.

The stage logic itself lives in ``repro_torch.serve.stages`` (typed
processors owning version pinning and cache-aside guards) and
``repro_torch.serve.scenario`` (specs, substrate, pipeline builder,
build-time payload-contract checks).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

from repro_torch import default_device
from repro_torch.core.executors import AsyncExecutor, SimExecutor
from repro_torch.core.irm.shedding import QuotaController
from repro_torch.core.multitenant import make_fanout_op
from repro_torch.core.sedp import Event
from repro_torch.serve.scenario import (PipelineBuilder, ScenarioSpec,
                                        ServingSubstrate,
                                        SubstrateDeltaWatcher, get_scenario,
                                        make_request_events)


@dataclass
class ServiceConfig:
    arch_id: str = "din"
    batch_size: int = 16
    cube_cache_ratio: float = 1.0
    query_window_s: float = 120.0
    shed: bool = True
    seed: int = 0
    # closed-loop serving knobs: bounded stage channels (backpressure) and
    # the per-stage micro-batching window (collect batch_size or wait)
    max_queue: int = 512
    batch_wait_s: float = 0.002
    # shape buckets for the jitted rerank stage: the micro-batcher hands it
    # whatever batch it collected and the shedder whatever candidate set
    # survived, so without padding every distinct (B, C, T_hist) is a fresh
    # XLA trace. None → powers of two up to the relevant maximum.
    rerank_buckets: Optional[tuple] = None     # batch dimension B
    cand_buckets: Optional[tuple] = None       # per-request candidate count C
    # live-update stage (DESIGN.md §6): tail a delta log and apply versioned
    # parameter deltas to the cube/caches/head while traffic flows
    live_updates: bool = False
    update_dir: Optional[str] = None
    update_poll_s: float = 0.1
    compact_after_blocks: int = 64
    head_slots: int = 0            # >0 → HBM head tier for promoted hot rows
    # bound on the per-group bucket → raw-items reverse map (entries over
    # the cap are invalidated-and-forgotten — over-invalidation is safe)
    reverse_map_items: int = 65536
    # crash safety (DESIGN.md §9): periodic durable cube snapshots + the
    # snapshot-then-replay restart path. ``recover=True`` boots from the
    # newest valid snapshot under ``snapshot_dir`` when one exists (cold
    # boot otherwise); with live updates configured, replay streams
    # through the watcher while the service serves degraded.
    snapshot_dir: Optional[str] = None
    snapshot_every_deltas: int = 8
    snapshot_keep: int = 2
    recover: bool = False

    def to_scenario_spec(self) -> ScenarioSpec:
        """The ServiceConfig → ScenarioSpec migration mapping (DESIGN.md
        §7.5): model/pipeline knobs move onto the spec; substrate knobs
        (caches, live updates, head) configure the ServingSubstrate."""
        return ScenarioSpec(
            name=self.arch_id, arch_id=self.arch_id, pipeline="rerank",
            shed=self.shed, batch_size=self.batch_size,
            batch_buckets=self.rerank_buckets,
            cand_buckets=self.cand_buckets, seed=self.seed)

    def make_substrate(self, device=None) -> ServingSubstrate:
        """The substrate this config describes; ``device`` is where its
        HBM head table lies (``cuda`` unless ``device="cpu"``)."""
        kw = dict(device=device,
            cube_cache_ratio=self.cube_cache_ratio,
            query_window_s=self.query_window_s,
            head_slots=self.head_slots,
            compact_after_blocks=self.compact_after_blocks,
            reverse_map_items=self.reverse_map_items, seed=self.seed)
        return _recover_or_build(self, kw)


@dataclass
class MultiServiceConfig:
    """Knobs of the multi-scenario composition. ``scenarios`` may hold
    ScenarioSpec objects or names registered in configs/jizhi_service.py;
    empty → the default 3-scenario surface (DIN + DIEN + MIND)."""
    scenarios: tuple = ()
    cube_cache_ratio: float = 1.0
    query_window_s: float = 120.0
    seed: int = 0
    max_queue: int = 512
    batch_wait_s: float = 0.002
    # fanout quota gate: below this, only priority-0 scenarios get clones
    min_quota: float = 0.5
    live_updates: bool = False
    update_dir: Optional[str] = None
    update_poll_s: float = 0.1
    compact_after_blocks: int = 64
    head_slots: int = 0
    reverse_map_items: int = 65536
    # crash safety (DESIGN.md §9) — same contract as ServiceConfig
    snapshot_dir: Optional[str] = None
    snapshot_every_deltas: int = 8
    snapshot_keep: int = 2
    recover: bool = False


def _recover_or_build(cfg, substrate_kw: dict) -> ServingSubstrate:
    """Boot a substrate per config: from the newest valid snapshot when
    ``cfg.recover`` asks for it and one exists, cold otherwise. With live
    updates configured, replay is left to the watcher (the service serves
    degraded while the suffix streams in); without one, the pending deltas
    replay inline so the substrate is caught up on return."""
    if getattr(cfg, "recover", False) and cfg.snapshot_dir:
        from repro_torch.update.snapshot import latest_valid_snapshot
        if latest_valid_snapshot(cfg.snapshot_dir) is not None:
            return ServingSubstrate.recover(
                cfg.snapshot_dir, update_dir=cfg.update_dir,
                replay=not (cfg.live_updates and cfg.update_dir),
                **substrate_kw)
    return ServingSubstrate(**substrate_kw)


class _ServiceBase:
    """Shared run/update machinery of the service surfaces."""

    substrate: ServingSubstrate
    cfg = None
    plan = None

    # ------------------------------------------------------- properties
    @property
    def query_cache(self):
        return self.substrate.query_cache

    @property
    def cube_cache(self):
        return self.substrate.cube_cache

    @property
    def cube(self):
        return self.substrate.cube

    @property
    def updates(self):
        return self.substrate.updates

    # ------------------------------------------------------ live updates
    def _make_watcher(self):
        self.snapshotter = None
        if getattr(self.cfg, "snapshot_dir", None):
            from repro_torch.update.snapshot import CubeSnapshotter
            self.snapshotter = CubeSnapshotter(
                self.substrate, self.cfg.snapshot_dir,
                every_deltas=self.cfg.snapshot_every_deltas,
                keep=self.cfg.snapshot_keep,
                delta_log_dir=getattr(self.cfg, "update_dir", None))
        if getattr(self.cfg, "live_updates", False) and self.cfg.update_dir:
            return SubstrateDeltaWatcher(
                self.substrate, self.cfg.update_dir,
                poll_s=self.cfg.update_poll_s,
                snapshotter=self.snapshotter)
        return None

    # ------------------------------------------------- graceful shutdown
    def shutdown(self):
        """Planned restart (DESIGN.md §9): quiesce the update watcher and
        take a final snapshot at the quiescent cursor, so the next boot
        with ``recover=True`` replays ZERO deltas. Returns the snapshot
        path (None when nothing advanced since the last snapshot, or no
        snapshotter is configured)."""
        self.stop_updates()
        if self.snapshotter is not None:
            return self.snapshotter.graceful_shutdown()
        return None

    def install_shutdown_hook(self, chain: bool = True):
        """SIGTERM → :meth:`shutdown` (preemption notice → final
        snapshot), chaining to the previous handler like the training
        side's emergency checkpoint hook."""
        if self.snapshotter is None:
            raise RuntimeError("no snapshotter configured "
                               "(set snapshot_dir)")
        return self.snapshotter.install_sigterm_hook(chain=chain)

    def start_updates(self):
        """Start the live-update stage (requires cfg.live_updates +
        cfg.update_dir): a watcher thread tails the delta log and applies
        each published version while traffic keeps flowing."""
        if self.update_watcher is None:
            raise RuntimeError("live updates not configured "
                               "(set live_updates=True and update_dir)")
        self.update_watcher.start()

    def stop_updates(self):
        if self.update_watcher is not None:
            self.update_watcher.stop()

    # --------------------------------------------------------------- run
    def _overflow_policy(self):
        raise NotImplementedError

    def run(self, n_requests: int = 64, executor: str = "async",
            rate_qps: float = 500.0, deadline_s: Optional[float] = None,
            tracer=None, exact_latencies: bool = True):
        """Serve n_requests end to end. ``executor="async"`` is the real
        threaded path (bounded channels block upstream — backpressure);
        ``executor="sim"`` runs the identical DAG on the virtual clock with
        the shedders as the bounded-channel overflow policy.

        ``deadline_s`` gives every request a latency budget: an event that
        outlives it is shed at the next stage dispatch and finishes as a
        timed-out terminal (``Response.timed_out``, DESIGN.md §8.4).

        ``tracer`` (an ``obs.Tracer``) records per-request span trees on
        either executor; ``exact_latencies=False`` drops the raw latency
        list from the report (the log-bucketed histogram remains)."""
        reqs = self.make_requests(n_requests, seed=self.cfg.seed,
                                  deadline_s=deadline_s)
        if executor == "async":
            rep = AsyncExecutor(self.plan, tracer=tracer,
                                exact_latencies=exact_latencies).run(reqs)
        elif executor == "sim":
            ex = SimExecutor(self.plan,
                             overflow_policy=self._overflow_policy(),
                             tracer=tracer, exact_latencies=exact_latencies)
            rep = ex.run([(i / rate_qps, ev) for i, ev in enumerate(reqs)])
        else:
            raise ValueError(f"unknown executor {executor!r}")
        # expired/errored events short-circuit past RespondStage — give
        # them a typed Response too so callers see ONE result surface
        from repro_torch.serve.stages import Response
        for ev in rep.results:
            if "response" not in ev.meta:
                ev.meta["response"] = Response.from_event(ev)
        return rep


class InferenceService(_ServiceBase):
    """Single-scenario wrapper over the scenario API: the full JiZHI stack
    around a real PyTorch ranking model (SEDP DAG + query cache + cube
    cache/cube + online load shedding + the recsys model as the DNN stage,
    its hot path in hand-written CUDA kernels, with hot-loading via
    DoubleBuffer).

    ``device``: where the model, the pruning DNN and the HBM head table
    run — ``cuda`` unless the caller passes ``device="cpu"`` (then the
    kernels' plain versions run). ``model_cfg`` / ``params`` /
    ``pruning_dnn`` inject the model config, its weights and a trained
    pruning DNN (parity runs against the reference, full-width runs);
    without them the service builds the reduced config, draws weights from
    ``cfg.seed`` and trains its own pruning DNN, as the reference does."""

    def __init__(self, cfg: ServiceConfig = ServiceConfig(), device=None,
                 model_cfg=None, params=None, pruning_dnn=None):
        self.cfg = cfg
        # one device for the head table and the model
        self.device = default_device(device)
        self.substrate = cfg.make_substrate(self.device)
        builder = PipelineBuilder(self.substrate, max_queue=cfg.max_queue,
                                  batch_wait_s=cfg.batch_wait_s,
                                  device=self.device)
        builder.add_ingress("ingress")
        rt = builder.add_scenario(cfg.to_scenario_spec(), namespaced=False,
                                  model_cfg=model_cfg, params=params,
                                  pruning_dnn=pruning_dnn)
        builder.g.add_edge("ingress", builder.entries[rt.spec.name])
        self.graph, self.plan = builder.compile()
        self._rt = rt
        # historic attribute surface (tests/examples poke these directly)
        self.model_cfg = rt.model_cfg
        self.mod = rt.mod
        self.buffer = rt.buffer
        self.shedder = rt.shedder
        self.rerank_buckets = rt.batch_buckets
        self.cand_buckets = rt.cand_buckets
        self.hist_buckets = rt.hist_buckets
        self._serve = rt.serve
        self._rerank = rt.rerank
        self._pack_batch = rt.pack_batch
        self.update_watcher = self._make_watcher()

    @property
    def _bucket_items(self):
        """Primary group's bucket → raw-items reverse map (bounded)."""
        return self.substrate.bucket_items[self._rt.cube_groups[0][1]].buckets

    def make_requests(self, n: int, seed: int = 0,
                      deadline_s: Optional[float] = None) -> list[Event]:
        return make_request_events([self.model_cfg], n, seed=seed,
                                   deadline_s=deadline_s)

    def _overflow_policy(self):
        return self.shedder.on_overflow if self.shedder else None


class MultiScenarioService(_ServiceBase):
    """N scenario pipelines behind the quota-aware multi-tenant fanout,
    one shared substrate (paper §4 multi-tenant extension + §8.6 Service
    E: several models share the upstream data plane and >80% of feature
    groups).

    DAG shape::

        ingress → fanout ──→ <s1>.query_cache → ... → <s1>.rerank ──→ respond
                         └─→ <s2>...                                ↗
                         └─→ <s3>...                                ↗

    The fanout clones each request to every scenario (payloads cloned so
    per-scenario stages never write into a sibling's view); under
    overload the quota controller gates secondary scenarios first —
    priority-0 scenarios keep serving while the rest ride out the spike.

    ``device``: where every scenario's model, the shared pruning DNN and
    the HBM head table run — ``cuda`` unless the caller passes
    ``device="cpu"``.
    ``model_cfgs`` / ``params`` map scenario names to an injected model
    config and weights (parity runs carry the reference's across; a
    deployment may serve the published widths); ``pruning_dnn`` replaces
    the shared trained pruning DNN. A scenario without an entry gets its
    arch's reduced config and weights drawn from its spec's seed, as in
    the reference."""

    def __init__(self, cfg: Union[MultiServiceConfig, Sequence, None] = None,
                 device=None, model_cfgs: Optional[dict] = None,
                 params: Optional[dict] = None, pruning_dnn=None):
        if cfg is None:
            cfg = MultiServiceConfig()
        elif not isinstance(cfg, MultiServiceConfig):
            cfg = MultiServiceConfig(scenarios=tuple(cfg))
        self.cfg = cfg
        model_cfgs, params = model_cfgs or {}, params or {}
        specs = []
        names = cfg.scenarios or _default_scenario_names()
        for s in names:
            specs.append(s if isinstance(s, ScenarioSpec)
                         else get_scenario(s))
        if not specs:
            raise ValueError("MultiScenarioService needs ≥1 scenario")
        unknown = (set(model_cfgs) | set(params)) - {s.name for s in specs}
        if unknown:
            raise ValueError(f"injected configs/params for scenarios not "
                             f"served: {sorted(unknown)}")
        self.device = default_device(device)
        self.substrate = _recover_or_build(cfg, dict(
            device=self.device, cube_cache_ratio=cfg.cube_cache_ratio,
            query_window_s=cfg.query_window_s, head_slots=cfg.head_slots,
            compact_after_blocks=cfg.compact_after_blocks,
            reverse_map_items=cfg.reverse_map_items, seed=cfg.seed))
        builder = PipelineBuilder(self.substrate, max_queue=cfg.max_queue,
                                  batch_wait_s=cfg.batch_wait_s,
                                  device=self.device)
        builder.add_ingress("ingress")
        for spec in specs:
            builder.add_scenario(spec, namespaced=True,
                                 model_cfg=model_cfgs.get(spec.name),
                                 params=params.get(spec.name),
                                 pruning_dnn=pruning_dnn)
        # quota signal: the primary (lowest-priority-number) scenario's
        # terminal queue — the stage overload hits first
        primary = min(specs, key=lambda s: (s.priority, specs.index(s)))
        self.fanout_controller = QuotaController(
            builder.terminals[primary.name], depth_capacity=64.0)
        targets = [builder.entries[s.name] for s in specs]
        priorities = {builder.entries[s.name]: s.priority for s in specs}
        fan = make_fanout_op(targets, priorities=priorities,
                             quota_fn=self.fanout_controller.observe,
                             min_quota=cfg.min_quota)
        builder.g.add_stage("fanout", fan, batch_size=8, parallelism=1,
                            max_queue=cfg.max_queue,
                            max_wait_s=cfg.batch_wait_s)
        builder.g.add_edge("ingress", "fanout")
        for t in targets:
            builder.g.add_edge("fanout", t)
        self.graph, self.plan = builder.compile()
        self.specs = tuple(specs)
        self.runtimes = builder.runtimes
        self.entries = builder.entries
        self.terminals = builder.terminals
        self.update_watcher = self._make_watcher()

    # ------------------------------------------------------------ traffic
    def make_requests(self, n: int, seed: int = 0,
                      deadline_s: Optional[float] = None) -> list[Event]:
        return make_request_events(
            [rt.model_cfg for rt in self.runtimes.values()], n, seed=seed,
            deadline_s=deadline_s)

    def _overflow_policy(self):
        def policy(stage, ev, ctx):
            name = stage.split(".", 1)[0]
            rt = self.runtimes.get(name)
            if rt is not None and rt.shedder is not None:
                return rt.shedder.on_overflow(stage, ev, ctx)
            return ev
        return policy

    # ------------------------------------------------------------ results
    @staticmethod
    def by_scenario(report) -> dict:
        """Completed events grouped by the scenario that served them."""
        out: dict = {}
        for ev in report.results:
            get = ev.payload.get if hasattr(ev.payload, "get") else None
            name = (get("scenario", "?") if get else "?") or "?"
            out.setdefault(name, []).append(ev)
        return out

    @staticmethod
    def responses(report) -> list:
        """Typed Response objects (stamped by RespondStage)."""
        return [ev.meta["response"] for ev in report.results
                if "response" in ev.meta]


def _default_scenario_names() -> tuple:
    from repro_torch.configs import jizhi_service
    return jizhi_service.DEFAULT_SCENARIOS
