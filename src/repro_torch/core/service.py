"""The deployable JiZHI service, composed from the scenario API.

:class:`InferenceService` — the single-scenario surface (DESIGN.md §7):
``InferenceService(cfg)`` builds one scenario from a
:class:`ServiceConfig` with the historic stage names (ingress →
query_cache → features → cube → shed → rerank → respond) and attribute
layout. Its model runs on ``cuda`` unless the caller passes
``device="cpu"``.

The multi-scenario composition (``MultiScenarioService``) waits for the
DIEN and MIND ports (ROADMAP A4); snapshots and recovery wait for A5.

The stage logic itself lives in ``repro_torch.serve.stages`` (typed
processors owning version pinning and cache-aside guards) and
``repro_torch.serve.scenario`` (specs, substrate, pipeline builder,
build-time payload-contract checks).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.executors import AsyncExecutor, SimExecutor
from repro_torch.core.sedp import Event
from repro_torch.serve.scenario import (PipelineBuilder, ScenarioSpec,
                                        ServingSubstrate,
                                        SubstrateDeltaWatcher,
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

    def make_substrate(self) -> ServingSubstrate:
        kw = dict(
            cube_cache_ratio=self.cube_cache_ratio,
            query_window_s=self.query_window_s,
            head_slots=self.head_slots,
            compact_after_blocks=self.compact_after_blocks,
            reverse_map_items=self.reverse_map_items, seed=self.seed)
        return _recover_or_build(self, kw)


def _recover_or_build(cfg, substrate_kw: dict) -> ServingSubstrate:
    """Boot a substrate per config. Snapshots and the snapshot-then-replay
    restart are not ported yet (ROADMAP A5): asking for them raises."""
    if getattr(cfg, "recover", False) or getattr(cfg, "snapshot_dir", None):
        raise NotImplementedError(
            "cube snapshots and recovery (update/snapshot.py) are not "
            "ported yet (ROADMAP A5)")
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
        if getattr(self.cfg, "live_updates", False) and self.cfg.update_dir:
            return SubstrateDeltaWatcher(
                self.substrate, self.cfg.update_dir,
                poll_s=self.cfg.update_poll_s)
        return None

    def shutdown(self):
        """Quiesce the update watcher (the final snapshot of the
        reference's planned restart waits for the snapshot port, A5)."""
        self.stop_updates()

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

    ``device``: where the model and the pruning DNN run — ``cuda`` unless
    the caller passes ``device="cpu"`` (then the kernels' plain versions
    run). ``model_cfg`` / ``params`` / ``pruning_dnn`` inject the model
    config, its weights and a trained pruning DNN (parity runs against
    the reference, full-width runs); without them the service builds the
    reduced config, draws weights from ``cfg.seed`` and trains its own
    pruning DNN, as the reference does."""

    def __init__(self, cfg: ServiceConfig = ServiceConfig(), device=None,
                 model_cfg=None, params=None, pruning_dnn=None):
        self.cfg = cfg
        self.substrate = cfg.make_substrate()
        builder = PipelineBuilder(self.substrate, max_queue=cfg.max_queue,
                                  batch_wait_s=cfg.batch_wait_s,
                                  device=device)
        builder.add_ingress("ingress")
        rt = builder.add_scenario(cfg.to_scenario_spec(), namespaced=False,
                                  model_cfg=model_cfg, params=params,
                                  pruning_dnn=pruning_dnn)
        self.device = builder.device
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
