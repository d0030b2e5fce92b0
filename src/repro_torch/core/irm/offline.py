"""Offline auto-tuning for quasi-optimal resource allocation (paper §6.1).

Pipeline (Eq. 1):
  1. LOGS    — sweep random knob vectors through the service simulator,
               recording per-stage latency F^L_j and resource F^R_j targets.
  2. MODELS  — fit the RidgeEnsemble predictors (noisy, biased, and
               non-differentiable in the useful sense — hence CMA-ES).
  3. SEARCH  — CMA-ES-with-constraints minimizes Σ_j F^R_j subject to
               F^L_j(θ) ≤ F^L_j(θ̄) for every stage j (N constraints).
  4. VALIDATE— the paper re-runs constraint-satisfied minima from the CMA-ES
               SOLUTION PATH on 5% of live traffic; we re-run them in the
               full simulator and pick the true winner.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.irm.cmaes import cmaes_minimize
from repro_torch.core.irm.models import RidgeEnsemble
from repro_torch.core.service_model import (Knobs, ServiceSpec, derive_instances,
                                      run_service)

STAGE_KEYS = ("user_proc", "item_extract", "item_proc", "cube_access", "dnn")


def _stage_latency(report, key: str) -> float:
    """Mean busy time per event for stages matching key (dnn_* aggregated)."""
    tot_busy = tot_ev = 0.0
    for name, st in report.stage_stats.items():
        if name.startswith(key):
            tot_busy += st.busy_s
            tot_ev += st.events
    return tot_busy / max(1.0, tot_ev)


def logs_from_history(history_dir: str):
    """Load (X, lat, res) training logs from a ``StatsRecorder`` history
    directory (the durable artifact a live service records — DESIGN.md
    §10.4). Returns None when the directory holds no IRM samples, so
    callers can fall back to a fresh sweep."""
    from repro_torch.obs.recorder import read_history
    X, lat, res = [], [], []
    for s in read_history(history_dir):
        irm = (s.get("extra") or {}).get("irm")
        if not irm:
            continue
        X.append(np.asarray(irm["knobs"], float))
        lat.append(np.asarray(irm["stage_latency_s"], float))
        res.append(float(irm["instances"]))
    if not X:
        return None
    return np.stack(X), np.stack(lat), np.array(res)


def collect_logs(spec: ServiceSpec, n_samples: int = 60, n_events: int = 1200,
                 rate_qps: float = 1200.0, seed: int = 0,
                 history_dir: str | None = None):
    """Historical logs: (knob vector → per-stage latencies, instances).

    With ``history_dir`` set, previously recorded history is REUSED when
    present (the paper's IRM searches over logs the serving fleet already
    produced, not fresh sweeps); otherwise the sweep runs and every sample
    is recorded there through a ``StatsRecorder`` — so the next tuning run,
    and any other consumer, reads the same durable artifact."""
    if history_dir is not None:
        loaded = logs_from_history(history_dir)
        if loaded is not None:
            return loaded
    recorder = None
    if history_dir is not None:
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.obs.recorder import StatsRecorder
        recorder = StatsRecorder(history_dir, MetricsRegistry(),
                                 window_samples=max(1, n_samples))
    rng = np.random.default_rng(seed)
    X, lat, res = [], [], []
    bounds = [(lo, hi) for _, lo, hi in Knobs.BOUNDS]
    for i in range(n_samples):
        x = np.array([rng.uniform(lo, hi) for lo, hi in bounds])
        k = Knobs.from_vector(x)
        rep, rt, inst = run_service(spec, k, n_events=n_events,
                                    rate_qps=rate_qps, seed=seed + i)
        stage_lat = [_stage_latency(rep, s) for s in STAGE_KEYS]
        X.append(k.to_vector())
        lat.append(stage_lat)
        res.append(float(inst))
        if recorder is not None:
            recorder.sample(extra={"irm": {
                "knobs": [float(v) for v in k.to_vector()],
                "stage_latency_s": [float(v) for v in stage_lat],
                "instances": float(inst),
                "avg_latency_s": float(rep.avg_latency),
                "p99_latency_s": float(rep.latency_percentile(0.99)),
                "seed": seed + i,
            }})
    if recorder is not None:
        recorder.roll()
    return np.stack(X), np.stack(lat), np.array(res)


@dataclass
class TuneResult:
    knobs_before: Knobs
    knobs_after: Knobs
    instances_before: int
    instances_after: int
    latency_before_ms: float
    latency_after_ms: float
    candidates_tried: int = 0

    @property
    def instance_gain(self) -> float:
        return 1.0 - self.instances_after / max(1, self.instances_before)


def autotune(spec: ServiceSpec, n_log_samples: int = 60,
             n_events: int = 1200, rate_qps: float = 1200.0,
             budget: int = 1500, seed: int = 0,
             latency_slack: float = 1.02,
             history_dir: str | None = None) -> TuneResult:
    default = Knobs()
    X, lat, res = collect_logs(spec, n_log_samples, n_events, rate_qps, seed,
                               history_dir=history_dir)

    f_r = RidgeEnsemble(seed=seed).fit(X, res)
    f_l = [RidgeEnsemble(seed=seed + 1 + j).fit(X, lat[:, j])
           for j in range(len(STAGE_KEYS))]

    # baseline (default knobs) — both predicted and simulated
    rep0, rt0, inst0 = run_service(spec, default, n_events=n_events * 2,
                                   rate_qps=rate_qps, seed=seed + 777)
    lat0 = np.array([_stage_latency(rep0, s) for s in STAGE_KEYS])

    def objective(x):
        return float(f_r(x))

    def constraints(x):
        # F^L_j(θ) ≤ F^L_j(default)·slack  ∀j   (Eq. 1's N constraints)
        return np.array([f(x) - latency_slack * l0
                         for f, l0 in zip(f_l, lat0)])

    bounds = [(lo, hi) for _, lo, hi in Knobs.BOUNDS]
    result = cmaes_minimize(objective, default.to_vector(), 0.3, bounds,
                            constraints=constraints, budget=budget, seed=seed)

    # paper step: validate constraint-satisfied path minima on real traffic
    candidates = result.best_feasible_candidates(k=6) or []
    best_k, best_inst, best_lat = default, inst0, rep0.avg_latency
    tried = 0
    for cand in candidates:
        k = Knobs.from_vector(cand.x)
        rep, rt, inst = run_service(spec, k, n_events=n_events * 2,
                                    rate_qps=rate_qps, seed=seed + 777)
        tried += 1
        if (inst < best_inst
                and rep.avg_latency <= rep0.avg_latency * latency_slack):
            best_k, best_inst, best_lat = k, inst, rep.avg_latency
    return TuneResult(default, best_k, inst0, best_inst,
                      rep0.avg_latency * 1e3, best_lat * 1e3, tried)
