"""Online load shedding via a pruning DNN (paper §6.2, Fig. 6, Table 7).

Funnel context: recall hands ~10³ candidates per request to the expensive
re-rank stage; only ~a dozen are shown. When traffic exceeds capacity, prune
low-quality candidates per-request, bounded by a recommendation-effectiveness
constraint |L* − L̂| ≤ ε (Eq. 2).

  * Features (Table 7): quota (available resource), previous cutoff ratio,
    queue id, and the recall-score statistics (avg/var/max/min).
  * The pruning DNN is an ultra-lightweight MLP (decides in ~μs) trained to
    imitate the ORACLE cutoff: the largest prune such that the expected
    recall@K loss ≤ ε, shrunk further as quota tightens.
  * Candidates are sorted by recall score; everything behind the cutoff is
    dropped before re-rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.models.layers import mlp_tower_apply, mlp_tower_init
from repro_torch.obs.trace import annotate

FEATURES = ("quota", "cutoff_ratio_prev", "qid",
            "escore_avg", "escore_variance", "escore_max", "escore_min")


def features_from(scores: np.ndarray, quota: float, prev_cutoff: float,
                  qid: int) -> np.ndarray:
    return np.array([quota, prev_cutoff, float(qid % 16) / 16.0,
                     float(scores.mean()), float(scores.var()),
                     float(scores.max()), float(scores.min())], np.float32)


def oracle_cutoff(scores: np.ndarray, quota: float, eps: float,
                  k: int = 12) -> float:
    """Max prune ratio with bounded effectiveness loss: keep every candidate
    that could plausibly reach the final top-k (score within the ε-quantile
    band of the k-th best), then shed further only as quota forces it."""
    s = np.sort(scores)[::-1]
    n = len(s)
    kth = s[min(k, n) - 1]
    # ε-band: items scoring within eps-quantile of the k-th score may reorder
    # under the re-rank model; they must survive
    thresh = kth - eps * (s[0] - s[-1] + 1e-9)
    must_keep = int(np.sum(s >= thresh))
    quota_keep = int(np.ceil(n * min(1.0, max(quota, 0.02))))
    keep = max(k, min(n, max(must_keep, quota_keep) if quota >= 1.0
                      else max(k, min(must_keep, quota_keep))))
    keep = max(keep, k)
    return 1.0 - keep / n


class PruningDNN:
    """7 → 32 → 16 → 1 sigmoid MLP: predicts the cutoff ratio.

    ``params`` (an ``mlp_tower_init`` list), ``x_mean`` and ``x_std`` are
    tensors on ``device``; a trained reference DNN carries over through
    ``repro_torch.convert.params_from_numpy``."""

    def __init__(self, seed: int = 0, device=None):
        self.device = default_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = mlp_tower_init(gen, len(FEATURES), (32, 16, 1),
                                     torch.float32, device=self.device)
        self.x_mean = torch.zeros(len(FEATURES), device=self.device)
        self.x_std = torch.ones(len(FEATURES), device=self.device)

    @staticmethod
    def _fwd(params, x):
        return torch.sigmoid(mlp_tower_apply(params, x, act="silu")[..., 0])

    def __call__(self, feats: np.ndarray) -> np.ndarray:
        # standardize in the wider of the two dtypes (float64 statistics of
        # float64 features stay float64, as in numpy), then run in float32
        x = torch.as_tensor(np.atleast_2d(feats), device=self.device)
        x = ((x - self.x_mean) / self.x_std).to(torch.float32)
        with torch.no_grad():
            y = self._fwd(self.params, x)
        return y.cpu().numpy()

    def fit(self, X: np.ndarray, y: np.ndarray, steps: int = 2000,
            lr: float = 3e-3, seed: int = 0) -> float:
        """Minibatch MSE fit with the reference's update: Adam-like moments
        (β1=0.9, β2=0.999) and NO bias correction — not torch.optim.Adam,
        which corrects the moments and so computes another trajectory."""
        rng = np.random.default_rng(seed)
        # feature standardization (quota ~O(1) but variance features are not)
        x_mean = X.mean(0)
        x_std = X.std(0) + 1e-6
        self.x_mean = torch.as_tensor(x_mean, device=self.device)
        self.x_std = torch.as_tensor(x_std, device=self.device)
        Xt = torch.as_tensor((X - x_mean) / x_std, dtype=torch.float32,
                             device=self.device)
        yt = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        leaves = [p[k] for p in self.params for k in sorted(p)]
        m = [torch.zeros_like(p) for p in leaves]
        v = [torch.zeros_like(p) for p in leaves]

        def loss(xb, yb):
            return torch.mean((self._fwd(self.params, xb) - yb) ** 2)

        for _ in range(steps):
            idx = torch.as_tensor(rng.integers(0, Xt.shape[0], 256),
                                  device=self.device)
            for p in leaves:
                p.requires_grad_(True)
            grads = torch.autograd.grad(loss(Xt[idx], yt[idx]), leaves)
            with torch.no_grad():
                for p, g, mm, vv in zip(leaves, grads, m, v):
                    p.requires_grad_(False)
                    mm.mul_(0.9).add_(0.1 * g)
                    vv.mul_(0.999).add_(0.001 * g * g)
                    p.sub_(lr * mm / (torch.sqrt(vv) + 1e-8))
        with torch.no_grad():
            return float(loss(Xt, yt))


def train_pruning_dnn(n_samples: int = 4000, eps: float = 0.05,
                      seed: int = 0, steps: int = 2000, device=None
                      ) -> tuple[PruningDNN, float]:
    """Generate oracle-labelled synthetic funnel traffic and fit the DNN."""
    rng = np.random.default_rng(seed)
    X, y = [], []
    prev = 0.0
    for i in range(n_samples):
        # candidate-count and score distributions matched to the serving
        # traffic (lognormal funnel sizes; mixed score shapes)
        n = int(np.clip(rng.lognormal(np.log(120), 1.0), 8, 2000))
        mode = rng.choice(4)
        if mode == 0:
            scores = rng.beta(2, 5, n)
        elif mode == 1:
            scores = rng.beta(5, 2, n)
        elif mode == 2:
            scores = rng.random(n)
        else:
            scores = rng.normal(0.5, 0.15, n).clip(0, 1)
        quota = float(rng.uniform(0.02, 1.2))
        cut = oracle_cutoff(scores, quota, eps)
        X.append(features_from(scores, quota, prev, i))
        y.append(cut)
        prev = cut
    dnn = PruningDNN(seed, device=device)
    mse = dnn.fit(np.stack(X), np.array(y, np.float32), steps=steps)
    return dnn, mse


@dataclass
class ShedderState:
    prev_cutoff: float = 0.0
    shed_events: int = 0
    kept_events: int = 0
    dropped_requests: int = 0     # whole requests shed at a full channel
    overflow_pruned: int = 0      # requests hard-pruned at a full channel


class QuotaController:
    """Live quota from intermediate system feedback (paper §6.2: the policy
    is "fine-tuned over intermediate system feedback").

    Maps the downstream stage's queue depth and server utilization
    (``ExecContext.queue_depth`` / ``ExecContext.utilization``, i.e.
    StageStats) to the 'available resource' feature of Table 7, smoothed
    with an EWMA so a single burst doesn't whipsaw the cutoff. Quota 1.0 ≈
    free capacity; → 0.02 as the downstream saturates."""

    def __init__(self, downstream: str = "rerank",
                 depth_capacity: float = 64.0, alpha: float = 0.35,
                 expiry_weight: float = 8.0,
                 warmup_fn: Optional[Callable[[], bool]] = None,
                 warmup_quota: float = 0.25):
        self.downstream = downstream
        self.depth_capacity = depth_capacity
        self.alpha = alpha
        # deadline-expiry shedding signal (DESIGN.md §8.4): requests dying
        # of old age downstream are the most direct overload evidence
        # there is — weight each fresh expiration this many queue-depth
        # units when folding it into the quota
        self.expiry_weight = expiry_weight
        # recovery warm-up clamp (DESIGN.md §9): while ``warmup_fn()`` is
        # truthy (the substrate is replaying its delta log), admitted
        # quota is capped at ``warmup_quota`` regardless of how idle the
        # downstream looks — a just-restarted node serving from a cold
        # cache must not take full load before replay catches up. The
        # EWMA keeps integrating the real signal underneath, so the clamp
        # lifting is a step back to the true quota, not a cold restart of
        # the controller.
        self.warmup_fn = warmup_fn
        self.warmup_quota = warmup_quota
        self._q = 1.0
        self._last_expired = 0

    def observe(self, ctx) -> float:
        depth = (ctx.queue_depth(self.downstream)
                 if hasattr(ctx, "queue_depth") else 0)
        raw = self.depth_capacity / (depth + self.depth_capacity)
        if hasattr(ctx, "utilization"):
            util = ctx.utilization(self.downstream)
            if util > 1.0:      # demand exceeds service capacity: clamp hard
                raw = min(raw, 1.0 / (util * util))
        if hasattr(ctx, "total_expired"):
            exp = ctx.total_expired()
            d_exp = exp - self._last_expired
            self._last_expired = exp
            if d_exp > 0:       # requests are expiring NOW: cut quota like
                # an equivalent queue-depth surge would
                raw = min(raw, self.depth_capacity
                          / (self.depth_capacity + self.expiry_weight * d_exp))
        self._q += self.alpha * (raw - self._q)
        q = float(np.clip(self._q, 0.02, 1.2))
        if self.warmup_fn is not None and self.warmup_fn():
            q = min(q, self.warmup_quota)
        return q

    @property
    def value(self) -> float:
        return float(np.clip(self._q, 0.02, 1.2))


class OnlineShedder:
    """SEDP-stage wrapper: reads system feedback → quota, prunes candidate
    lists in event payloads (payload["candidates"] = list of (item, score)).

    Two hooks into the serving loop:
      * ``op`` — the in-pipeline stage (quota-aware per-request pruning);
      * ``on_overflow`` — the bounded-channel overflow policy (SimExecutor):
        a full downstream queue offers the event here, which hard-prunes it
        to ``min_keep`` or, when nothing is left to prune, sheds the whole
        request (returns None).
    """

    def __init__(self, dnn: PruningDNN, capacity_qps_proxy: float = 100.0,
                 min_keep: int = 12, downstream: str = "rerank",
                 controller: Optional[QuotaController] = None):
        self.dnn = dnn
        self.capacity = capacity_qps_proxy
        self.min_keep = min_keep
        self.downstream = downstream
        self.controller = controller
        self.state = ShedderState()

    def quota(self, queue_depth: int) -> float:
        return float(np.clip(self.capacity / (queue_depth + self.capacity), 0.02, 1.2))

    def current_quota(self, ctx) -> float:
        if self.controller is not None:
            return self.controller.observe(ctx)
        depth = (ctx.queue_depth(self.downstream)
                 if hasattr(ctx, "queue_depth") else 0)
        return self.quota(depth)

    def on_overflow(self, stage: str, ev, ctx):
        """Bounded-channel overflow hook. Prune hard; drop when already
        minimal. Returning None sheds the request at the channel.

        Accounting: candidates the shed stage already tallied (meta marker)
        MOVE from kept to shed here — counting them afresh would make
        shed+kept exceed the candidates that ever existed."""
        cands = (ev.payload.get("candidates")
                 if hasattr(ev.payload, "get") else None)
        counted = bool(ev.meta.get("shed_accounted")) if cands else False
        if cands and len(cands) > self.min_keep:
            scores = np.array([c[1] for c in cands], np.float32)
            order = np.argsort(-scores)[:self.min_keep]
            kept = [cands[i] for i in order]
            n_shed = len(cands) - len(kept)
            self.state.shed_events += n_shed
            if counted:
                self.state.kept_events -= n_shed
            else:
                self.state.kept_events += len(kept)
                ev.meta["shed_accounted"] = True
            self.state.overflow_pruned += 1
            ev.payload["candidates"] = kept
            ev.meta["overflow_pruned"] = True
            return ev
        if counted and cands:            # whole request (and its candidates)
            self.state.shed_events += len(cands)   # sheds at the channel
            self.state.kept_events -= len(cands)
        self.state.dropped_requests += 1
        return None

    def op(self, batch, ctx):
        q = self.current_quota(ctx)
        for ev in batch:
            cands = ev.payload.get("candidates", [])
            if not cands:
                continue
            scores = np.array([c[1] for c in cands], np.float32)
            feats = features_from(scores, q, self.state.prev_cutoff,
                                  ev.req_id)
            cut = float(self.dnn(feats[None])[0])
            keep = max(self.min_keep, int(len(cands) * (1.0 - cut)))
            order = np.argsort(-scores)
            kept = [cands[i] for i in order[:keep]]
            self.state.shed_events += len(cands) - len(kept)
            self.state.kept_events += len(kept)
            self.state.prev_cutoff = cut
            ev.payload["candidates"] = kept
            ev.meta["cutoff_ratio"] = cut
            ev.meta["shed_accounted"] = True
            annotate(ev, cutoff_ratio=round(cut, 4),
                     shed=len(cands) - len(kept), kept=len(kept))
        return batch
