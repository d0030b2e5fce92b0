"""Multi-tenant extension (paper §4): multiple DNNs in ONE pipeline.

Two production uses:
  * multi-objective / multi-phase inference — several models share the
    upstream data processing + sparse parameter access (Service E: CTR, FR,
    CMT share >80% of feature groups);
  * A/B testing — a dispatch stage splits traffic between test groups, each
    an independent SEDP branch on shared infrastructure (no per-variant
    service deployments, no manual traffic splitting).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.sedp import Event, propagate_trace


@dataclass
class TrafficSplit:
    """Deterministic hash-based splitting (stable per user — the standard
    requirement for A/B assignment)."""
    groups: dict[str, float]                 # stage-name → traffic fraction

    def __post_init__(self):
        total = sum(self.groups.values())
        self._cum = []
        acc = 0.0
        for name, frac in self.groups.items():
            acc += frac / total
            self._cum.append((acc, name))

    def assign(self, user_id: int) -> str:
        u = (hash(("ab", user_id)) % 10_000) / 10_000.0
        for edge, name in self._cum:
            if u < edge:
                return name
        return self._cum[-1][1]


def _clone_payload(payload):
    """Per-tenant payload clone via the payload's own ``copy()`` — a
    shallow copy for plain dicts, an independent-extras clone for the
    scenario API's typed Requests."""
    return payload.copy()


def make_dispatch_op(split: TrafficSplit, key: str = "user") -> Callable:
    """SEDP stage op routing each event to its test-group branch.
    ``key`` names the payload field carrying the stable A/B unit (the
    scenario API's typed Requests use ``"user_id"``)."""
    def op(batch: list[Event], ctx):
        for ev in batch:
            ev.route = split.assign(ev.payload[key])
            ev.meta["tenant"] = ev.route
        return batch
    return op


def make_balance_op(pick: Callable, on_unroutable: str = "error") -> Callable:
    """Replica-fleet dispatch (DESIGN.md §11.4): route each event to the
    entry stage chosen by ``pick(ev, ctx) -> Optional[str]`` — the fleet
    balancer's least-loaded/health-aware policy. ``pick`` returning None
    means no live replica: the event is terminal-errored (``error``) or
    left on its default route (``passthrough``) per ``on_unroutable``."""
    def op(batch: list[Event], ctx):
        out = []
        for ev in batch:
            target = pick(ev, ctx)
            if target is None:
                if on_unroutable == "error":
                    ev.meta["error"] = "no live replica"
                    ev.meta["_terminal"] = True
                out.append(ev)
                continue
            ev.route = target
            ev.meta["replica"] = target
            out.append(ev)
        return out
    return op


def make_fanout_op(targets: list[str],
                   priorities: Optional[dict[str, int]] = None,
                   quota_fn: Optional[Callable] = None,
                   min_quota: float = 0.5) -> Callable:
    """Multi-objective: clone each event to every tenant DNN (they share the
    already-computed features in the payload by reference).

    Closed-loop extension: under overload, secondary objectives are the
    first thing to shed. ``quota_fn(ctx) -> float`` is the live quota signal
    (e.g. ``QuotaController.observe``); when it drops below ``min_quota``,
    only priority-0 tenants (``priorities``, default: first target) receive
    clones — CTR keeps serving while FR/CMT ride out the spike."""
    priorities = priorities or {t: (0 if i == 0 else 1)
                                for i, t in enumerate(targets)}

    def op(batch: list[Event], ctx):
        live = targets
        if quota_fn is not None:
            q = quota_fn(ctx)
            if q < min_quota:
                live = [t for t in targets if priorities.get(t, 1) == 0]
                if not live:
                    # a priorities dict with no 0-rank entry must not shed
                    # EVERY tenant (events would vanish / Async would hang
                    # waiting on them): keep the best-ranked tier instead
                    best = min(priorities.get(t, 1) for t in targets)
                    live = [t for t in targets
                            if priorities.get(t, 1) == best]
        out = []
        for ev in batch:
            if len(live) < len(targets):
                ev.meta["tenants_shed"] = [t for t in targets
                                           if t not in live]
            for i, t in enumerate(live):
                if i == 0:
                    e = ev
                else:
                    e = Event(payload=_clone_payload(ev.payload),
                              req_id=ev.req_id, born_at=ev.born_at)
                    # clones keep the request's trace identity so each
                    # tenant branch records a complete span tree
                    propagate_trace(ev, e)
                e.route = t
                out.append(e)
        return out
    return op
