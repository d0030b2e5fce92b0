"""Staged Event-Driven Pipeline (paper §4).

  Definition 1: stage processor p = ⟨op, c⟩ — op: unit primitive for one
  execution stage; c: channel queuing events from upstream processors.
  Definition 2: SEDP = DAG G = (P, E); all edges into a stage SHARE one
  channel (join/aggregation semantics).

``SEDP.compile()`` validates the DAG, builds the shared channels, and
returns an execution plan (topological order + routing table) that the
executors (repro.core.executors) run fully asynchronously.

Events carry an optional ``route`` so an op can steer each event to a subset
of its successors — this is how the query cache short-circuits to the
response stage and how the multi-tenant dispatcher fans traffic to test
groups (§4 "multi-tenant extension").
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

_uid = itertools.count()


@dataclass
class Event:
    """One inference task (user-item pair / request) flowing through the DAG.

    ``meta`` doubles as the telemetry carrier (DESIGN.md §10): when a
    ``Tracer`` is attached to the executor, ``meta["trace_id"]`` holds the
    request's trace id and ``meta["spans"]`` the span list the executors
    append to on every stage visit. Ops that clone events (fanout) must
    call ``propagate_trace`` so the clone's span tree stays complete."""
    payload: Any
    req_id: int = field(default_factory=lambda: next(_uid))
    route: Optional[str] = None        # next-stage override (None = all succs)
    born_at: float = 0.0               # set by the executor clock
    done_at: float = 0.0
    # absolute deadline on the executor clock (None = no budget). Stamped
    # at ingress from meta["deadline_s"] (born_at + budget); every stage
    # dispatch checks it — an expired event short-circuits to a timed-out
    # terminal instead of occupying downstream stages (DESIGN.md §8.4)
    deadline_at: Optional[float] = None
    meta: dict = field(default_factory=dict)

    @property
    def trace_id(self) -> Optional[int]:
        return self.meta.get("trace_id")


def propagate_trace(parent: "Event", clone: "Event") -> "Event":
    """Carry the parent's trace identity onto a cloned event: same trace
    id, a branched copy of the span history (the closed prefix is shared
    structurally; each branch appends to its own list). No-op when the
    parent is untraced."""
    spans = parent.meta.get("spans")
    if spans is not None:
        clone.meta["trace_id"] = parent.meta["trace_id"]
        clone.meta["spans"] = list(spans)
    return clone


@dataclass
class StageProcessor:
    """op(batch: list[Event], ctx) -> list[Event]. Tunables (batch size,
    parallelism, batching window, channel bound) are exactly the paper's
    per-stage knobs (Table 6)."""
    name: str
    op: Callable
    batch_size: int = 1
    parallelism: int = 1
    # bounded channel: when the stage's queue holds max_queue events the
    # upstream either blocks (AsyncExecutor) or offers the event to the
    # load-shedding policy (SimExecutor) instead of growing without bound
    max_queue: int = 100_000
    # micro-batching window: a partial batch is held up to max_wait_s for
    # more arrivals before it is flushed (None = executor default)
    max_wait_s: Optional[float] = None
    # offline-tunable service-time model (used by SimExecutor):
    # seconds = base + per_item * n  (amortization is what batch tuning buys)
    sim_base_s: float = 0.0
    sim_per_item_s: float = 0.0

    def __post_init__(self):
        # a non-positive bound would mean "unbounded" to queue.Queue but
        # "overflow every event" to SimExecutor — reject it at the shared
        # knob instead of diverging per executor
        if self.max_queue <= 0:
            raise GraphError(
                f"stage {self.name!r}: max_queue must be positive "
                f"(got {self.max_queue})")


class GraphError(ValueError):
    pass


@dataclass
class Plan:
    stages: dict[str, StageProcessor]
    succs: dict[str, list[str]]
    preds: dict[str, list[str]]
    order: list[str]
    sources: list[str]
    sinks: list[str]


class SEDP:
    def __init__(self):
        self.stages: dict[str, StageProcessor] = {}
        self.edges: list[tuple[str, str]] = []

    def add_stage(self, name: str, op: Callable, **kw) -> StageProcessor:
        if name in self.stages:
            raise GraphError(f"duplicate stage {name!r}")
        sp = StageProcessor(name, op, **kw)
        self.stages[name] = sp
        return sp

    def add_edge(self, src: str, dst: str):
        for s in (src, dst):
            if s not in self.stages:
                raise GraphError(f"unknown stage {s!r}")
        if (src, dst) in self.edges:
            raise GraphError(f"duplicate edge {src}->{dst}")
        self.edges.append((src, dst))

    def chain(self, *names: str):
        for a, b in zip(names, names[1:]):
            self.add_edge(a, b)

    def compile(self) -> Plan:
        """Validate DAG + topo-sort. One channel per stage, shared by all
        in-edges (Definition 2)."""
        succs = {n: [] for n in self.stages}
        preds = {n: [] for n in self.stages}
        for a, b in self.edges:
            succs[a].append(b)
            preds[b].append(a)
        # Kahn topo sort → cycle detection
        indeg = {n: len(p) for n, p in preds.items()}
        frontier = [n for n, d in indeg.items() if d == 0]
        order = []
        while frontier:
            n = frontier.pop()
            order.append(n)
            for m in succs[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    frontier.append(m)
        if len(order) != len(self.stages):
            cyc = [n for n, d in indeg.items() if d > 0]
            raise GraphError(f"cycle through {cyc}")
        sources = [n for n in self.stages if not preds[n]]
        sinks = [n for n in self.stages if not succs[n]]
        if not sources or not sinks:
            raise GraphError("SEDP needs at least one source and one sink")
        # route targets must be real successors
        return Plan(self.stages, succs, preds, order, sources, sinks)


# ------------------------------------------------------------------ helpers

def passthrough(batch: list[Event], ctx) -> list[Event]:
    return batch


def map_op(fn: Callable[[Any], Any]) -> Callable:
    """Lift an item-level function to a batch op."""
    def op(batch: list[Event], ctx):
        for ev in batch:
            ev.payload = fn(ev.payload)
        return batch
    return op
