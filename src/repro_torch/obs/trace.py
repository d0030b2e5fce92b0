"""Per-request tracing for the SEDP loop (DESIGN.md §10.1).

A ``Tracer`` threads a trace id + span list through ``Event.meta`` on both
executors. Every stage visit records three spans — ``queue`` (channel
enqueue → dequeue, including backpressure stall on the async executor),
``assemble`` (dequeue → micro-batch dispatch), ``exec`` (op start → op
end) — so the span topology is identical Sim-vs-Async even though the
durations come from different clocks (virtual vs wall).

Stages annotate the OPEN span via ``annotate(ev, cache_hit=True, ...)``;
the call is a no-op (one dict lookup) on untraced events, which is what
keeps the telemetry-OFF path free.

``TraceBuffer`` bounds memory with tail-based sampling: errors, deadline
expiries, shed-dropped and degraded(>0) traces are ALWAYS kept (up to a
cap), plus a top-K latency heap and a recent ring for baseline context.
Export is Chrome trace-event JSON (load in Perfetto / chrome://tracing);
``from_chrome`` round-trips it and ``critical_path`` attributes a
request's latency to stages/queues from the exported form alone.
"""
from __future__ import annotations

import heapq
import itertools
import json
import threading
from collections import deque
from typing import Optional


def annotate(ev, **attrs) -> None:
    """Merge attributes into the event's currently-open span. No-op when
    the event is untraced (the hot-path cost when telemetry is off)."""
    spans = ev.meta.get("spans")
    if spans:
        spans[-1]["attrs"].update(attrs)


def add_child_spans(ev, child_spans) -> None:
    """Attach pre-built child spans (e.g. the mesh's per-shard
    ``shard_fetch`` sub-batches) to a traced event's current stage visit.

    Children are inserted BEFORE the currently-open ``exec`` span rather
    than appended: ``Tracer.exec_end`` closes ``spans[-1]`` only if it is
    the exec span, and ``annotate`` targets ``spans[-1]`` — appending
    would orphan the stage's own span. No-op on untraced events."""
    spans = ev.meta.get("spans")
    if not spans or not child_spans:
        return
    if spans[-1]["kind"] == "exec":
        spans[-1:-1] = child_spans
    else:
        spans.extend(child_spans)


def shard_fanout_spans(fanout: list) -> list:
    """Build the ``shard_fanout`` span family from a MeshCube fan-out
    record list (``take_fanout()``): one ``cube:shard_fanout`` parent
    covering the scatter/gather envelope plus one ``shard_<s>:shard_fetch``
    child per sub-batch. The spans travel through Chrome export like any
    other (kind rides in the ``stage:kind`` name), so ``critical_path`` /
    ``shard_profile`` attribute tail latency to the slowest shard from an
    exported trace alone."""
    if not fanout:
        return []
    t0 = min(f["t0"] for f in fanout)
    t1 = max(f["t1"] for f in fanout)
    spans = [{"stage": "cube", "kind": "shard_fanout", "t0": t0, "t1": t1,
              "attrs": {"n_shards": len(fanout)}}]
    for f in fanout:
        spans.append({"stage": f"shard_{f['shard']}", "kind": "shard_fetch",
                      "t0": f["t0"], "t1": f["t1"],
                      "attrs": {"shard": f["shard"], "host": f["host"],
                                "n_keys": f["n_keys"],
                                "hedged": f["hedged"],
                                "failed": f["failed"]}})
    return spans


def _status_of(ev) -> str:
    if ev.meta.get("error"):
        return "error"
    if ev.meta.get("timed_out"):
        return "expired"
    return "ok"


class Tracer:
    """Executor-side hook set. All methods tolerate untraced events (an
    executor may run a mix when fanout clones predate the tracer)."""

    def __init__(self, buffer: Optional["TraceBuffer"] = None):
        self.buffer = buffer if buffer is not None else TraceBuffer()
        self._ids = itertools.count(1)

    # ------------------------------------------------------------ hooks

    def begin(self, ev, t: float) -> None:
        if "trace_id" not in ev.meta:
            ev.meta["trace_id"] = next(self._ids)
            ev.meta["spans"] = []

    def adopt(self, parent_ev, clone_ev) -> None:
        """Fanout clones share the parent's trace id and inherit a copy of
        the span history up to the fork (the closed prefix is shared
        structurally; each branch appends to its own list)."""
        spans = parent_ev.meta.get("spans")
        if spans is None:
            return
        clone_ev.meta["trace_id"] = parent_ev.meta["trace_id"]
        clone_ev.meta["spans"] = list(spans)

    def enqueued(self, ev, stage: str, t: float) -> None:
        spans = ev.meta.get("spans")
        if spans is not None:
            spans.append({"stage": stage, "kind": "queue",
                          "t0": t, "t1": t, "attrs": {}})

    def dequeued(self, ev, stage: str, t: float) -> None:
        spans = ev.meta.get("spans")
        if spans is not None:
            if spans and spans[-1]["kind"] == "queue":
                spans[-1]["t1"] = t
            spans.append({"stage": stage, "kind": "assemble",
                          "t0": t, "t1": t, "attrs": {}})

    def exec_begin(self, batch, stage: str, t: float) -> None:
        for ev in batch:
            spans = ev.meta.get("spans")
            if spans is not None:
                if spans and spans[-1]["kind"] == "assemble":
                    spans[-1]["t1"] = t
                spans.append({"stage": stage, "kind": "exec",
                              "t0": t, "t1": t,
                              "attrs": {"batch": len(batch)}})

    def exec_end(self, batch, stage: str, t: float, **attrs) -> None:
        for ev in batch:
            spans = ev.meta.get("spans")
            if spans is not None and spans and spans[-1]["kind"] == "exec":
                spans[-1]["t1"] = t
                if attrs:
                    spans[-1]["attrs"].update(attrs)

    def expired(self, ev, stage: str, t: float) -> None:
        """Deadline gate fired at dispatch: close whatever span is open
        and mark the expiry decision on it."""
        spans = ev.meta.get("spans")
        if spans is not None and spans:
            spans[-1]["t1"] = t
            spans[-1]["attrs"]["expired"] = True

    def dropped(self, ev, stage: str, t: float) -> None:
        """Overflow-policy drop at a bounded channel: the request sheds
        before its queue span ever opened."""
        spans = ev.meta.get("spans")
        if spans is not None:
            spans.append({"stage": stage, "kind": "queue", "t0": t, "t1": t,
                          "attrs": {"dropped": True}})
        self.finish(ev, t, status="dropped")

    def finish(self, ev, t: float, status: Optional[str] = None) -> None:
        spans = ev.meta.get("spans")
        if spans is None:
            return
        payload = ev.payload
        tier = (payload.get("degraded_tier", 0)
                if hasattr(payload, "get") else 0) or 0
        rec = {
            "trace_id": ev.meta["trace_id"],
            "req_id": ev.req_id,
            "born_at": ev.born_at,
            "done_at": t,
            "latency_s": max(0.0, t - ev.born_at),
            "status": status or _status_of(ev),
            "degraded_tier": int(tier),
            "spans": spans,
        }
        if ev.meta.get("error"):
            rec["error"] = ev.meta["error"]
        self.buffer.add(rec)


class TraceBuffer:
    """Bounded trace store with tail-based sampling.

    Three compartments: ``flagged`` (errors / expired / dropped /
    degraded>0 — the traces an operator actually pages through),
    ``top`` (K slowest OK traces), ``recent`` (ring of the latest OK
    traces for baseline comparison). Each is individually bounded, so
    total memory is O(max_flagged + max_top + max_recent)."""

    def __init__(self, max_flagged: int = 512, max_top: int = 64,
                 max_recent: int = 256):
        self.max_top = max_top
        self._flagged: deque = deque(maxlen=max_flagged)
        self._top: list = []                       # min-heap (latency, seq, rec)
        self._recent: deque = deque(maxlen=max_recent)
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self.added = 0          # every record offered
        self.flagged_total = 0  # records that hit the always-keep rules

    def add(self, rec: dict) -> None:
        with self._lock:
            self.added += 1
            if rec["status"] != "ok" or rec["degraded_tier"] > 0:
                self.flagged_total += 1
                self._flagged.append(rec)
                return
            self._recent.append(rec)
            item = (rec["latency_s"], next(self._seq), rec)
            if len(self._top) < self.max_top:
                heapq.heappush(self._top, item)
            elif item[0] > self._top[0][0]:
                heapq.heapreplace(self._top, item)

    def traces(self) -> list[dict]:
        """All retained traces, deduped (a top-K trace may also sit in the
        recent ring), ordered by completion time."""
        with self._lock:
            seen: set[int] = set()
            out: list[dict] = []
            for rec in itertools.chain(self._flagged,
                                       (r for _, _, r in self._top),
                                       self._recent):
                if id(rec) not in seen:
                    seen.add(id(rec))
                    out.append(rec)
        out.sort(key=lambda r: (r["done_at"], r["trace_id"]))
        return out

    def find(self, **conds) -> list[dict]:
        """Filter retained traces by top-level record fields
        (``find(status="expired")``, ``find(trace_id=7)``)."""
        return [r for r in self.traces()
                if all(r.get(k) == v for k, v in conds.items())]

    def clear(self) -> None:
        with self._lock:
            self._flagged.clear()
            self._top = []
            self._recent.clear()

    # ----------------------------------------------------------- export

    def export_chrome(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON: one ``X`` (complete) event per span plus
        a per-request summary event carrying status/degraded_tier — enough
        to reconstruct each trace with ``from_chrome``."""
        events = []
        for rec in self.traces():
            tid = rec["trace_id"]
            events.append({
                "name": "request", "cat": "request", "ph": "X",
                "ts": rec["born_at"] * 1e6,
                "dur": max(0.0, rec["done_at"] - rec["born_at"]) * 1e6,
                "pid": 1, "tid": tid,
                "args": {"status": rec["status"],
                         "degraded_tier": rec["degraded_tier"],
                         "req_id": rec["req_id"]},
            })
            for sp in rec["spans"]:
                events.append({
                    "name": f'{sp["stage"]}:{sp["kind"]}',
                    "cat": sp["kind"], "ph": "X",
                    "ts": sp["t0"] * 1e6,
                    "dur": max(0.0, sp["t1"] - sp["t0"]) * 1e6,
                    "pid": 1, "tid": tid,
                    "args": dict(sp["attrs"]),
                })
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc

    @staticmethod
    def from_chrome(doc) -> list[dict]:
        """Rebuild trace records from an exported Chrome trace document
        (dict, JSON string, or path). The analyzer functions below accept
        these reconstructed records — the acceptance drill reads the
        request path back from the export alone."""
        if isinstance(doc, str):
            try:
                doc = json.loads(doc)
            except ValueError:
                with open(doc) as f:
                    doc = json.load(f)
        by_tid: dict[int, dict] = {}
        for e in doc.get("traceEvents", []):
            tid = e["tid"]
            rec = by_tid.setdefault(tid, {"trace_id": tid, "spans": []})
            t0 = e["ts"] / 1e6
            t1 = t0 + e.get("dur", 0.0) / 1e6
            if e["name"] == "request":
                rec.update(born_at=t0, done_at=t1,
                           latency_s=max(0.0, t1 - t0),
                           status=e["args"].get("status", "ok"),
                           degraded_tier=e["args"].get("degraded_tier", 0),
                           req_id=e["args"].get("req_id"))
            else:
                stage, _, kind = e["name"].rpartition(":")
                rec["spans"].append({"stage": stage, "kind": kind,
                                     "t0": t0, "t1": t1,
                                     "attrs": dict(e.get("args", {}))})
        for rec in by_tid.values():
            rec["spans"].sort(key=lambda s: (s["t0"], s["t1"]))
            rec.setdefault("status", "ok")
            rec.setdefault("degraded_tier", 0)
        return sorted(by_tid.values(), key=lambda r: r["trace_id"])


# ------------------------------------------------------------- analysis

def span_topology(rec: dict) -> list[tuple[str, str]]:
    """(stage, kind) sequence — the structural shape of a trace, invariant
    across executors for the same routing decisions."""
    return [(sp["stage"], sp["kind"]) for sp in rec["spans"]]


def stage_path(rec: dict) -> list[str]:
    """The stages a request actually visited, in visit order (one entry
    per stage visit, from the queue spans — present even for visits that
    expired before executing)."""
    return [sp["stage"] for sp in rec["spans"] if sp["kind"] == "queue"]


def critical_path(rec: dict) -> dict:
    """Attribute a request's end-to-end latency to (stage, kind) segments.

    Returns ``{"total_s", "segments": [{stage, kind, dur_s, frac}...],
    "unattributed_s"}`` with segments sorted by descending duration —
    "where did my p99 go" from one trace."""
    total = rec.get("latency_s")
    if total is None:
        total = max(0.0, rec.get("done_at", 0.0) - rec.get("born_at", 0.0))
    agg: dict[tuple[str, str], float] = {}
    covered = 0.0
    for sp in rec["spans"]:
        dur = max(0.0, sp["t1"] - sp["t0"])
        agg[(sp["stage"], sp["kind"])] = agg.get(
            (sp["stage"], sp["kind"]), 0.0) + dur
        covered += dur
    segments = [{"stage": s, "kind": k, "dur_s": d,
                 "frac": d / total if total > 0 else 0.0}
                for (s, k), d in agg.items()]
    segments.sort(key=lambda seg: -seg["dur_s"])
    return {"total_s": total, "segments": segments,
            "unattributed_s": max(0.0, total - covered)}


def shard_profile(rec: dict) -> dict:
    """Per-shard time of one trace from its ``shard_fetch`` child spans:
    ``{shard_id: {"dur_s", "n_fetches", "hosts", "hedged"}}``. The hot
    shard — the fan-out straggler the request's tail hides behind — is
    ``max(profile, key=lambda s: profile[s]["dur_s"])``. Works on live
    records and on ``from_chrome`` reconstructions alike (shard ids
    recover from the span attrs / stage name)."""
    out: dict[int, dict] = {}
    for sp in rec["spans"]:
        if sp["kind"] != "shard_fetch":
            continue
        attrs = sp.get("attrs", {})
        sid = attrs.get("shard")
        if sid is None:
            try:
                sid = int(sp["stage"].rpartition("_")[2])
            except ValueError:
                continue
        sid = int(sid)
        ent = out.setdefault(sid, {"dur_s": 0.0, "n_fetches": 0,
                                   "hosts": set(), "hedged": 0})
        ent["dur_s"] += max(0.0, sp["t1"] - sp["t0"])
        ent["n_fetches"] += 1
        if attrs.get("host") is not None:
            ent["hosts"].add(attrs["host"])
        if attrs.get("hedged"):
            ent["hedged"] += 1
    return out
