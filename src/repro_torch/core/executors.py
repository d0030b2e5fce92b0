"""Executors for a compiled SEDP plan.

  * AsyncExecutor  — real threads, one worker pool + shared channel per stage;
    fully asynchronous event-driven execution (the production path; wraps
    jitted JAX steps in the DNN stage, JAX's async dispatch overlaps host
    stages with device compute).
  * SimExecutor    — deterministic discrete-event simulation with a virtual
    clock. Ops EXECUTE functionally (so caches/shedding change routing), but
    time advances by each stage's service-time model + queueing at
    ``parallelism`` servers. All latency/throughput numbers in benchmarks
    come from here (reproducible; no wall-clock noise).
  * LegacyExecutor — the paper's §2 baseline: synchronous batch pipeline with
    a barrier per stage (pipeline stalls on long-tail items — exactly the
    behaviour SEDP removes).
"""
from __future__ import annotations

import heapq
import logging
import math
import queue
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.core.sedp import Event, Plan, StageProcessor
from repro_torch.obs.metrics import Histogram
from repro_torch.serve.batcher import MicroBatcher

log = logging.getLogger(__name__)


def _stamp_deadline(ev: Event, born_at: float):
    """Ingress deadline stamping: a request carrying a ``deadline_s``
    budget gets its absolute deadline fixed on the executor clock the
    moment it enters the pipeline."""
    if ev.deadline_at is None:
        budget = ev.meta.get("deadline_s")
        if budget is not None:
            ev.deadline_at = born_at + float(budget)


@dataclass
class StageStats:
    events: int = 0
    batches: int = 0
    busy_s: float = 0.0
    queue_wait_s: float = 0.0
    max_depth: int = 0        # deepest the stage's channel ever got
    overflows: int = 0        # enqueue attempts that found the channel full
    dropped: int = 0          # events shed AT this channel (overflow policy)
    expired: int = 0          # events past their deadline at dispatch — shed
    errors: int = 0           # events whose stage op raised (error-terminal)
    degraded: int = 0         # events this stage served off the ladder's
    #                           non-primary tiers (replica/stale/default)

    @property
    def avg_batch(self):
        return self.events / max(1, self.batches)


@dataclass
class RunReport:
    latencies: list = field(default_factory=list)       # per finished event
    stage_stats: dict = field(default_factory=dict)
    makespan_s: float = 0.0
    results: list = field(default_factory=list)
    offered: int = 0          # events injected at the source
    dropped: int = 0          # events shed by overflow policy (never finish)
    expired: int = 0          # deadline-expired events (finish timed-out)
    errors: int = 0           # events terminated by a stage-op exception
    completed: int = 0        # events that reached the sink (incl. expired/
    #                           errored terminals) — authoritative even when
    #                           exact latency retention is off
    # log-bucketed latency histogram: ALWAYS populated; the default
    # accounting path when ``exact_latencies=False`` drops the raw list
    # (bounded memory on long-running serving loops)
    latency_hist: Optional[Histogram] = None

    @property
    def throughput(self):
        n = self.completed or len(self.latencies)
        return n / max(1e-9, self.makespan_s)

    @property
    def goodput(self):
        """Completed (non-shed) requests per second of makespan."""
        return self.throughput

    @property
    def drop_ratio(self):
        return self.dropped / max(1, self.offered)

    def latency_percentile(self, q: float) -> float:
        """Ceil-based nearest-rank percentile: the smallest x with at least
        ``ceil(q*n)`` samples ≤ x. (The old ``int(q*n)`` index read one
        rank high on exact fractions and under-indexed small samples.)
        Falls back to the log-bucketed histogram when exact samples were
        not retained."""
        if self.latencies:
            xs = sorted(self.latencies)
            return xs[max(0, math.ceil(q * len(xs)) - 1)]
        if self.latency_hist is not None and self.latency_hist.count:
            return self.latency_hist.percentile(q)
        return 0.0

    @property
    def avg_latency(self):
        if self.latencies:
            return sum(self.latencies) / len(self.latencies)
        if self.latency_hist is not None and self.latency_hist.count:
            return self.latency_hist.sum / self.latency_hist.count
        return 0.0


class ExecContext:
    """Passed to every op: executor-wide shared state + intermediate system
    feedback — queue depths and per-stage stats feed the load-shedder's
    'quota' feature (Table 7)."""

    def __init__(self, executor):
        self.executor = executor
        self.shared: dict = {}

    def queue_depth(self, stage: str) -> int:
        try:
            return self.executor._depth(stage)
        except KeyError:
            return 0

    def stage_stats(self, stage: str) -> StageStats:
        return self.executor.stats[stage]

    def utilization(self, stage: str) -> float:
        """busy-server-seconds / available-server-seconds since run start;
        >1 means the offered work exceeds the stage's service capacity."""
        ex = self.executor
        sp = ex.plan.stages.get(stage)
        if sp is None:
            return 0.0
        elapsed = max(ex._now() - getattr(ex, "_t_start", 0.0), 1e-9)
        return ex.stats[stage].busy_s / (sp.parallelism * elapsed)

    def now(self) -> float:
        return self.executor._now()

    def total_expired(self) -> int:
        """Deadline expirations across every stage so far — the expiry-rate
        shedding signal (``QuotaController`` folds its growth into quota)."""
        return sum(st.expired for st in self.executor.stats.values())


# --------------------------------------------------------------- Async

class AsyncExecutor:
    """Channels are bounded (``StageProcessor.max_queue``): a full downstream
    queue BLOCKS the upstream worker's put — real backpressure that
    propagates toward the source instead of letting queues grow without
    bound. Batching follows the MicroBatcher discipline: a worker collects
    up to ``batch_size`` events or ``max_wait_s`` (whichever first)."""

    def __init__(self, plan: Plan, batch_timeout_s: float = 0.002,
                 tracer=None, exact_latencies: bool = True):
        self.plan = plan
        self.batch_timeout_s = batch_timeout_s
        self.tracer = tracer
        self.exact_latencies = exact_latencies
        self.channels = {n: queue.Queue(maxsize=sp.max_queue)
                         for n, sp in plan.stages.items()}
        self.out_q: queue.Queue = queue.Queue()
        self.stats = defaultdict(StageStats)
        self.ctx = ExecContext(self)
        self._stop = threading.Event()
        self._pending = 0
        self._pending_lock = threading.Lock()
        # StageStats mutations come from every worker thread concurrently;
        # bare += on the dataclass fields loses increments under contention
        self._stats_lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._gen = 0          # run() generation; stale workers must not emit
        self._t_start = 0.0

    def _now(self):
        return time.monotonic()

    def _depth(self, stage):
        return self.channels[stage].qsize()

    def _worker(self, sp: StageProcessor, gen: int):
        ch = self.channels[sp.name]
        wait_s = (sp.max_wait_s if sp.max_wait_s is not None
                  else self.batch_timeout_s)
        mb = MicroBatcher(max_batch=sp.batch_size, max_wait_s=wait_s)
        while not self._stop.is_set() and self._gen == gen:
            # idle poll tick when empty; otherwise sleep only to the window
            timeout = 0.05 if not len(mb) else min(0.05, max(
                1e-4, mb.deadline() - time.monotonic()))
            batch = None
            try:
                ev = ch.get(timeout=timeout)
                if self.tracer is not None:
                    self.tracer.dequeued(ev, sp.name, time.monotonic())
                batch = mb.offer(ev, deadline_at=ev.deadline_at)
            except queue.Empty:
                pass
            if batch is None:
                batch = mb.poll()
            if batch is None:
                continue
            if self._gen != gen:
                return       # a newer run() started: don't touch its state
            # deadline gate at dispatch: an expired event short-circuits to
            # a timed-out terminal instead of occupying this stage (and
            # everything downstream of it)
            now = time.monotonic()
            expired = [e for e in batch if e.deadline_at is not None
                       and now > e.deadline_at]
            if expired:
                with self._stats_lock:
                    self.stats[sp.name].expired += len(expired)
                for e in expired:
                    e.meta["timed_out"] = True
                    e.meta["_terminal"] = True
                    if self.tracer is not None:
                        self.tracer.expired(e, sp.name, now)
                self._emit(sp.name, expired, gen)
                batch = [e for e in batch if not e.meta.get("timed_out")]
                if not batch:
                    continue
            t0 = time.monotonic()
            if self.tracer is not None:
                self.tracer.exec_begin(batch, sp.name, t0)
            try:
                out = sp.op(batch, self.ctx) or []
                failed = False
            except Exception as e:  # noqa: BLE001 — a poisoned op must
                # become an error-terminal response, never a dead worker
                log.exception("stage %r op raised; failing its batch "
                              "terminally", sp.name)
                failed = True
                out = list(batch)
                for ev in out:
                    ev.meta["error"] = f"{type(e).__name__}: {e}"
                    ev.meta["_terminal"] = True
            t1 = time.monotonic()
            if self.tracer is not None:
                if failed:
                    self.tracer.exec_end(batch, sp.name, t1,
                                         error=batch[0].meta.get("error"))
                else:
                    self.tracer.exec_end(batch, sp.name, t1)
            if self._gen != gen:
                return       # a newer run() started: don't touch its state
            n_degraded = sum(1 for e in batch
                             if e.meta.pop("_degraded", None))
            with self._stats_lock:
                st = self.stats[sp.name]
                st.events += len(batch)
                st.batches += 1
                st.busy_s += t1 - t0
                if failed:
                    st.errors += len(batch)
                st.degraded += n_degraded
            # ops may CREATE events (multi-tenant fanout clones) or DROP
            # them (filters): the completion count must track the actual
            # in-flight population or run() would return early / hang
            if len(out) != len(batch):
                with self._pending_lock:
                    self._pending += len(out) - len(batch)
            self._emit(sp.name, out, gen)
        # a worker only exits once run() saw _pending == 0, so its batcher
        # buffer is necessarily empty here — nothing to drain

    def _put_blocking(self, stage: str, ev: Event, gen: int):
        """Bounded-channel put: blocks while the downstream queue is full
        (backpressure), bailing out only on shutdown/generation change."""
        ch = self.channels[stage]
        st = self.stats[stage]
        # queue span opens BEFORE the put: a consumer may pop the event the
        # instant it lands, and the span deliberately includes any
        # backpressure stall spent blocked on a full channel
        if self.tracer is not None:
            self.tracer.enqueued(ev, stage, time.monotonic())
        blocked = False
        while self._gen == gen:
            try:
                ch.put(ev, block=blocked, timeout=0.05)
                with self._stats_lock:
                    st.max_depth = max(st.max_depth, ch.qsize())
                return
            except queue.Full:
                if not blocked:             # count each backpressure stall once
                    with self._stats_lock:
                        st.overflows += 1
                    blocked = True
                continue

    def _emit(self, stage: str, events, gen: int):
        succs = self.plan.succs[stage]
        for ev in events:
            targets = ([ev.route] if ev.route in succs else succs)
            ev.route = None
            if ev.meta.pop("_terminal", False):
                targets = []     # expired/errored: straight to the sink
            if not targets:
                ev.done_at = time.monotonic()
                if self.tracer is not None:
                    self.tracer.finish(ev, ev.done_at)
                self.out_q.put(ev)
                with self._pending_lock:
                    self._pending -= 1
                continue
            if len(targets) > 1:
                with self._pending_lock:
                    self._pending += len(targets) - 1
            for t in targets:
                self._put_blocking(t, ev, gen)

    def run(self, events: list[Event], source: Optional[str] = None) -> RunReport:
        source = source or self.plan.sources[0]
        # fresh lifecycle per run: bump the generation and clear the stop
        # flag/stats left by a previous run() so the executor is reusable
        # (no stale-stop hang, no double-counted stats, and any worker that
        # outlived the join below exits on the generation mismatch instead
        # of stealing this run's events)
        self._gen += 1
        gen = self._gen
        self._stop.clear()
        self.stats = defaultdict(StageStats)
        for sp in self.plan.stages.values():
            for _ in range(sp.parallelism):
                th = threading.Thread(target=self._worker, args=(sp, gen),
                                      daemon=True)
                th.start()
                self._threads.append(th)
        t_start = time.monotonic()
        self._t_start = t_start
        with self._pending_lock:
            self._pending = len(events)
        for ev in events:
            ev.born_at = time.monotonic()
            _stamp_deadline(ev, ev.born_at)
            if self.tracer is not None:
                self.tracer.begin(ev, ev.born_at)
            # bounded ingress: a full source channel pushes back on the
            # injector exactly like any other upstream
            self._put_blocking(source, ev, gen)
        done = []
        while True:
            try:
                ev = self.out_q.get(timeout=0.2)
                done.append(ev)
            except queue.Empty:
                with self._pending_lock:
                    if self._pending <= 0:
                        break
        self._stop.set()
        for th in self._threads:        # workers exit within their poll tick
            th.join(timeout=2.0)
        self._threads = [th for th in self._threads if th.is_alive()]
        hist = Histogram("latency_s", "end-to-end request latency")
        for ev in done:
            hist.observe(ev.done_at - ev.born_at)
        rep = RunReport(
            latencies=([ev.done_at - ev.born_at for ev in done]
                       if self.exact_latencies else []),
            stage_stats=dict(self.stats),
            makespan_s=time.monotonic() - t_start,
            results=done, offered=len(events), completed=len(done),
            latency_hist=hist,
            expired=sum(st.expired for st in self.stats.values()),
            errors=sum(st.errors for st in self.stats.values()))
        return rep


# ----------------------------------------------------------------- Sim

@dataclass(order=True)
class _SimItem:
    t: float
    seq: int
    kind: str = field(compare=False)
    data: Any = field(compare=False)


class SimExecutor:
    """Discrete-event simulation: each stage = FIFO + ``parallelism`` servers;
    service time = sim_base_s + sim_per_item_s * len(batch) (per batch).
    Deterministic: same inputs → same report.

    Batching follows the MicroBatcher discipline on the virtual clock: a
    stage with ``max_wait_s`` set holds a partial batch until the window
    closes (a scheduled "poll" event flushes it); the default window of 0
    dispatches greedily, matching the pre-closed-loop behaviour the offline
    calibration was tuned against.

    Channels are bounded by ``max_queue``. On overflow the event is offered
    to ``overflow_policy(stage, event, ctx)`` — e.g. the online shedder's
    ``on_overflow``, which prunes the candidate set (admitting a cheaper
    event) or drops the request outright (returns None). Without a policy
    the queue keeps growing and only ``overflows`` is counted: exactly the
    unbounded blow-up the closed loop exists to prevent."""

    def __init__(self, plan: Plan, service_time: Optional[Callable] = None,
                 overflow_policy: Optional[Callable] = None,
                 default_max_wait_s: float = 0.0,
                 tracer=None, exact_latencies: bool = True):
        self.plan = plan
        self.service_time = service_time or self._default_service_time
        self.overflow_policy = overflow_policy
        self.default_max_wait_s = default_max_wait_s
        self.tracer = tracer
        self.exact_latencies = exact_latencies
        self.stats = defaultdict(StageStats)
        self.ctx = ExecContext(self)
        # deques of (enqueue_time, event): stage dispatch pops from the head;
        # list.pop(0) would be O(n) per event and O(n²) in queue depth under
        # heavy traffic. The timestamp drives queue-wait accounting and the
        # micro-batch window.
        self._queues: dict[str, deque] = {n: deque() for n in plan.stages}
        self._free_at: dict[str, list[float]] = {
            n: [0.0] * sp.parallelism for n, sp in plan.stages.items()}
        self._poll_at: dict[str, float] = {}    # one outstanding poll/stage
        self._clock = 0.0
        self._t_start = 0.0
        self._done: list[Event] = []
        self._dropped = 0

    @staticmethod
    def _default_service_time(sp: StageProcessor, batch):
        return sp.sim_base_s + sp.sim_per_item_s * len(batch)

    def _now(self):
        return self._clock

    def _depth(self, stage):
        return len(self._queues[stage])

    def _wait_window(self, sp: StageProcessor) -> float:
        return (sp.max_wait_s if sp.max_wait_s is not None
                else self.default_max_wait_s)

    def run(self, arrivals: list[tuple[float, Event]],
            source: Optional[str] = None) -> RunReport:
        source = source or self.plan.sources[0]
        # fresh lifecycle per run (same contract as AsyncExecutor): no
        # leftover events, clock, server busy-times or counters from a
        # previous run() on this instance
        self.stats = defaultdict(StageStats)
        self._queues = {n: deque() for n in self.plan.stages}
        self._free_at = {n: [0.0] * sp.parallelism
                         for n, sp in self.plan.stages.items()}
        self._poll_at = {}
        self._clock = 0.0
        self._done = []
        self._dropped = 0
        self._t_start = arrivals[0][0] if arrivals else 0.0
        pq: list[_SimItem] = []
        seq = 0
        for t, ev in arrivals:
            ev.born_at = t
            _stamp_deadline(ev, t)
            if self.tracer is not None:
                self.tracer.begin(ev, t)
            heapq.heappush(pq, _SimItem(t, seq, "arrive", (source, ev)))
            seq += 1
        while pq:
            item = heapq.heappop(pq)
            if item.kind == "poll":             # micro-batch window closed
                stage = item.data
                if self._poll_at.get(stage) != item.t:
                    continue                    # superseded by a later poll
                self._poll_at.pop(stage)
                if not self._queues[stage]:
                    # batch already went out on the size trigger: a stale
                    # poll must not advance the clock (it would inflate the
                    # makespan to the unused window deadline)
                    continue
                self._clock = max(self._clock, item.t)
                seq = self._try_dispatch(stage, pq, seq)
                continue
            self._clock = max(self._clock, item.t)
            if item.kind == "arrive":
                stage, ev = item.data
                self._enqueue(stage, ev)
                seq = self._try_dispatch(stage, pq, seq)
            else:  # ("finish", stage, server_idx, batch, out_events)
                stage, si, batch, out = item.data
                st = self.stats[stage]
                st.events += len(batch)
                st.batches += 1
                self._emit(stage, out)
                seq = self._try_dispatch(stage, pq, seq)
                for other in self.plan.stages:
                    seq = self._try_dispatch(other, pq, seq)
        hist = Histogram("latency_s", "end-to-end request latency")
        for ev in self._done:
            hist.observe(ev.done_at - ev.born_at)
        rep = RunReport(
            latencies=([ev.done_at - ev.born_at for ev in self._done]
                       if self.exact_latencies else []),
            stage_stats=dict(self.stats),
            makespan_s=self._clock - self._t_start,
            results=self._done, offered=len(arrivals),
            completed=len(self._done), latency_hist=hist,
            dropped=self._dropped,
            expired=sum(st.expired for st in self.stats.values()),
            errors=sum(st.errors for st in self.stats.values()))
        return rep

    def _try_dispatch(self, stage: str, pq, seq: int) -> int:
        sp = self.plan.stages[stage]
        wait = self._wait_window(sp)
        q = self._queues[stage]
        frees = self._free_at[stage]
        while q:
            si = min(range(len(frees)), key=frees.__getitem__)
            if frees[si] > self._clock:
                break
            if len(q) < sp.batch_size and wait > 0.0:
                t_flush = q[0][0] + wait
                # the window never outwaits the tightest member's request
                # deadline (MicroBatcher discipline on the virtual clock)
                dls = [e.deadline_at for _, e in q if e.deadline_at is not None]
                if dls:
                    t_flush = min(t_flush, min(dls))
                if t_flush > self._clock:
                    # partial batch inside its window: hold it and schedule
                    # ONE flush poll at window close
                    if self._poll_at.get(stage, float("inf")) > t_flush:
                        self._poll_at[stage] = t_flush
                        heapq.heappush(pq, _SimItem(t_flush, seq, "poll",
                                                    stage))
                        seq += 1
                    break
            entries = [q.popleft() for _ in range(min(sp.batch_size, len(q)))]
            batch = [e for _, e in entries]
            st = self.stats[stage]
            st.queue_wait_s += sum(self._clock - t for t, _ in entries)
            if self.tracer is not None:
                for e in batch:
                    self.tracer.dequeued(e, stage, self._clock)
            # deadline gate at dispatch: expired events finish timed-out
            # NOW, consuming no server time here or downstream
            expired = [e for e in batch if e.deadline_at is not None
                       and self._clock > e.deadline_at]
            if expired:
                st.expired += len(expired)
                for e in expired:
                    e.meta["timed_out"] = True
                    e.meta.pop("cost_s", None)
                    e.done_at = self._clock
                    if self.tracer is not None:
                        self.tracer.expired(e, stage, self._clock)
                        self.tracer.finish(e, self._clock)
                self._done.extend(expired)
                batch = [e for e in batch if not e.meta.get("timed_out")]
                if not batch:
                    continue
            t0 = self._clock
            if self.tracer is not None:
                self.tracer.exec_begin(batch, stage, t0)
            try:
                out = sp.op(batch, self.ctx) or []
                op_error = None
            except Exception as e:  # noqa: BLE001 — error-terminal, not a
                # wedged simulated server
                log.exception("stage %r op raised; failing its batch "
                              "terminally", stage)
                st.errors += len(batch)
                op_error = f"{type(e).__name__}: {e}"
                out = list(batch)
                for ev in out:
                    ev.meta["error"] = op_error
                    ev.meta["_terminal"] = True
            for e in batch:
                if e.meta.pop("_degraded", None):
                    st.degraded += 1
            dt = self.service_time(sp, batch)
            if self.tracer is not None:
                if op_error is not None:
                    self.tracer.exec_end(batch, stage, t0 + dt,
                                         error=op_error)
                else:
                    self.tracer.exec_end(batch, stage, t0 + dt)
            for e in batch:                     # cost consumed by THIS stage
                e.meta.pop("cost_s", None)
            frees[si] = t0 + dt
            st.busy_s += dt
            heapq.heappush(pq, _SimItem(t0 + dt, seq, "finish",
                                        (stage, si, batch, out)))
            seq += 1
        return seq

    def _enqueue(self, stage: str, ev: Event):
        q = self._queues[stage]
        st = self.stats[stage]
        if len(q) >= self.plan.stages[stage].max_queue:
            st.overflows += 1
            if self.overflow_policy is not None:
                dropped_ev = ev
                ev = self.overflow_policy(stage, ev, self.ctx)
                if ev is None:                  # request shed at the channel
                    st.dropped += 1
                    self._dropped += 1
                    if self.tracer is not None:
                        self.tracer.dropped(dropped_ev, stage, self._clock)
                    return
        if self.tracer is not None:
            self.tracer.enqueued(ev, stage, self._clock)
        q.append((self._clock, ev))
        st.max_depth = max(st.max_depth, len(q))

    def _emit(self, stage: str, events):
        succs = self.plan.succs[stage]
        for ev in events:
            targets = ([ev.route] if ev.route in succs else succs)
            ev.route = None
            if ev.meta.pop("_terminal", False):
                targets = []     # expired/errored: straight to the sink
            if not targets:
                ev.done_at = self._clock
                if self.tracer is not None:
                    self.tracer.finish(ev, self._clock)
                self._done.append(ev)
                continue
            for t in targets:
                self._enqueue(t, ev)


# -------------------------------------------------------------- Legacy

class LegacyExecutor:
    """§2 baseline: data-parallel batches; batches run in parallel across
    the fleet, but WITHIN a batch every stage is a BARRIER — the batch moves
    at the pace of its slowest item (pipeline stall on long-tail candidates),
    with zero cross-stage overlap. Caches/routing shortcuts don't exist in
    the legacy design, so ops still execute but `route` shortcuts are
    ignored (every event pays the full stage list)."""

    def __init__(self, plan: Plan, service_time: Optional[Callable] = None,
                 batch_size: int = 8):
        self.plan = plan
        self.batch_size = batch_size
        self.service_time = service_time or SimExecutor._default_service_time
        self.ctx = ExecContext(self)
        self._clock = 0.0
        self.stats = defaultdict(StageStats)

    def _now(self):
        return self._clock

    def _depth(self, stage):
        return 0

    def run(self, arrivals: list[tuple[float, Event]], source=None) -> RunReport:
        done: list[Event] = []
        order = self.plan.order
        t_first = arrivals[0][0] if arrivals else 0.0
        t_last = t_first
        for start in range(0, len(arrivals), self.batch_size):
            chunk = arrivals[start:start + self.batch_size]
            evs = []
            for t, ev in chunk:
                ev.born_at = t
                evs.append(ev)
            # batch can't start until it has filled
            t = chunk[-1][0]
            self._clock = t
            for stage in order:
                sp = self.plan.stages[stage]
                out = sp.op(list(evs), self.ctx) or []
                # barrier: parallel workers amortize the bulk, but the batch
                # leaves only when the SLOWEST item does
                bulk = self.service_time(sp, evs) / max(1, sp.parallelism)
                tail = max((e.meta.get("cost_s", sp.sim_per_item_s)
                            for e in evs), default=0.0)
                dt = sp.sim_base_s + bulk + tail
                for e in evs:                   # cost consumed by THIS stage
                    e.meta.pop("cost_s", None)
                t += dt
                st = self.stats[stage]
                st.events += len(evs)
                st.batches += 1
                st.busy_s += dt * max(1, sp.parallelism)   # workers held idle
                evs = out
                for e in evs:
                    e.route = None                          # no shortcuts
            for ev in evs:
                ev.done_at = t
                done.append(ev)
            t_last = max(t_last, t)
        hist = Histogram("latency_s", "end-to-end request latency")
        for e in done:
            hist.observe(e.done_at - e.born_at)
        return RunReport(latencies=[e.done_at - e.born_at for e in done],
                         stage_stats=dict(self.stats),
                         makespan_s=t_last - t_first, results=done,
                         offered=len(arrivals), completed=len(done),
                         latency_hist=hist)
