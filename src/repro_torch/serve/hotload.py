"""Model hot-loading (paper §7): serve new model generations without
interrupting the service — a monitor tracks the training cluster's output;
when a new generation appears (identified by generation timestamp), it is
pulled and swapped in via DOUBLE BUFFERING: in-flight requests finish on the
old buffer, new requests bind the new one.

Two watcher flavours share one polling skeleton (``PollWatcher``):

  * ``ModelMonitor`` — whole-generation swaps into a ``DoubleBuffer``
    (the §7 path: a full snapshot replaces the previous one).
  * ``repro.update.delta.DeltaWatcher`` — the streaming delta path
    (DESIGN.md §6): versioned delta batches applied into the live cube.

A failing loader/apply no longer stalls updates silently: the poll loop
catches the exception, LOGS it, and retries with exponential backoff
(reset on the next success), keeping the serving path alive while the
training side republishes a bad artifact.
"""
from __future__ import annotations

import logging
import os
import random
import threading
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

from repro_torch.obs.log import log_event

log = logging.getLogger(__name__)


@dataclass
class Generation:
    stamp: int
    payload: Any            # params pytree / jitted fns / cube handle


class DoubleBuffer:
    """Lock-free reads (python ref assignment is atomic); writers swap.

    ``on_swap`` callbacks fire after each successful publish — the cache-
    coherence hook: the query cache's scores were computed by the OLD
    generation, so `InferenceService` registers its
    ``QueryCache.bump_model_version`` here (DESIGN.md §6.4)."""

    def __init__(self, initial: Generation):
        self._active = initial
        self._standby: Optional[Generation] = None
        self._lock = threading.Lock()
        self.swaps = 0
        self.on_swap: List[Callable[[Generation], None]] = []

    @property
    def active(self) -> Generation:
        return self._active

    def load(self, gen: Generation):
        with self._lock:
            if gen.stamp <= self._active.stamp:
                return False             # stale generation — ignore
            self._standby = gen
            # atomically publish; old generation stays alive for in-flight
            # requests holding a reference (GC reclaims when they finish)
            self._active = gen
            self._standby = None
            self.swaps += 1
        for cb in self.on_swap:
            cb(gen)
        return True


class PollWatcher:
    """Thread that polls ``check_once()`` every ``poll_s`` seconds, with
    logged exponential backoff on failure.

    A loader exception used to be swallowed with a bare ``pass`` — the
    monitor would silently hammer the same broken artifact every tick with
    no operator signal. Now each consecutive failure doubles the wait (up
    to ``max_backoff_s``), the exception is logged, and ``failures`` /
    ``last_error`` expose the state to health checks; the first success
    resets the backoff.

    ``jitter`` (default on) decorrelates the retries: a fleet of watchers
    that all saw the same bad artifact would otherwise re-poll it in
    LOCKSTEP at 1s, 2s, 4s, ... — a synchronized thundering herd on the
    artifact store every power-of-two tick. Decorrelated jitter (sleep =
    uniform(poll_s, 3 × previous sleep), capped at ``max_backoff_s``)
    spreads them out while keeping the same growth rate and cap;
    ``jitter_seed`` pins the sequence for deterministic tests."""

    def __init__(self, poll_s: float = 1.0, max_backoff_s: float = 30.0,
                 jitter: bool = True, jitter_seed: Optional[int] = None):
        self.poll_s = poll_s
        self.max_backoff_s = max_backoff_s
        self.jitter = jitter
        self.failures = 0               # consecutive failures (resets on ok)
        self.total_failures = 0
        self.last_error: Optional[BaseException] = None
        self._rng = random.Random(jitter_seed)
        self._prev_backoff = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check_once(self) -> bool:       # pragma: no cover - abstract
        raise NotImplementedError

    def _backoff_s(self) -> float:
        if not self.failures:
            self._prev_backoff = 0.0
            return self.poll_s
        # cap the exponent: 2.0**1024 raises OverflowError, which would
        # escape loop() (the wait runs outside the try) and silently kill
        # the watcher thread after ~1k consecutive failures
        exp = min(self.poll_s * (2.0 ** min(self.failures, 30)),
                  self.max_backoff_s)
        if not self.jitter:
            self._prev_backoff = exp
            return exp
        prev = self._prev_backoff if self._prev_backoff > 0 else self.poll_s
        hi = max(self.poll_s, min(self.max_backoff_s, prev * 3.0))
        self._prev_backoff = self._rng.uniform(self.poll_s, hi)
        return self._prev_backoff

    def start(self):
        def loop():
            while not self._stop.is_set():
                try:
                    self.check_once()
                    self.failures = 0
                    self.last_error = None
                    wait = self._backoff_s()
                except Exception as e:  # noqa: BLE001 — keep serving
                    self.failures += 1
                    self.total_failures += 1
                    self.last_error = e
                    # sample the (jittered) backoff ONCE per tick: the
                    # logged wait must be the wait actually slept
                    wait = self._backoff_s()
                    log_event(log, "watcher_poll_failed",
                              level=logging.WARNING,
                              watcher=type(self).__name__,
                              attempt=self.failures, retry_in_s=wait,
                              error=f"{type(e).__name__}: {e}")
                self._stop.wait(wait)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


class ModelMonitor(PollWatcher):
    """Polls a 'remote address' (directory) for new generation stamps and
    hot-loads them. Thread-based; ``check_once`` is used by tests."""

    def __init__(self, watch_dir: str, buffer: DoubleBuffer,
                 loader: Callable[[str], Any], poll_s: float = 1.0,
                 max_backoff_s: float = 30.0, **kw):
        super().__init__(poll_s=poll_s, max_backoff_s=max_backoff_s, **kw)
        self.watch_dir = watch_dir
        self.buffer = buffer
        self.loader = loader

    def latest_stamp(self) -> Optional[int]:
        if not os.path.isdir(self.watch_dir):
            return None
        stamps = [int(d.split("_")[-1]) for d in os.listdir(self.watch_dir)
                  if d.startswith("gen_") and
                  os.path.exists(os.path.join(self.watch_dir, d, "DONE"))]
        return max(stamps) if stamps else None

    def check_once(self) -> bool:
        stamp = self.latest_stamp()
        if stamp is None or stamp <= self.buffer.active.stamp:
            return False
        path = os.path.join(self.watch_dir, f"gen_{stamp}")
        payload = self.loader(path)
        loaded = self.buffer.load(Generation(stamp, payload))
        if loaded:
            log_event(log, "model_hot_swap", watcher=type(self).__name__,
                      version=stamp, path=path)
        return loaded
