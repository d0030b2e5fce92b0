"""Request batching for the DNN serving stage.

Two disciplines, matching the two serving regimes in the paper's funnel:

  * ``MicroBatcher`` — recsys scoring: collect up to ``max_batch`` requests
    or ``max_wait_s``, whichever first (the per-stage batch knob of Table 6,
    as an online component rather than a SimExecutor parameter).
  * ``ContinuousBatcher`` — LM decode: fixed-width slot table; sequences
    join/leave between steps (vLLM-style continuous batching on a static
    XLA shape — slots are masked, not re-compiled).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np


@dataclass
class MicroBatcher:
    max_batch: int = 32
    max_wait_s: float = 0.002
    _buf: list = field(default_factory=list)
    _first_at: float = 0.0
    _min_deadline: Optional[float] = None

    def offer(self, item, now: Optional[float] = None,
              deadline_at: Optional[float] = None) -> Optional[list]:
        """``deadline_at``: the item's absolute request deadline, when it
        carries one — the batch's effective flush deadline becomes its
        TIGHTEST member's (a batching window must never be the reason an
        almost-expired request times out in the buffer)."""
        now = time.monotonic() if now is None else now
        if not self._buf:
            self._first_at = now
            self._min_deadline = None
        self._buf.append(item)
        if deadline_at is not None:
            self._min_deadline = (deadline_at if self._min_deadline is None
                                  else min(self._min_deadline, deadline_at))
        if len(self._buf) >= self.max_batch:
            return self.flush()
        return None

    def poll(self, now: Optional[float] = None) -> Optional[list]:
        now = time.monotonic() if now is None else now
        # compare against deadline() (the same expression the scheduler
        # sleeps on) — a recomputed subtraction form disagrees with it in
        # the last ulp at large clock values, making the boundary poll a
        # no-op
        if self._buf and now >= self.deadline():
            return self.flush()
        return None

    def flush(self) -> Optional[list]:
        if not self._buf:
            return None
        out, self._buf = self._buf, []
        self._min_deadline = None
        return out

    def deadline(self) -> float:
        """When the currently-buffered partial batch must flush: the
        batching-window close, pulled earlier to the tightest member's
        request deadline (undefined when empty — check ``len`` first)."""
        window = self._first_at + self.max_wait_s
        if self._min_deadline is not None:
            return min(window, self._min_deadline)
        return window

    def __len__(self) -> int:
        return len(self._buf)


@dataclass
class Slot:
    request_id: Optional[int] = None
    length: int = 0
    max_new: int = 0
    done: bool = False


class ContinuousBatcher:
    """Static (B_slots, S_max) decode table. join() claims a free slot after
    prefill; step() decodes every active slot; finished slots free up for
    waiting requests — throughput stays high without recompilation."""

    def __init__(self, n_slots: int, s_max: int):
        self.n_slots = n_slots
        self.s_max = s_max
        self.slots = [Slot() for _ in range(n_slots)]
        self.waiting: list[tuple[int, int, int]] = []   # (req, prompt_len, max_new)
        self.completed: list[int] = []

    def submit(self, request_id: int, prompt_len: int, max_new: int):
        self.waiting.append((request_id, prompt_len, max_new))
        self._admit()

    def _admit(self):
        for slot in self.slots:
            if slot.request_id is None and self.waiting:
                req, plen, mx = self.waiting.pop(0)
                slot.request_id, slot.length, slot.max_new = req, plen, mx
                slot.done = False

    @property
    def active_mask(self) -> np.ndarray:
        return np.array([s.request_id is not None and not s.done
                         for s in self.slots])

    def lengths(self) -> np.ndarray:
        return np.array([s.length for s in self.slots], np.int32)

    def step_complete(self, eos: np.ndarray):
        """Advance every active slot by one token; eos (B_slots,) bool marks
        sequences that just finished."""
        for i, slot in enumerate(self.slots):
            if slot.request_id is None or slot.done:
                continue
            slot.length += 1
            slot.max_new -= 1
            if bool(eos[i]) or slot.max_new <= 0 or slot.length >= self.s_max:
                self.completed.append(slot.request_id)
                self.slots[i] = Slot()
        self._admit()

    @property
    def utilization(self) -> float:
        return float(self.active_mask.mean())
