"""Bulk scoring: batches of independent (user, item) pairs through the
program's ``serve_scores``, the DNN stage's merged micro-batch.

A ring of batches is made on the device in set-up. ``in_flight`` batches
are in flight: after a batch is enqueued (its scores' copy to pinned
host memory included), the host waits for the oldest once that many are
pending. A batch's latency runs from its enqueue to the host seeing its
scores. The rate is over all pairs whose scores reached the host and all
the time from the first enqueue to the last arrival."""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from portbench import gen, program
from portbench.loops.common import event, gap, host_buffer, sync, tf32, until


class Loop:
    name = "pairs"

    def __init__(self, cell):
        self.cell = cell
        t = cell.traffic
        self.ring = [gen.pairs_batch(cell.gen, cell.cfg, t)
                     for _ in range(t["ring"])]
        self.batch = t["batch"]
        self.in_flight = t["in_flight"]
        self.prog = program.module(cell.cfg)
        self.pcfg = program.recsys_config(cell.cfg)
        self.host = host_buffer((len(self.ring), self.batch), torch.float32,
                                cell.device)
        self.events = [event(cell.device) for _ in range(self.in_flight)]

    def _enqueue(self, slot: int):
        s = self.prog.serve_scores(self.cell.weights, self.ring[slot],
                                   self.pcfg)
        self.host[slot].copy_(s, non_blocking=True)

    def run(self, seconds=None, count=None) -> dict:
        """Dispatch for ``seconds`` (or ``count`` batches) and wait for
        every batch enqueued: {"seconds", "items", "slots" (batches done
        a ring slot), "latencies" (s)}."""
        ring = len(self.ring)
        slots = np.zeros(ring, dtype=np.int64)
        lat: list[float] = []
        pending: deque = deque()
        go = until(seconds, count)
        n = 0
        t0 = time.perf_counter()
        while go(n):
            slot = n % ring
            t_enq = time.perf_counter()
            self._enqueue(slot)
            ev = self.events[n % self.in_flight]
            ev.record()
            pending.append((t_enq, ev, slot))
            n += 1
            while len(pending) >= self.in_flight:
                self._finish(pending.popleft(), lat, slots)
        while pending:
            self._finish(pending.popleft(), lat, slots)
        return {"seconds": time.perf_counter() - t0, "items": n * self.batch,
                "calls": n, "slots": slots, "latencies": lat}

    @staticmethod
    def _finish(entry, lat, slots):
        t_enq, ev, slot = entry
        ev.synchronize()
        lat.append(time.perf_counter() - t_enq)
        slots[slot] += 1

    def outputs(self) -> list:
        """Each ring slot's scores from its last batch, on the host."""
        return [self.host[s].clone() for s in range(len(self.ring))]

    def control(self) -> list:
        """The reference's scores computed in TF32, in the program's
        place."""
        with tf32(True):
            return [self.cell.ref.scores(self.cell.weights, b, self.cell.cfg)
                    .cpu() for b in self.ring]

    def check(self, outputs: list) -> dict:
        """The widest gap between a pair's score and the reference's."""
        worst = 0.0
        with tf32(False):
            for b, got in zip(self.ring, outputs):
                want = self.cell.ref.scores(self.cell.weights, b,
                                            self.cell.cfg)
                worst = max(worst, gap(got.to(want.device), want))
        sync(self.cell.device)
        return {"score_gap": worst}
