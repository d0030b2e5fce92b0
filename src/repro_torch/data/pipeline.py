"""Host-side input pipeline: double-buffered prefetch + straggler-tolerant
shard leasing. Overlaps batch synthesis/IO with device compute (the training
analogue of SEDP's async stages)."""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

from repro_torch.train.elastic import ShardLease, lease_shards


class Prefetcher:
    def __init__(self, make_batch: Callable[[int], dict], depth: int = 2):
        self.make_batch = make_batch
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            b = self.make_batch(self._step)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self.q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self.q.get()

    def close(self):
        self._stop.set()


class LeasedShardReader:
    """Every shard has a primary and a backup worker; whoever reports first
    wins — a slow/dead reader cannot stall the epoch (backup-task pattern)."""

    def __init__(self, n_shards: int, worker_ids: list[int]):
        self.leases = lease_shards(n_shards, worker_ids)
        self._lock = threading.Lock()

    def assignments(self, worker: int) -> list[int]:
        return [l.shard_id for l in self.leases
                if worker in (l.primary, l.backup)]

    def try_complete(self, shard_id: int, worker: int) -> bool:
        with self._lock:
            lease = self.leases[shard_id]
            if lease.completed_by is not None:
                return False
            if worker not in (lease.primary, lease.backup):
                return False
            lease.completed_by = worker
            return True

    @property
    def remaining(self) -> int:
        return sum(1 for l in self.leases if l.completed_by is None)
