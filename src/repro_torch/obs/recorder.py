"""History recorder — the IRM's "historical logs" artifact (DESIGN.md
§10.4, ROADMAP item 4 data plane).

``StatsRecorder`` samples a ``MetricsRegistry`` (plus arbitrary caller
extras — knob vectors, per-stage latencies) on an interval into an
append-only windowed timeseries log:

    <dir>/win_<n>/samples.jsonl     one JSON object per sample
    <dir>/win_<n>/CHECKSUMS         sha256 of samples.jsonl
    <dir>/win_<n>/DONE              empty marker, written LAST

The publish discipline mirrors the delta log: a window is visible to
readers only once DONE exists, and DONE is written after the data +
checksum — a reader polling mid-write (or after a crash) sees either the
whole window or nothing. ``read_history`` verifies checksums and skips
torn windows, so ``irm/offline.py`` consumes only intact history.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Callable, Optional

from repro_torch.obs.metrics import MetricsRegistry

_SAMPLES = "samples.jsonl"
_CHECKSUMS = "CHECKSUMS"
_DONE = "DONE"


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _publish_window(dirpath: str, samples: list[dict]) -> None:
    os.makedirs(dirpath, exist_ok=True)
    done = os.path.join(dirpath, _DONE)
    if os.path.exists(done):          # unpublish before rewrite
        os.remove(done)
    spath = os.path.join(dirpath, _SAMPLES)
    with open(spath, "w") as f:
        for s in samples:
            f.write(json.dumps(s, sort_keys=True, default=str) + "\n")
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(dirpath, _CHECKSUMS), "w") as f:
        f.write(f"{_sha256_file(spath)}  {_SAMPLES}\n")
        f.flush()
        os.fsync(f.fileno())
    with open(done, "w"):             # the atomic publish bit, LAST
        pass


class StatsRecorder:
    """Samples ``registry.snapshot()`` every ``interval_s`` into windows of
    ``window_samples`` samples each. Run it as a daemon thread
    (``start``/``stop``) or drive it manually (``sample``/``roll``) — the
    benches and IRM log collection use manual mode for determinism."""

    def __init__(self, out_dir: str, registry: MetricsRegistry,
                 interval_s: float = 1.0, window_samples: int = 60,
                 extra_fn: Optional[Callable[[], dict]] = None,
                 clock: Callable[[], float] = time.time):
        self.out_dir = out_dir
        self.registry = registry
        self.interval_s = interval_s
        self.window_samples = window_samples
        self.extra_fn = extra_fn
        self.clock = clock
        os.makedirs(out_dir, exist_ok=True)
        self._buf: list[dict] = []
        self._win = self._next_window_index()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples_taken = 0
        self.windows_published = 0

    def _next_window_index(self) -> int:
        mx = -1
        for name in os.listdir(self.out_dir):
            if name.startswith("win_"):
                try:
                    mx = max(mx, int(name.split("_", 1)[1]))
                except ValueError:
                    continue
        return mx + 1

    # ----------------------------------------------------------- manual

    def sample(self, extra: Optional[dict] = None) -> dict:
        """Take one sample now. ``extra`` fields (e.g. the IRM's knob
        vector + measured objective) are merged at top level under
        ``extra`` so registry keys can never collide with them."""
        rec = {"t": self.clock(), "metrics": self.registry.snapshot()}
        if self.extra_fn is not None:
            try:
                rec.setdefault("extra", {}).update(self.extra_fn() or {})
            except Exception:  # noqa: BLE001 — telemetry must not wedge
                pass
        if extra:
            rec.setdefault("extra", {}).update(extra)
        with self._lock:
            self._buf.append(rec)
            self.samples_taken += 1
            if len(self._buf) >= self.window_samples:
                self._roll_locked()
        return rec

    def roll(self) -> None:
        """Publish the current partial window (if any)."""
        with self._lock:
            self._roll_locked()

    def _roll_locked(self) -> None:
        if not self._buf:
            return
        _publish_window(os.path.join(self.out_dir, f"win_{self._win}"),
                        self._buf)
        self._buf = []
        self._win += 1
        self.windows_published += 1

    # ----------------------------------------------------------- thread

    def start(self) -> "StatsRecorder":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.sample()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="stats-recorder")
        self._thread.start()
        return self

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        th, self._thread = self._thread, None
        if th is not None:
            th.join(timeout=2.0)
        if flush:
            self.roll()


def read_history(out_dir: str, verify: bool = True) -> list[dict]:
    """All samples from published (DONE-marked) windows, in window order.
    Torn or checksum-mismatched windows are skipped, not raised — history
    reads must survive a recorder crash mid-window."""
    if not os.path.isdir(out_dir):
        return []
    wins = []
    for name in os.listdir(out_dir):
        if name.startswith("win_"):
            try:
                wins.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
    samples: list[dict] = []
    for _, name in sorted(wins):
        full = os.path.join(out_dir, name)
        spath = os.path.join(full, _SAMPLES)
        if not os.path.exists(os.path.join(full, _DONE)):
            continue
        if not os.path.exists(spath):
            continue
        if verify:
            cpath = os.path.join(full, _CHECKSUMS)
            try:
                with open(cpath) as f:
                    want = f.read().split()[0]
                if _sha256_file(spath) != want:
                    continue
            except (OSError, IndexError):
                continue
        with open(spath) as f:
            for line in f:
                line = line.strip()
                if line:
                    samples.append(json.loads(line))
    return samples
