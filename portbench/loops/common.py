"""Pieces shared by the dispatch loops."""
from __future__ import annotations

import contextlib
import math
import time

import torch


class _HostDone:
    """Stands in for a CUDA event where the work ran on the host."""

    def record(self):
        pass

    def synchronize(self):
        pass


def event(device: torch.device):
    return torch.cuda.Event() if device.type == "cuda" else _HostDone()


def host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """Pinned host memory where the device copies its answers."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def tf32(on: bool):
    """float32 products in TF32 (on) or in full float32 (off) inside."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The widest |a - b|; infinite where either is not finite."""
    d = (a.double() - b.double()).abs()
    return math.inf if not bool(torch.isfinite(d).all()) else float(d.max())


def until(seconds, count):
    """A predicate over the number of calls made so far: true while the
    loop should go on, for ``seconds`` of the host's clock or for
    ``count`` calls."""
    if seconds is None:
        return lambda n: n < count
    deadline = time.perf_counter() + seconds
    return lambda n: time.perf_counter() < deadline
