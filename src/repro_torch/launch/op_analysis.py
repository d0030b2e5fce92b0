"""Op counter for the roofline: FLOPs / bytes / collective traffic of one
step of a cell, counted as PyTorch dispatches it.

The port's counterpart of the reference's ``launch/hlo_analysis.py``,
which parses compiled HLO text. Eager PyTorch has no compiled program to
parse, so :class:`OpCounter`, a ``TorchDispatchMode``, sees every aten op
a step dispatches (autograd's backward ops too) and accumulates:

  * flops            — matrix products (mm, addmm, bmm, baddbmm, convolution,
                       fused attention) by ``torch.utils.flop_counter``'s
                       formulas: 2 · M · N · K for a product, as the HLO
                       analyzer counts a dot; every other op counts 0
  * bytes            — Σ over dispatched ops of (operand + output bytes).
                       Each eager op is a top-level op, the counterpart of
                       "fusion internals excluded"; views and allocations
                       move no bytes and are skipped
  * collective_bytes — 0: the port runs on one device (ROADMAP A8)

A Python loop dispatches its body once per trip, so loops count once per
trip by construction: the counterpart of the HLO analyzer's while-loop
trip-count multipliers.

The hand-written kernels launch through ctypes, which the dispatcher
cannot see; while a counter is active each wrapper adds its kernel's
``cost(...)`` (``kernels/<name>/ops.py``, the formulas of
``chip_smoke.py``'s roofline bound) to it.
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils.flop_counter import flop_registry
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels as K

#: ops that allocate or alias without moving bytes (views are skipped by
#: ``OpOverload.is_view``)
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "lift_fresh", "alias",
             "_local_scalar_dense", "set_", "resize_", "record_stream"}
#: ops a summary lists, by bytes moved
TOP_OPS = 12


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: step()`` → ``c.summary()``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_op: dict = defaultdict(lambda: [0, 0, 0])     # n, flops, bytes
        self.kernels: dict = defaultdict(lambda: [0, 0, 0])   # launches, ...
        self._muted = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._muted:
            return out
        name = func._overloadpacket.__name__
        if func.is_view or name in _NO_BYTES:
            return out
        flops = 0
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = int(formula(*args, **kwargs, out_val=out))
        nbytes = (_nbytes(_tensors(args)) + _nbytes(_tensors(kwargs))
                  + _nbytes(_tensors(out)))
        self._add(self.by_op[name], flops, nbytes)
        return out

    def _add(self, row, flops, nbytes):
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def add_kernel(self, name: str, cost):
        """One launch of hand-written kernel ``name``; ``cost()`` gives its
        (flops, bytes). The ops ``cost`` itself dispatches (a unique count,
        a mask's sum) are not the step's and are not counted."""
        self._muted = True
        try:
            flops, nbytes = cost()
        finally:
            self._muted = False
        self._add(self.kernels[name], int(flops), int(nbytes))

    def __enter__(self):
        K.add_cost_sink(self)
        return super().__enter__()

    def __exit__(self, *exc):
        K.remove_cost_sink(self)
        return super().__exit__(*exc)

    def summary(self) -> dict:
        """The reference analyzer's totals (per device: one device here),
        the ops moving the most bytes, and every kernel's share."""
        ops = sorted(self.by_op.items(), key=lambda kv: -kv[1][2])[:TOP_OPS]
        return {"flops_per_device": float(self.flops),
                "bytes_per_device": float(self.bytes),
                "collective_bytes_per_device": 0.0,
                "top_ops": {k: {"n": n, "flops": f, "bytes": b}
                            for k, (n, f, b) in ops},
                "kernels": {k: {"launches": n, "flops": f, "bytes": b}
                            for k, (n, f, b) in self.kernels.items()}}


def count_ops(fn, *args, **kwargs) -> tuple:
    """``fn(*args, **kwargs)`` under an :class:`OpCounter`: (its result,
    the counter's summary)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.summary()
