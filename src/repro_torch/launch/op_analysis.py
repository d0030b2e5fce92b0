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
                       move no bytes and are skipped. A collective of
                       ``runtime`` is one op (its input and output, as the
                       HLO analyzer counts a collective's operands and
                       result); what its backend dispatches to carry it
                       out is not counted
  * collective_bytes — the ring-model traffic of the collectives the step
                       made on the current mesh (each handed to the
                       counter by ``runtime`` as it is issued, backward
                       ones too, by kind and group), by the reference's
                       factors per kind (``hlo_analysis.py``'s
                       ``_collective_traffic``); 0 without a mesh
  * peak bytes       — the most bytes the step's own storages held at
                       once: each storage an op makes (allocations
                       included, views and in-place writes make none) is
                       live from the op that makes it until its last
                       reference goes (a weakref); the arguments, made
                       before the count, are the caller's to add

A Python loop dispatches its body once per trip, so loops count once per
trip by construction: the counterpart of the HLO analyzer's while-loop
trip-count multipliers.

The hand-written kernels launch through ctypes, which the dispatcher
cannot see; while a counter is active (on the thread's dispatch mode
stack, which autograd's threads inherit) each wrapper adds its kernel's
``cost(...)`` (``kernels/<name>/ops.py``, the formulas of
``chip_smoke.py``'s roofline bound) to it. On the ``meta`` device (a dry
run) a cost that reads data takes its bound, and the summary names the
kernels so counted (``bounded_kernels``).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
from torch.utils.flop_counter import flop_registry
from torch.utils._python_dispatch import TorchDispatchMode


#: ops that allocate or alias without moving bytes (views are skipped by
#: ``OpOverload.is_view``)
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "lift_fresh", "alias",
             "_local_scalar_dense", "set_", "resize_", "record_stream"}
#: ops a summary lists, by bytes moved
TOP_OPS = 12


def collective_traffic(kind: str, out_bytes: int, g: int) -> float:
    """Bytes one device moves for collectives of ``kind`` over groups of
    ``g`` whose outputs total ``out_bytes`` (the ring model); a
    backward's (``kind/bwd``) and a recompute's (``kind/recompute``) by
    their collective's."""
    if g <= 1:
        return 0.0
    kind = kind.split("/")[0]
    if kind == "all_reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if kind == "reduce_scatter":
        return float(out_bytes) * (g - 1)
    if kind in ("all_gather", "all_to_all"):
        return float(out_bytes) * (g - 1) / g
    return float(out_bytes)          # collective-permute, broadcast


def collectives_by_kind(rows: dict) -> dict:
    """``runtime.CollectiveCounts`` rows ({(kind, group): (calls, bytes)})
    by kind: calls, output bytes and ring-model traffic."""
    out: dict = {}
    for (kind, g), (calls, nbytes) in sorted(rows.items()):
        row = out.setdefault(kind, {"calls": 0, "bytes": 0,
                                    "traffic_bytes": 0.0})
        row["calls"] += calls
        row["bytes"] += nbytes
        row["traffic_bytes"] += collective_traffic(kind, nbytes, g)
    return out


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
        self._groups: dict = defaultdict(lambda: [0, 0])  # (kind, axes, g)
        self.bounded: dict = {}                               # kernel → bound
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: set = set()       # the storages made here, still held

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._muted:
            return out
        name = func._overloadpacket.__name__
        if not func.is_view:
            self._track(args, kwargs, out)
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

    def _track(self, args, kwargs, out):
        """Count each storage of ``out`` that none of the op's inputs
        holds and that is not counted yet as made now, until it goes."""
        made = [t.untyped_storage() for t in _tensors(out)]
        if not made:
            return
        held = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
        for st in made:
            key = st._cdata
            if key in held or key in self._live:
                continue
            n = st.nbytes()
            self._live.add(key)
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        self._live.discard(key)
        self.live_bytes -= n

    def _add(self, row, flops, nbytes):
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self.flops += flops
        self.bytes += nbytes

    @contextlib.contextmanager
    def muted(self):
        """Count no op inside: a collective's exchange (``runtime``)."""
        was, self._muted = self._muted, True
        try:
            yield
        finally:
            self._muted = was

    def add_collective(self, kind: str, axes: tuple, g: int, x, out):
        """One collective of ``runtime`` over ``axes`` (a group of ``g``
        ranks): its input and output bytes, its output's storage where
        the exchange made one, and its call and output bytes by kind and
        by group."""
        self._track((x,), {}, out)
        self._add(self.by_op[kind.split("/")[0]], 0, _nbytes([x, out]))
        row = self._groups[(kind, axes, g)]
        row[0] += 1
        row[1] += _nbytes([out])

    def add_kernel(self, name: str, cost, bound=None):
        """One launch of hand-written kernel ``name``; ``cost()`` gives its
        (flops, bytes). The ops ``cost`` itself dispatches (a unique count,
        a mask's sum) are not the step's and are not counted. ``bound``
        (a dry launch's) names what the cost took as its bound."""
        if bound is not None:
            self.bounded[name] = bound
        with self.muted():
            flops, nbytes = cost()
        self._add(self.kernels[name], int(flops), int(nbytes))

    def summary(self) -> dict:
        """The reference analyzer's totals per device (this rank's, on a
        mesh), the ops moving the most bytes, every kernel's share, the
        collectives by kind and by group (kind, the mesh axes, group size,
        calls, output bytes, ring-model traffic), the peak of the step's
        own storages and the kernels whose cost is a bound."""
        ops = sorted(self.by_op.items(), key=lambda kv: -kv[1][2])[:TOP_OPS]
        by_group: dict = defaultdict(lambda: [0, 0])      # (kind, g)
        for (kind, _, g), (n, b) in self._groups.items():
            by_group[(kind, g)][0] += n
            by_group[(kind, g)][1] += b
        by_kind = collectives_by_kind(by_group)
        return {"flops_per_device": float(self.flops),
                "bytes_per_device": float(self.bytes),
                "collective_bytes_per_device": float(sum(
                    r["traffic_bytes"] for r in by_kind.values())),
                "collectives_by_kind": by_kind,
                "collectives_by_group": [
                    {"kind": kind, "axes": list(axes), "group": g,
                     "calls": n, "bytes": b,
                     "traffic_bytes": collective_traffic(kind, b, g)}
                    for (kind, axes, g), (n, b) in sorted(
                        self._groups.items())],
                "top_ops": {k: {"n": n, "flops": f, "bytes": b}
                            for k, (n, f, b) in ops},
                "kernels": {k: {"launches": n, "flops": f, "bytes": b}
                            for k, (n, f, b) in self.kernels.items()},
                "peak_bytes": self.peak_bytes,
                "bounded_kernels": dict(self.bounded)}


def count_ops(fn, *args, **kwargs) -> tuple:
    """``fn(*args, **kwargs)`` under an :class:`OpCounter`: (its result,
    the counter's summary)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.summary()
