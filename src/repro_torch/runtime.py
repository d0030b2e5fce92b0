"""Mesh/runtime context shared by model code — the counterpart of
``repro/runtime.py``.

Model code never owns a mesh: the launcher (or a test) installs one with
``use_mesh``; layers consult ``current_mesh()`` to decide whether to run
their collective paths. With no mesh installed everything is
single-device dense PyTorch.

On a mesh the port is explicit SPMD by rank: each rank, one process of a
``torch.distributed`` job (``launch/mesh.py``), runs the same model code on
its rank-local tensors — its rows of every row-sharded table
(:class:`RowShard`), the replicated dense parameters and its part of the
batch — and every collective is an explicit call over the process group
of one mesh axis or a tuple of axes (:func:`all_gather`,
:func:`reduce_scatter`, :func:`all_reduce`, :func:`all_to_all`). Where the
reference's ``shard`` lets GSPMD pick a layout, the port's :func:`shard`
takes the rank's block of a tensor the rank holds whole.

Each collective counts its calls and bytes by kind on the mesh
(``mesh.counts``, read by ``launch/op_analysis.py``; a max reduction
counts under ``all_reduce``). Every kind goes to the backend directly,
CUDA tensors too: gloo moves all four kinds, and the max reduction, on
CUDA tensors in the card's torch (``launch/mesh.py::collective_support``,
PERF.md §6).
"""
from __future__ import annotations

import contextlib
import math
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

_MESH_STACK: list = []


def current_mesh():
    return _MESH_STACK[-1] if _MESH_STACK else None


@contextlib.contextmanager
def use_mesh(mesh):
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def axis_size(name: str) -> int:
    mesh = current_mesh()
    if mesh is None or name not in mesh.shape:
        return 1
    return mesh.shape[name]


def has_axis(name: str) -> bool:
    return axis_size(name) > 1


def batch_axes() -> tuple[str, ...]:
    """Mesh axes the global batch is sharded over (pod composes with data)."""
    axes = tuple(a for a in ("pod", "data") if has_axis(a))
    return axes or ("data",)


def data_axis_size() -> int:
    mesh = current_mesh()
    if mesh is None:
        return 1
    n = 1
    for a in ("pod", "data"):
        n *= mesh.shape.get(a, 1)
    return n


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def divides(n: int, name: str) -> bool:
    return n % axis_size(name) == 0


def splits(n: int, name: str = "model") -> bool:
    """True when a dim of ``n`` is split over mesh axis ``name`` by the
    spec rules (``launch/sharding.py``): the axis is larger than 1 and
    divides ``n``; a dim it does not divide stays whole (replicated)."""
    return axis_size(name) > 1 and n % axis_size(name) == 0


# ------------------------------------------------------------ coordinates

def mesh_axes(axes) -> tuple[str, ...]:
    """``axes`` (a name or a tuple of names) as a tuple in the mesh's
    order, without the axes the mesh lacks."""
    mesh = current_mesh()
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    if mesh is None:
        return ()
    return tuple(a for a in mesh.axis_names if a in names)


def axes_size(axes) -> int:
    """Ranks in one group over ``axes`` (1 without a mesh)."""
    return math.prod(axis_size(a) for a in mesh_axes(axes))


def axis_index(name: str) -> int:
    """The rank's coordinate on mesh axis ``name`` (the reference's
    ``lax.axis_index``); 0 without a mesh or off the mesh's axes."""
    mesh = current_mesh()
    if mesh is None or name not in mesh.shape:
        return 0
    return mesh.coords[name]


def shard_index(axes) -> int:
    """The rank's flat index over ``axes``, row-major in the mesh's order:
    the reference's ``di * n_model + mi`` over ("data", "model")."""
    idx = 0
    for a in mesh_axes(axes):
        idx = idx * axis_size(a) + axis_index(a)
    return idx


def block(n: int, axes) -> tuple[int, int]:
    """(start, length) of the rank's block of ``n`` rows split over
    ``axes``: ``n`` padded to a multiple of the group's size, equal blocks
    in flat-index order (the tiled layout of ``P(axes)``)."""
    g = axes_size(axes)
    per = pad_to_multiple(n, g) // g
    return shard_index(axes) * per, per


def shard(x: torch.Tensor, *spec) -> torch.Tensor:
    """The rank's part of ``x``, which the rank holds whole, by ``spec``
    (one entry per leading dim: None, an axis or a tuple of axes): along
    each split dim its :func:`block`, zero-padded where the dim does not
    divide. No mesh: ``x``. The counterpart of the reference's ``shard``
    at the sites where a layout changes; where it already holds, the
    port calls nothing."""
    if current_mesh() is None:
        return x
    for dim, axes in enumerate(spec):
        if axes is None or axes_size(axes) == 1:
            continue
        n = x.shape[dim]
        start, per = block(n, axes)
        stop = min(start + per, n)
        part = x.narrow(dim, min(start, n), max(stop - start, 0))
        if part.shape[dim] < per:
            pad = [0, 0] * (x.dim() - dim - 1) + [0, per - part.shape[dim]]
            part = F.pad(part, pad)
        x = part
    return x


@dataclass
class RowShard:
    """A rank's rows of a table whose rows are split over mesh ``axes``
    (the spec ``P(axes, None)``): ``local`` holds rows
    ``[start, start + len(local))`` of ``rows``. The global row count and
    the axes travel with the shard, because the rank's tensor no longer
    shows them: the sharded lookups decide their path by them."""
    local: torch.Tensor
    rows: int
    axes: tuple

    @property
    def start(self) -> int:
        return shard_index(self.axes) * self.local.shape[0]


# ------------------------------------------------------------ collectives

class CollectiveCounts:
    """Calls and bytes of a mesh's collectives, by kind and group size
    (``bytes`` is each call's output)."""

    def __init__(self):
        self.rows: dict = defaultdict(lambda: [0, 0])

    def add(self, kind: str, group: int, nbytes: int):
        row = self.rows[(kind, group)]
        row[0] += 1
        row[1] += nbytes

    def reset(self):
        self.rows.clear()

    def snapshot(self) -> dict:
        return {k: tuple(v) for k, v in self.rows.items()}

    @staticmethod
    def since(now: dict, before: dict) -> dict:
        """The rows of ``now`` less ``before``: {(kind, group): (calls,
        bytes)}."""
        out = {}
        for k, v in now.items():
            b = before.get(k, (0, 0))
            d = tuple(x - y for x, y in zip(v, b))
            if d[0]:
                out[k] = d
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective(kind: str, x: torch.Tensor, axes, op) -> torch.Tensor:
    """``op(x, group)`` over the group of ``axes``, counted."""
    mesh = current_mesh()
    axes = mesh_axes(axes)
    g = math.prod(mesh.shape[a] for a in axes) if axes else 1
    x = x.contiguous()
    if g == 1:
        return x
    out = op(x, mesh.group(axes))
    mesh.counts.add(kind, g, _nbytes(out))
    return out


def all_gather(x: torch.Tensor, axes) -> torch.Tensor:
    """The ranks' ``x`` over ``axes`` concatenated along dim 0 in flat-index
    order (``lax.all_gather(..., tiled=True)``)."""
    import torch.distributed as dist

    def op(t, group):
        out = t.new_empty((dist.get_world_size(group) * t.shape[0],
                           *t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=group)
        return out
    return _collective("all_gather", x, axes, op)


def reduce_scatter(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum over ``axes`` of ``x``, of which each rank keeps its block of
    dim 0 (``lax.psum_scatter(..., tiled=True)``); dim 0 must divide."""
    import torch.distributed as dist

    def op(t, group):
        n = dist.get_world_size(group)
        if t.shape[0] % n:
            raise ValueError(f"reduce_scatter: dim 0 of {tuple(t.shape)} "
                             f"does not split over {n} ranks")
        out = t.new_empty((t.shape[0] // n, *t.shape[1:]))
        dist.reduce_scatter_tensor(out, t, group=group)
        return out
    return _collective("reduce_scatter", x, axes, op)


def all_reduce(x: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
    """The sum (``lax.psum``) or, with ``op="max"``, the elementwise
    maximum (``lax.pmax``) over ``axes`` of ``x``; ``x`` itself may be
    overwritten with it."""
    import torch.distributed as dist
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

    def run(t, group):
        dist.all_reduce(t, op=reduce_op, group=group)
        return t
    return _collective("all_reduce", x, axes, run)


def all_to_all(x: torch.Tensor, axes) -> torch.Tensor:
    """Dim 0 of ``x`` split into one equal chunk per rank over ``axes``,
    chunk j sent to rank j, the chunks received concatenated in rank
    order (``lax.all_to_all(..., 0, 0, tiled=True)``)."""
    import torch.distributed as dist

    def op(t, group):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out
    return _collective("all_to_all", x, axes, op)


def gather_rows(x: torch.Tensor, axes, n: Optional[int] = None):
    """The whole of a tensor split over ``axes`` by :func:`block`: the
    ranks' blocks gathered, cut to ``n`` rows when given."""
    full = all_gather(x, axes) if current_mesh() is not None else x
    return full if n is None else full[:n]
