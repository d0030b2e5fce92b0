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
batch; a ZeRO-3 parameter as its block over ``data`` (:class:`DataShard`),
gathered where it is used — and every collective is an explicit call
over the process group of one mesh axis or a tuple of axes
(:func:`all_gather`, :func:`reduce_scatter`, :func:`all_reduce`,
:func:`all_to_all`). Where the reference's ``shard`` lets GSPMD pick a
layout, the port's :func:`shard` takes the rank's block of a tensor the
rank holds whole.

Each collective counts its calls and bytes by kind on the mesh
(``mesh.counts``, read by ``launch/op_analysis.py``; a max reduction
counts under ``all_reduce``): a backward's collectives as ``kind/bwd``,
and a forward collective that autograd issues again while it recomputes
a checkpointed block as ``kind/recompute``, so a training step's bytes
hold all three. An op counter active on the thread (a *watcher*: a
dispatch mode on the thread's mode stack, which the autograd threads of
a backward inherit) sees each collective as one op, its input and
output, and none of the ops the backend dispatches to carry it out; so
a dry mesh's collective, which dispatches none, counts the same as a
live one.

The rule for gradients. Training on a mesh, every rank computes the same
global loss (the mean over the whole global batch, replicated on every
rank), so a value replicated over some axes carries the same cotangent
on each of their ranks. Under that rule the collectives are
``torch.autograd.Function``s with these adjoints:

  ====================================  ==================================
  forward                               backward
  ====================================  ==================================
  all_reduce (sum) of partials          identity
  all_gather of blocks → replicated     the rank's own block, no exchange
  all_gather(partial=True): the whole   reduce_scatter (the ranks'
  feeds work each rank does in part     partial cotangents summed)
  reduce_scatter of partials → blocks   all_gather
  all_to_all                            all_to_all (its own inverse)
  all_reduce (max)                      none: detached values only
  enter(x, axes): identity              all_reduce (sum) over ``axes``
  ====================================  ==================================

:func:`enter` (Megatron's "f") goes where a value replicated over
``axes`` feeds work split over them (column-parallel weights, a rank's
experts, a rank's edges), and on a replicated parameter a rank uses only
in part: each rank's cotangent there is a partial, and the sum makes it
whole. A parameter's gradient is then partial over the batch axes its
spec does not name (each rank saw its block of the batch) and whole over
every other axis; ``train/train_step.py`` sums it over those batch axes,
or reduce-scatters it into its ZeRO shard. ``torch.distributed.nn``'s
collectives follow another rule (a sum of the cotangents in every
backward) and bypass the counts; the port does not use them. Every kind goes to the backend directly,
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


@dataclass
class DataShard:
    """A rank's block of a ZeRO-3 parameter (the reference's
    ``fsdp_params``, ``launch/specs.py:111-114``): its part by the compute
    spec, split further over ``data`` along ``dim`` (the reference's
    ``zero_specs`` splits over ``data`` only). :meth:`gather` gives the
    whole part where the model uses it, as GSPMD re-gathers a layer's
    weights on use."""
    local: torch.Tensor
    dim: int

    def gather(self) -> torch.Tensor:
        """The rank's whole part, gathered over ``data`` along ``dim``.
        The gathered part feeds work on the rank's block of the batch, so
        its backward reduce-scatters the ranks' partial cotangents
        (``all_gather(..., partial=True)``): the gradient reaches the
        train step summed over ``data`` and in the rank's block. The part
        comes back contiguous, as the ZeRO-2 rank holds it, so its
        products take the same kernels."""
        whole = all_gather(self.local.movedim(self.dim, 0), "data",
                           partial=True).movedim(0, self.dim).contiguous()
        whole._regather = _Regather(self)        # see :func:`regathered`
        return whole

    def layer(self, i: int) -> "DataShard":
        """Layer ``i`` of a stacked leaf (dim 0 the layers)."""
        if self.dim == 0:
            raise ValueError("a stacked leaf split over its layers has no "
                             "layer to take")
        return DataShard(self.local[i], self.dim - 1)


class _Regather:
    """How autograd saves a gathered ZeRO-3 weight under
    :func:`regathered`: its shard, gathered again the first time the
    backward needs it and kept while a node that saved it lives."""
    __slots__ = ("shard", "whole")

    def __init__(self, shard: DataShard):
        self.shard, self.whole = shard, None

    def get(self) -> torch.Tensor:
        if self.whole is None:
            with torch.no_grad():
                self.whole = self.shard.gather()
        return self.whole


def _pack(t: torch.Tensor):
    return getattr(t, "_regather", t)


def _unpack(saved):
    return saved.get() if isinstance(saved, _Regather) else saved


@contextlib.contextmanager
def regathered():
    """Within, autograd saves a gathered ZeRO-3 weight as its shard, and
    the backward gathers it again where it first needs it (an
    ``all_gather/recompute``; once for all the nodes that saved it): no
    rank keeps a whole weight from its forward to its backward (FSDP's
    reshard after forward; a remat layer recomputes its gathers
    anyway)."""
    with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
        yield


def gathered(tree):
    """``tree`` (dicts of parameters) with every :class:`DataShard`
    gathered (:meth:`DataShard.gather`), a :class:`RowShard` of one
    gathered around its rows; everything else as it is."""
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    if isinstance(tree, DataShard):
        return tree.gather()
    if isinstance(tree, RowShard) and isinstance(tree.local, DataShard):
        return RowShard(tree.local.gather(), tree.rows, tree.axes)
    return tree


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


def _watchers() -> list:
    """The dispatch modes on this thread's mode stack that watch
    collectives: ``w.muted()``, a context in which it counts no op, is
    entered around each collective's exchange, then
    ``w.add_collective(kind, axes, g, x, out)`` is called with its
    counted kind, its axes (in the mesh's order), the group's size, its
    input and its output."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return [m for m in _get_current_dispatch_mode_stack()
            if hasattr(m, "add_collective")]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _phase_kind(kind: str, backward: bool) -> str:
    """The counted kind of a collective: ``kind`` in the forward,
    ``kind + "/bwd"`` in a backward's adjoint, ``kind + "/recompute"``
    for a forward collective that autograd's backward issues again (a
    block under ``torch.utils.checkpoint``)."""
    if backward:
        return kind + "/bwd"
    if torch._C._current_graph_task_id() != -1:
        return kind + "/recompute"
    return kind


def _collective(kind: str, x: torch.Tensor, axes, op, mesh=None,
                backward: bool = False) -> torch.Tensor:
    """``op(x, group)`` over the group of ``axes`` on ``mesh`` (the
    current one if None), counted. On a dry mesh (``mesh.dry``: one
    rank's coordinates, no process group) ``x`` must lie on ``meta``:
    the output is the one a live group of that size gives, allocated on
    ``meta``, and counted the same."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return x.contiguous()
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    axes = tuple(a for a in mesh.axis_names if a in names)
    g = math.prod(mesh.shape[a] for a in axes) if axes else 1
    x = x.contiguous()
    if g == 1:
        return x
    if mesh.dry and x.device.type != "meta":
        raise RuntimeError(f"{kind} on a dry mesh: the tensor lies on "
                           f"{x.device}, not on meta (a dry mesh moves "
                           f"nothing)")
    watchers = _watchers()
    with contextlib.ExitStack() as quiet:
        for w in watchers:
            quiet.enter_context(w.muted())
        out = (_dry_output(kind, x, g) if mesh.dry
               else op(x, mesh.group(axes)))
    kind = _phase_kind(kind, backward)
    for w in watchers:
        w.add_collective(kind, axes, g, x, out)
    mesh.counts.add(kind, g, _nbytes(out))
    return out


def _split_rows(t, n: int, kind: str) -> int:
    """Dim 0 of ``t`` over ``n`` ranks; raises where it does not divide."""
    if t.shape[0] % n:
        raise ValueError(f"{kind}: dim 0 of {tuple(t.shape)} does not "
                         f"split over {n} ranks")
    return t.shape[0] // n


def _gather_op(t, group):
    import torch.distributed as dist
    out = t.new_empty((dist.get_world_size(group) * t.shape[0],
                       *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def _scatter_op(t, group):
    import torch.distributed as dist
    out = t.new_empty((_split_rows(t, dist.get_world_size(group),
                                   "reduce_scatter"), *t.shape[1:]))
    dist.reduce_scatter_tensor(out, t, group=group)
    return out


def _reduce_op(reduce_op):
    def run(t, group):
        import torch.distributed as dist
        dist.all_reduce(t, op=getattr(dist.ReduceOp, reduce_op), group=group)
        return t
    return run


def _to_all_op(t, group):
    import torch.distributed as dist
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _dry_output(kind: str, t, g: int):
    """The output the live collective ``kind`` gives over a group of
    ``g`` ranks, allocated on ``t``'s device (``meta``): what a dry mesh
    returns."""
    if kind == "all_gather":
        return t.new_empty((g * t.shape[0], *t.shape[1:]))
    if kind == "reduce_scatter":
        return t.new_empty((_split_rows(t, g, kind), *t.shape[1:]))
    if kind == "all_to_all":
        _split_rows(t, g, kind)
        return torch.empty_like(t)
    return t                                     # all_reduce, in place


def _block_of(mesh, axes, n: int, g: torch.Tensor) -> torch.Tensor:
    """The rank's block of ``n`` rows of ``g`` (dim 0) over ``axes``."""
    idx = 0
    for a in mesh.axis_names:
        if a in axes:
            idx = idx * mesh.shape[a] + mesh.coords[a]
    return g.narrow(0, idx * n, n)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, partial):
        ctx.mesh, ctx.axes, ctx.partial, ctx.n = (current_mesh(), axes,
                                                  partial, x.shape[0])
        return _collective("all_gather", x, axes, _gather_op)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _collective("reduce_scatter", g, ctx.axes, _scatter_op,
                               ctx.mesh, True), None, None
        return _block_of(ctx.mesh, ctx.axes, ctx.n, g), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.mesh, ctx.axes = current_mesh(), axes
        return _collective("reduce_scatter", x, axes, _scatter_op)

    @staticmethod
    def backward(ctx, g):
        return _collective("all_gather", g, ctx.axes, _gather_op, ctx.mesh,
                           True), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        return _collective("all_reduce", x.clone(), axes, _reduce_op("SUM"))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.mesh, ctx.axes = current_mesh(), axes
        return _collective("all_to_all", x, axes, _to_all_op)

    @staticmethod
    def backward(ctx, g):
        return _collective("all_to_all", g, ctx.axes, _to_all_op, ctx.mesh,
                           True), None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.mesh, ctx.axes = current_mesh(), axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _collective("all_reduce", g.clone(), ctx.axes,
                           _reduce_op("SUM"), ctx.mesh, True), None


def _recorded(x: torch.Tensor) -> bool:
    """True where autograd records an op on ``x``."""
    return torch.is_grad_enabled() and x.requires_grad


def _live(axes) -> bool:
    return current_mesh() is not None and axes_size(axes) > 1


def all_gather(x: torch.Tensor, axes, partial: bool = False) -> torch.Tensor:
    """The ranks' ``x`` over ``axes`` concatenated along dim 0 in flat-index
    order (``lax.all_gather(..., tiled=True)``). Its backward takes the
    rank's own block of the cotangent; with ``partial``, where the
    gathered whole feeds work each rank does only in part (the MoE's
    dispatch to the rank's experts, the in-batch softmax against every
    rank's items), it sums the ranks' cotangents into each block (a
    reduce_scatter)."""
    if _recorded(x) and _live(axes):
        return _AllGather.apply(x, axes, partial)
    return _collective("all_gather", x, axes, _gather_op)


def reduce_scatter(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum over ``axes`` of ``x``, of which each rank keeps its block of
    dim 0 (``lax.psum_scatter(..., tiled=True)``); dim 0 must divide. Its
    backward all-gathers the blocks' cotangents."""
    if _recorded(x) and _live(axes):
        return _ReduceScatter.apply(x, axes)
    return _collective("reduce_scatter", x, axes, _scatter_op)


def all_reduce(x: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
    """The sum (``lax.psum``) or, with ``op="max"``, the elementwise
    maximum (``lax.pmax``) over ``axes`` of ``x``; ``x`` itself may be
    overwritten with it where autograd does not record the call. The
    sum's backward is the identity (its output is replicated); the max
    takes no gradient and refuses a tensor autograd records."""
    if op == "max":
        if _recorded(x) and _live(axes):
            raise ValueError("all_reduce(max) has no gradient: reduce a "
                             "detached tensor")
        return _collective("all_reduce", x, axes, _reduce_op("MAX"))
    if op != "sum":
        raise ValueError(f"all_reduce op {op!r}")
    if _recorded(x) and _live(axes):
        return _AllReduce.apply(x, axes)
    return _collective("all_reduce", x, axes, _reduce_op("SUM"))


def all_to_all(x: torch.Tensor, axes) -> torch.Tensor:
    """Dim 0 of ``x`` split into one equal chunk per rank over ``axes``,
    chunk j sent to rank j, the chunks received concatenated in rank
    order (``lax.all_to_all(..., 0, 0, tiled=True)``). Its backward is
    the same exchange of the cotangents."""
    if _recorded(x) and _live(axes):
        return _AllToAll.apply(x, axes)
    return _collective("all_to_all", x, axes, _to_all_op)


def enter(x: torch.Tensor, axes) -> torch.Tensor:
    """``x`` itself, where a value replicated over ``axes`` enters work
    split over them (column-parallel weights, a rank's experts, a rank's
    edges); its backward sums the ranks' partial cotangents over
    ``axes`` (one all_reduce). No mesh, or ``axes`` of one rank: ``x``."""
    if _recorded(x) and _live(axes):
        return _Enter.apply(x, axes)
    return x


def gather_rows(x: torch.Tensor, axes, n: Optional[int] = None):
    """The whole of a tensor split over ``axes`` by :func:`block`: the
    ranks' blocks gathered, cut to ``n`` rows when given."""
    full = all_gather(x, axes) if current_mesh() is not None else x
    return full if n is None else full[:n]
