"""Wrappers of the embedding_bag kernels (``csrc/embedding_bag.cu``): one
launch per table (:func:`embedding_bag`), or one launch for all of a model
call's tables (:func:`embedding_bag_group`)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (is_dry, launch, on_cpu, recorded, require,
                                 with_plain_gradient)
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_group_ref,
                                                   embedding_bag_ref)

_ENTRY = {torch.float32: "embedding_bag_f32",
          torch.bfloat16: "embedding_bag_bf16"}
_GROUP_ENTRY = {torch.float32: "embedding_bag_group_f32",
                torch.bfloat16: "embedding_bag_group_bf16"}
#: groups one grouped launch takes at most (``kMaxGroups`` in the source)
MAX_GROUPS = 8
#: what :func:`cost` takes on ``meta``, where it cannot read the ids
BOUND = ("the ids' distinct rows taken as one a looked-up id, at most the "
         "table's rows")


@recorded("embedding_bag", embedding_bag_ref)
def embedding_bag(table, ids, weights=None, combiner: str = "sum"):
    """Drop-in EmbeddingBag over padded bags: table (V, D) float32 or
    bfloat16, ids (B, K) integer (clipped to [0, V-1]), weights (B, K) or
    None (= ones). ``combiner="mean"`` divides by max(sum w, 1e-9).
    Returns (B, D) in the table's dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel, whose gradient is the plain
    version's: a scatter-add of each bag's output gradient x its weight
    (/ sum w for ``mean``) into a dense table gradient at the clipped ids."""
    require(combiner in ("sum", "mean"), f"unknown combiner {combiner!r}")
    if on_cpu(table, ids, weights):
        return embedding_bag_ref(table, ids, weights, combiner)
    return with_plain_gradient(
        lambda t, i, w: _launch(t, i, w, combiner),
        lambda t, i, w: embedding_bag_ref(t, i, w, combiner),
        table, ids, weights)


def _launch(table, ids, weights, combiner):
    table, ids, weights = _checked(table, ids, weights)
    (V, D), (B, K) = table.shape, ids.shape
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    require(V > 0, "empty table")
    launch(_ENTRY[table.dtype], "embedding_bag", table.device,
           table.data_ptr(), ids.data_ptr(),
           None if weights is None else weights.data_ptr(), out.data_ptr(),
           V, D, B, K, int(combiner == "mean"),
           cost=lambda: cost([(table, ids, weights)]), bound=BOUND)
    return out


def cost(lookups) -> tuple[int, int]:
    """(flops, bytes) of one launch over ``lookups``, (table, ids,
    weights, ...) per group, the work its roofline bound counts: a
    multiply-add per looked-up element; bytes: the ids and weights read
    once, each distinct row once (the ids' unique count, read on the
    host; on ``meta`` :data:`BOUND`), each bag's output row written
    once."""
    flops = nbytes = 0
    for table, ids, weights, *_ in lookups:
        B, D = ids.shape[0], table.shape[1]
        row = D * table.element_size()
        rows = (min(ids.numel(), table.shape[0]) if is_dry(ids)
                else int(torch.unique(ids).numel()))
        nbytes += (ids.numel() * ids.element_size()
                   + (0 if weights is None
                      else weights.numel() * weights.element_size())
                   + rows * row + B * row)
        flops += 2 * ids.numel() * D
    return flops, nbytes


def _checked(table, ids, weights):
    """The kernel's operands: shapes and types checked, ids as int64 and
    weights as float32, every one contiguous."""
    require(table.dim() == 2 and ids.dim() == 2,
            f"table (V, D) and ids (B, K) expected, got "
            f"{tuple(table.shape)} and {tuple(ids.shape)}")
    require(table.dtype in _ENTRY, f"table dtype {table.dtype} unsupported")
    require(not ids.is_floating_point(), f"ids dtype {ids.dtype} unsupported")
    ids = ids.long()
    if weights is not None:
        require(weights.shape == ids.shape,
                f"weights {tuple(weights.shape)} vs ids {tuple(ids.shape)}")
        weights = weights.float()
    for name, t in (("table", table), ("ids", ids), ("weights", weights)):
        require(t is None or t.is_contiguous(), f"{name} must be contiguous")
    return table, ids, weights


class _Group(ctypes.Structure):
    """One group's descriptor (``BagGroup`` in the source)."""
    _fields_ = [("table", ctypes.c_void_p), ("ids", ctypes.c_void_p),
                ("weights", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("V", ctypes.c_longlong), ("K", ctypes.c_int),
                ("mean", ctypes.c_int), ("out_stride", ctypes.c_int),
                ("out_col", ctypes.c_int), ("bag0", ctypes.c_int)]


class _Groups(ctypes.Structure):
    """Every group of a launch (``BagGroups`` in the source), handed to the
    kernel by value as one parameter; ``lanes`` is set by the C entry."""
    _fields_ = [("g", _Group * MAX_GROUPS), ("n", ctypes.c_int),
                ("D", ctypes.c_int), ("total", ctypes.c_int),
                ("lanes", ctypes.c_int)]


@recorded("embedding_bag", embedding_bag_group_ref)
def embedding_bag_group(lookups, blocks=None):
    """Several embedding bags in one launch. ``lookups`` is a sequence of
    (table (V_g, D), ids (B_g, K_g), weights (B_g, K_g) or None, combiner)
    groups, each computed as :func:`embedding_bag` computes it; every table
    has the same dtype (float32 or bfloat16) and the same D, and there are
    at most MAX_GROUPS groups.

    ``blocks`` splits the groups, in order, into runs that share their bag
    count: each run comes back as one (B, n * D) tensor, its groups side by
    side, as ``torch.cat(dim=-1)`` would give them. The default is one run
    per group: one (B_g, D) tensor each. The returned tensors are views of
    one buffer. CPU tensors take the plain version; CUDA tensors launch
    one kernel, counted once, with every descriptor passed by value (no
    copy to the device, no host sync: a CUDA graph can hold the launch).
    On the card the buffer is the one output autograd sees (views of two
    outputs of one storage would break its version checks), and its
    gradient is the plain version's, group by group."""
    lookups = [tuple(g) for g in lookups]
    blocks = (1,) * len(lookups) if blocks is None else tuple(blocks)
    require(0 < len(lookups) <= MAX_GROUPS,
            f"{len(lookups)} groups; a launch takes 1 to {MAX_GROUPS}")
    require(all(n > 0 for n in blocks) and sum(blocks) == len(lookups),
            f"blocks {blocks} do not split {len(lookups)} groups")
    dtype, D = lookups[0][0].dtype, lookups[0][0].shape[-1]
    for table, ids, _weights, combiner in lookups:
        require(combiner in ("sum", "mean"), f"unknown combiner {combiner!r}")
        require(table.dim() == 2 and ids.dim() == 2,
                f"table (V, D) and ids (B, K) expected, got "
                f"{tuple(table.shape)} and {tuple(ids.shape)}")
        require(table.dtype == dtype and table.shape[1] == D,
                f"every table must be {dtype} with D={D}, got {table.dtype} "
                f"(V, {table.shape[1]})")
    places, size, at = [], 0, 0      # the blocks' places in one buffer
    for n in blocks:
        B = lookups[at][1].shape[0]
        require(all(g[1].shape[0] == B for g in lookups[at:at + n]),
                "the groups of a block must share their bag count")
        places.append((size, B, n))
        size += B * n * D
        at += n
    flat = [t for g in lookups for t in g[:3]]
    if on_cpu(*flat):
        return embedding_bag_group_ref(lookups, blocks)
    combiners = [g[3] for g in lookups]

    def regroup(tensors):
        return [(*tensors[3 * i:3 * i + 3], c) for i, c in enumerate(combiners)]

    def plain(*tensors):
        return torch.cat([o.reshape(-1) for o in
                          embedding_bag_group_ref(regroup(tensors), blocks)])

    buf = with_plain_gradient(
        lambda *tensors: _launch_group(regroup(tensors), places, size),
        plain, *flat)
    return [buf[off:off + B * n * D].view(B, n * D) for off, B, n in places]


def _launch_group(lookups, places, size):
    """One launch of every group into one buffer of ``size`` elements,
    each block of groups at its place (offset, bags, groups)."""
    dtype, D = lookups[0][0].dtype, lookups[0][0].shape[-1]
    groups = [(*_checked(*g[:3]), g[3]) for g in lookups]
    require(all(g[0].shape[0] > 0 for g in groups), "empty table")
    device = groups[0][0].device
    buf = torch.empty((size,), dtype=dtype, device=device)
    desc, bag0, at = _Groups(), 0, 0
    for off, B, n in places:
        for j in range(n):
            table, ids, weights, combiner = groups[at]
            desc.g[at] = _Group(
                table.data_ptr(), ids.data_ptr(),
                None if weights is None else weights.data_ptr(),
                buf.data_ptr() + off * buf.element_size(), table.shape[0],
                ids.shape[1], int(combiner == "mean"), n * D, j * D, bag0)
            bag0 += B
            at += 1
    desc.n, desc.D, desc.total = len(groups), D, bag0
    if bag0 and D:
        launch(_GROUP_ENTRY[dtype], "embedding_bag", device,
               ctypes.addressof(desc), cost=lambda: cost(groups),
               bound=BOUND)
    return buf
