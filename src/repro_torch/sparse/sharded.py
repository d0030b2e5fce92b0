"""Row-sharded embedding tables — the on-device distributed sparse
parameter cube, the counterpart of ``repro/sparse/sharded.py``.

With no mesh installed (``runtime.current_mesh()``) every lookup is a
clipped gather or a padded embedding bag, and the head's row update an
in-place ``index_copy_``. On a mesh each rank holds its rows of a table as
a ``runtime.RowShard`` (rows over ``model`` for :func:`sharded_lookup` /
:func:`sharded_row_update`, over the flat ("data", "model") shards for
the bags and :func:`sharded_gather_a2a`), pools or takes only the rows
it owns and reassembles the result with explicit collectives, as the
reference's shard_map bodies do; a table held whole (a plain tensor: its
rows did not split) is owned by the first shard. An id no shard owns
(outside the table) reads zeros on a mesh, as in the reference.

Batch layout on a mesh: a bag's ids are the rank's block of a batch split
over ``batch_axes`` (default ("data",): the reference's scatterable
batch) — a batch held whole by every rank is such a block too, only
gathered redundantly — or, with ``batch_axes=()``, ids every rank holds
whole (the reference's batch that does not scatter: one all_reduce).
The result comes back in the ids' layout.

In training (autograd recording; ``runtime``'s rule for gradients) the
collectives' adjoints give the backward: a bag's pooled partials are
reduce-scattered (backward: an all_gather of the cotangents, so each
rank holds those of every gathered id) and all-reduced (backward: the
identity), and B3's gradient (the plain version's, ``kernels``'
``_PlainGradient``) lands on the rank's own rows only, in the table's
dtype; a table's local rows then hold its whole gradient (its ids were
gathered over every rank). ``comm_dtype`` casts keep the forward's
dtypes in the backward.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.kernels.embedding_bag import embedding_bag_group
from repro_torch.sparse.embedding import embedding_bag_padded, lookup

SHARD_AXIS = "model"
BIG_AXES = ("data", "model")


def _on_mesh(axes) -> bool:
    return runtime.current_mesh() is not None and runtime.axes_size(axes) > 1


def _whole(table):
    """A table a rank holds whole (a single-device path reads it)."""
    return table.local if isinstance(table, runtime.RowShard) else table


def _owned(table, ids: torch.Tensor):
    """(local ids, ownership as 0/1 float32) of ``ids`` against the rows
    this rank holds: a RowShard's block, or all of a whole table on the
    first ("data", "model") shard only. A non-owned id becomes local id 0
    with weight 0 (the reference's ``jnp.where(ok, local, 0)``)."""
    ids = ids.long()
    if isinstance(table, runtime.RowShard):
        rows = table.local.shape[0]
        local = ids - table.start
        ok = (local >= 0) & (local < rows)
        return torch.where(ok, local, 0), ok.to(torch.float32)
    own = float(runtime.shard_index(BIG_AXES) == 0)
    return ids, torch.full(ids.shape, own, dtype=torch.float32,
                           device=ids.device)


def sharded_lookup(table, ids: torch.Tensor) -> torch.Tensor:
    """ids (...,) int → (..., D), table rows sharded over ``model``: each
    rank takes the rows it owns (masked take), the results are summed over
    the axis. No >1 ``model`` axis, or a table held whole: a dense take,
    ids clipped into range."""
    if not _on_mesh(SHARD_AXIS) or not isinstance(table, runtime.RowShard):
        return lookup(_whole(table), ids)
    if tuple(table.axes) != (SHARD_AXIS,):
        raise ValueError(f"sharded_lookup takes rows over {SHARD_AXIS!r}, "
                         f"not {table.axes}")
    local, ok = _owned(table, ids)
    vecs = lookup(table.local, local) * ok[..., None].to(table.local.dtype)
    return runtime.all_reduce(vecs, SHARD_AXIS)


def sharded_row_update(table, ids, rows):
    """In-place row updates of the HBM head: write ``rows`` into ``table``
    at ``ids`` (``index_copy_``), so promotions, demotions and delta
    updates touch the rows of the live table without a rebuild or a second
    table's worth of device memory. Returns ``table`` itself.

    ``ids`` go to int64 and ``rows`` to the table's dtype, both onto its
    device (host arrays are checked on the host, so a launch needs no
    sync). As in the reference's ``mode="drop"`` scatter, a negative id
    counts from the end and an id outside ``[-len(table), len(table))`` is
    dropped. On a mesh (``table`` a RowShard over ``model``, ids and rows
    whole on every rank) each rank writes only the rows it owns: a
    non-owned id is dropped, never wrapped into this shard's tail (the
    reference's ownership mask; a negative id is owned by no shard).
    Duplicate ids within one call are the caller's to resolve (the head
    dedups, last wins, before calling)."""
    ids = torch.as_tensor(ids, dtype=torch.int64).reshape(-1)
    if ids.numel() == 0:
        return table
    target = _whole(table)
    rows = torch.as_tensor(rows).reshape(ids.numel(), *target.shape[1:])
    if isinstance(table, runtime.RowShard) and _on_mesh(SHARD_AXIS):
        n = target.shape[0]
        local = ids - table.start
        keep = (local >= 0) & (local < n)
    else:
        n = target.shape[0]
        keep = (ids >= -n) & (ids < n)
        local = torch.where(ids < 0, ids + n, ids)
    if not bool(keep.all()):
        local, rows = local[keep], rows[keep.to(rows.device)]
    target.index_copy_(0, local.to(target.device),
                       rows.to(target.device, target.dtype))
    return table


def sharded_embedding_bag(table, ids: torch.Tensor,
                          weights: Optional[torch.Tensor] = None,
                          combiner: str = "sum") -> torch.Tensor:
    """Padded multi-hot bag over a table row-sharded on ``model``: ids
    (B, K) → (B, D), through :func:`sharded_lookup`."""
    if not _on_mesh(SHARD_AXIS):
        return embedding_bag_padded(_whole(table), ids, weights, combiner)
    vecs = sharded_lookup(table, ids)                       # (B, K, D)
    w = (torch.ones(ids.shape, dtype=vecs.dtype, device=vecs.device)
         if weights is None else weights.to(vecs.dtype))
    out = torch.einsum("bk,bkd->bd", w, vecs)
    if combiner == "mean":
        out = out / w.sum(-1, keepdim=True).clamp_min(1e-9)
    return out


# --------------------------------------------------------------------------
# 2-D row sharding: rows over the flat ("data", "model") shards. The bag is
# POOLED LOCALLY before any collective (one grouped embedding_bag launch
# over every table of the call, the ownership mask as its weights), so the
# traffic is O(B x D) — a reduce_scatter + an all_reduce — never
# O(B x K x D) and never a table transfer.
# --------------------------------------------------------------------------

def _bags(lookups):
    """(table, ids (B, K), weights or None, combiner) with (B,) ids read as
    bags of one."""
    out = []
    for table, ids, weights, combiner in lookups:
        if ids.dim() == 1:
            ids = ids[:, None]
            weights = None if weights is None else weights[:, None]
        out.append((table, ids, weights, combiner))
    return out


def _gather_ids(groups, axes):
    """Every group's ids and weights gathered over ``axes`` with one
    all_gather (one more for the weights, if any group has them): group
    j's (n * B_j, K_j) ids, the ranks' blocks in flat-index order."""
    n = runtime.axes_size(axes)
    flat = torch.cat([ids.reshape(-1).long() for _, ids, _, _ in groups])
    got = runtime.all_gather(flat, axes).view(n, -1)
    has_w = any(w is not None for _, _, w, _ in groups)
    if has_w:
        wflat = torch.cat([(w if w is not None else torch.ones(ids.shape,
                            device=ids.device)).reshape(-1).float()
                           for _, ids, w, _ in groups])
        wgot = runtime.all_gather(wflat, axes).view(n, -1)
    out, at = [], 0
    for table, ids, w, combiner in groups:
        B, K = ids.shape
        size = B * K
        gi = got[:, at:at + size].reshape(n * B, K)
        gw = wgot[:, at:at + size].reshape(n * B, K) if has_w else None
        out.append((table, gi, gw if w is not None else None, combiner))
        at += size
    return out


def _pooled_on_mesh(lookups, blocks, batch_axes, comm_dtype=None) -> list:
    """The grouped bag on a mesh: ids gathered over ``batch_axes`` (one
    all_gather), one grouped embedding_bag launch pooling each table's
    local rows with the ownership mask as weights (``sum``), then one
    reduce_scatter over ``batch_axes`` and one all_reduce over the other
    ("data", "model") axes carrying every group's partial sums and the
    mean groups' weight counts; a mean divides by its all-reduced count
    after the collectives."""
    groups = _bags(lookups)
    split = runtime.mesh_axes(batch_axes)
    n = runtime.axes_size(split)
    rest = tuple(a for a in BIG_AXES if a not in split)
    gathered = _gather_ids(groups, split) if n > 1 else groups
    bags, counts = [], []
    for table, ids, w, combiner in gathered:
        local, ok = _owned(table, ids)
        wt = ok if w is None else ok * w.float()
        t = _whole(table)
        if not isinstance(table, runtime.RowShard):
            # held whole, pooled by the first shard only: its gradient
            # there is whole over the gathered ids, and enters the other
            # axes (``runtime``'s rule for a replicated leaf used in part)
            t = runtime.enter(t, rest)
        bags.append((t, local, wt, "sum"))
        counts.append(wt.sum(-1) if combiner == "mean" else None)
    parts = embedding_bag_group(bags)
    dtype, D = parts[0].dtype, parts[0].shape[-1]
    # rank-major: each destination's rows of every group side by side,
    # so one reduce_scatter hands each rank its block of all of them
    sums = [p.reshape(n, -1).to(comm_dtype or torch.float32) for p in parts]
    cnts = [c.reshape(n, -1) for c in counts if c is not None]
    bufs = [torch.cat(sums if comm_dtype else sums + cnts, 1)]
    if comm_dtype is not None and cnts:     # the counts stay float32
        bufs.append(torch.cat(cnts, 1))
    flat = [runtime.all_reduce(
        (runtime.reduce_scatter(buf, split) if n > 1 else buf).reshape(-1),
        rest) for buf in bufs]
    rows = [ids.shape[0] for _, ids, _, _ in groups]
    res = [p.view(b, D).to(dtype) for p, b in
           zip(torch.split(flat[0][:sum(rows) * D], [b * D for b in rows]),
               rows)]
    cnt = iter(torch.split(flat[-1] if len(flat) > 1
                           else flat[0][sum(rows) * D:],
                           [b for b, c in zip(rows, counts) if c is not None]))
    for j, c in enumerate(counts):
        if c is not None:                   # a mean: after the collectives
            res[j] = (res[j].float() / next(cnt).clamp_min(1e-9)[:, None]
                      ).to(dtype)
    blocks = (1,) * len(res) if blocks is None else tuple(blocks)
    out, at = [], 0
    for k in blocks:
        out.append(res[at] if k == 1 else torch.cat(res[at:at + k], -1))
        at += k
    return out


def sharded_embedding_bag_2d(table, ids: torch.Tensor,
                             weights: Optional[torch.Tensor] = None,
                             combiner: str = "sum", comm_dtype=None,
                             batch_axes=("data",)) -> torch.Tensor:
    """ids (B, K) or (B,) → (B, D); table rows sharded over ("data",
    "model") on a mesh (module docstring: ``batch_axes``). ``comm_dtype``
    (e.g. bf16) casts the pooled partials before the collectives; the
    weight counts of a mean stay float32."""
    if not _on_mesh(BIG_AXES):
        if ids.dim() == 1:
            ids = ids[:, None]
            weights = None if weights is None else weights[:, None]
        return embedding_bag_padded(_whole(table), ids, weights, combiner)
    return _pooled_on_mesh([(table, ids, weights, combiner)], None,
                           batch_axes, comm_dtype)[0]


def sharded_embedding_bag_group(lookups, blocks=None,
                                batch_axes=("data",)) -> list:
    """Several padded bags in one call: ``lookups`` is a sequence of
    (table, ids (B, K) or (B,), weights or None, combiner); ``blocks``
    splits them into runs that share B, each returned as one (B, n * D)
    tensor (``embedding_bag_group``). On a mesh (module docstring:
    ``batch_axes``, one layout for every group) still one grouped launch,
    with one all_gather, one reduce_scatter and one all_reduce for all
    of them."""
    if _on_mesh(BIG_AXES):
        return _pooled_on_mesh(lookups, blocks, batch_axes)
    return embedding_bag_group([(_whole(t), i, w, c)
                                for t, i, w, c in _bags(lookups)], blocks)


def sharded_gather_a2a(table, ids: torch.Tensor,
                       cap_factor: float = 4.0) -> torch.Tensor:
    """Single-id lookup (N,) → (N, D) over a table row-sharded on ("data",
    "model") via ALL-TO-ALL exchange. On a mesh ``ids`` are the rank's
    block of the (padded) ids split over ("data", "model")
    (``runtime.shard(ids, BIG_AXES)``), and so is the result:

      1. all-gather the ids over both axes;
      2. every rank packs the rows IT OWNS into per-destination buckets
         (destination = the id's position block), ``cap`` rows each;
      3. one all_to_all moves each row exactly once;
      4. receivers scatter the rows into their (N_loc, D) block.

    A row that overflows its bucket comes back as zeros, as the
    reference's does (``cap`` as the reference computes it). A table held
    whole: a local take."""
    if not _on_mesh(BIG_AXES) or not isinstance(table, runtime.RowShard):
        return lookup(_whole(table), ids)
    g = runtime.axes_size(BIG_AXES)
    t = table.local
    rows, D = t.shape
    n_loc = ids.shape[0]
    ig = runtime.all_gather(ids.long(), BIG_AXES)
    N = ig.shape[0]
    cap = max(8, int(np.ceil(cap_factor * N / (g * g) / 8)) * 8)
    local_ids = ig - table.start
    mine = (local_ids >= 0) & (local_ids < rows)
    pos_all = torch.arange(N, device=ig.device)
    dest = pos_all // n_loc
    # dest is monotone in position, so rank-in-bucket is a block-wise
    # exclusive cumsum — no sort needed
    mine_i = mine.long()
    excl = torch.cumsum(mine_i, 0) - mine_i
    pos = excl - excl[dest * n_loc]
    keep = mine & (pos < cap)
    slot = torch.where(keep, dest * cap + pos, g * cap)
    idx_buf = torch.zeros(g * cap + 1, dtype=torch.long, device=ig.device)
    idx_buf[slot] = local_ids.clamp(0, rows - 1)
    posn = torch.full((g * cap + 1,), -1, dtype=torch.long, device=ig.device)
    posn[slot] = torch.where(keep, pos_all % n_loc, -1)
    posn = posn[:g * cap]
    buckets = t.index_select(0, idx_buf[:g * cap]) \
        * (posn >= 0)[:, None].to(t.dtype)
    # one row moves exactly once
    recv = runtime.all_to_all(buckets, BIG_AXES)            # (g*cap, D)
    rpos = runtime.all_to_all(posn, BIG_AXES)
    out = torch.zeros((n_loc + 1, D), dtype=t.dtype, device=t.device)
    out.index_add_(0, torch.where(rpos >= 0, rpos, n_loc), recv)
    return out[:n_loc]
