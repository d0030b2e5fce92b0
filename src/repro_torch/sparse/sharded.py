"""Row-sharded embedding tables — single-device paths.

The reference shards each table's rows over a device mesh and reassembles
lookups with collectives (shard_map + psum / all_to_all / psum_scatter).
On one device every such lookup is a clipped gather or a padded embedding
bag, and the head's row update an in-place ``index_copy_``, which is what
this module computes. The collective paths are not
ported yet: passing a ``mesh`` raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.embedding_bag import embedding_bag_group
from repro_torch.sparse.embedding import embedding_bag_padded, lookup


def _single_device(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "sharded lookups over a device mesh are not ported yet "
            "(ROADMAP A8); only the single-device path exists")


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor,
                   mesh=None) -> torch.Tensor:
    """ids (...,) int → (..., D), ids clipped into range."""
    _single_device(mesh)
    return lookup(table, ids)


def sharded_gather_a2a(table: torch.Tensor, ids: torch.Tensor,
                       mesh=None) -> torch.Tensor:
    """Single-id lookup (N,) → (N, D); on one device a clipped gather."""
    _single_device(mesh)
    return lookup(table, ids)


def sharded_row_update(table: torch.Tensor, ids, rows,
                       mesh=None) -> torch.Tensor:
    """In-place row updates of the HBM head: write ``rows`` into ``table``
    at ``ids`` (``index_copy_``), so promotions, demotions and delta
    updates touch the rows of the live table without a rebuild or a second
    table's worth of device memory. Returns ``table`` itself.

    ``ids`` go to int64 and ``rows`` to the table's dtype, both onto its
    device (host arrays are checked on the host, so a launch needs no
    sync). As in the reference's ``mode="drop"`` scatter, a negative id
    counts from the end and an id outside ``[-len(table), len(table))`` is
    dropped. Duplicate ids within one call are
    the caller's to resolve (the head dedups, last wins, before calling)."""
    _single_device(mesh)
    ids = torch.as_tensor(ids, dtype=torch.int64).reshape(-1)
    if ids.numel() == 0:
        return table
    rows = torch.as_tensor(rows).reshape(ids.numel(), *table.shape[1:])
    n = table.shape[0]
    keep = (ids >= -n) & (ids < n)
    if not bool(keep.all()):
        ids, rows = ids[keep], rows[keep.to(rows.device)]
    ids = torch.where(ids < 0, ids + n, ids)
    return table.index_copy_(0, ids.to(table.device),
                             rows.to(table.device, table.dtype))


def sharded_embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                          weights: Optional[torch.Tensor] = None,
                          combiner: str = "sum", mesh=None) -> torch.Tensor:
    """Padded multi-hot bag: ids (B, K) → (B, D)."""
    _single_device(mesh)
    return embedding_bag_padded(table, ids, weights, combiner)


def sharded_embedding_bag_2d(table: torch.Tensor, ids: torch.Tensor,
                             weights: Optional[torch.Tensor] = None,
                             combiner: str = "sum",
                             mesh=None) -> torch.Tensor:
    """ids (B, K) or (B,) → (B, D)."""
    _single_device(mesh)
    if ids.dim() == 1:
        ids = ids[:, None]
        weights = None if weights is None else weights[:, None]
    return embedding_bag_padded(table, ids, weights, combiner)


def sharded_embedding_bag_group(lookups, blocks=None, mesh=None) -> list:
    """Several padded bags in one call: ``lookups`` is a sequence of
    (table, ids (B, K) or (B,), weights or None, combiner); ``blocks``
    splits them into runs that share B, each returned as one (B, n * D)
    tensor (``embedding_bag_group``)."""
    _single_device(mesh)
    groups = []
    for table, ids, weights, combiner in lookups:
        if ids.dim() == 1:
            ids = ids[:, None]
            weights = None if weights is None else weights[:, None]
        groups.append((table, ids, weights, combiner))
    return embedding_bag_group(groups, blocks)
