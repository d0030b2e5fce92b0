"""Row-sharded embedding tables — single-device paths.

The reference shards each table's rows over a device mesh and reassembles
lookups with collectives (shard_map + psum / all_to_all / psum_scatter).
On one device every such lookup is a clipped gather or a padded embedding
bag, which is what this module computes. The collective paths are not
ported yet: passing a ``mesh`` raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

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
