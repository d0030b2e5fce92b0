"""EmbeddingBag and friends, in PyTorch.

Three layouts are supported:

  * dense ids            — (..., ) int → (..., D)                (plain lookup)
  * padded multi-hot     — (B, K) ids + (B, K) weights/mask      (fixed-width bags)
  * ragged (segment)     — (N,) ids + (N,) segment_ids, B bags   (true EmbeddingBag)

The padded layout goes through the hand-written ``embedding_bag`` kernel
(repro_torch.kernels.embedding_bag); lookups clip ids into range, as the
reference's ``mode="clip"`` gathers do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.kernels.embedding_bag import embedding_bag


@dataclass(frozen=True)
class TableSpec:
    name: str
    vocab: int          # rows (hashed bucket count)
    dim: int
    combiner: str = "sum"   # sum | mean
    init_scale: float = 0.01

    @property
    def bytes_fp32(self) -> int:
        return self.vocab * self.dim * 4


def init_table(generator: torch.Generator, spec: TableSpec,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """(vocab, dim) table ~ N(0, init_scale²), drawn from ``generator``
    (which must live on ``device``)."""
    t = torch.randn((spec.vocab, spec.dim), generator=generator,
                    device=default_device(device), dtype=torch.float32)
    return t.mul_(spec.init_scale).to(dtype)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain dense lookup: (...,) int → (..., D), ids clipped into range."""
    flat = ids.reshape(-1).long().clamp(0, table.shape[0] - 1)
    return table.index_select(0, flat).reshape(*ids.shape, table.shape[1])


def embedding_bag_padded(table: torch.Tensor, ids: torch.Tensor,
                         weights: Optional[torch.Tensor] = None,
                         combiner: str = "sum") -> torch.Tensor:
    """Fixed-width bags: ids (B, K) → (B, D). weights (B, K) doubles as the
    validity mask (0 for padding)."""
    return embedding_bag(table, ids, weights, combiner)


def embedding_bag_ragged(table: torch.Tensor, ids: torch.Tensor,
                         segment_ids: torch.Tensor, num_bags: int,
                         weights: Optional[torch.Tensor] = None,
                         combiner: str = "sum") -> torch.Tensor:
    """True EmbeddingBag: flat ids (N,) with segment_ids (N,) → (num_bags, D)."""
    vecs = lookup(table, ids)                      # (N, D)
    if weights is not None:
        vecs = vecs * weights[:, None].to(vecs.dtype)
    seg = segment_ids.long()
    out = torch.zeros((num_bags, table.shape[1]), dtype=vecs.dtype,
                      device=vecs.device).index_add_(0, seg, vecs)
    if combiner == "mean":
        ones = (weights.to(vecs.dtype) if weights is not None else
                torch.ones(ids.shape[0], dtype=vecs.dtype, device=vecs.device))
        cnt = torch.zeros(num_bags, dtype=vecs.dtype,
                          device=vecs.device).index_add_(0, seg, ones)
        out = out / cnt.clamp_min(1e-9)[:, None]
    return out


def cube_embedding_bag_padded(cube, group: int, ids: np.ndarray,
                              weights: Optional[np.ndarray] = None,
                              combiner: str = "sum") -> np.ndarray:
    """Host-side EmbeddingBag over the ParameterCube tail (DESIGN.md §2):
    one batched, deduplicated cube lookup for the whole (B, K) id block —
    never a per-row probe — then the same combine as
    ``embedding_bag_padded``. Returns (B, D) numpy."""
    ids = np.asarray(ids)
    rows = cube.lookup(group, ids.reshape(-1))            # (B*K, D), one gather
    rows = rows.reshape(ids.shape + (rows.shape[-1],))    # (B, K, D)
    if weights is None:
        weights = np.ones(ids.shape, rows.dtype)
    w = np.asarray(weights, dtype=rows.dtype)
    out = np.einsum("bk,bkd->bd", w, rows)
    if combiner == "mean":
        denom = np.maximum(w.sum(-1, keepdims=True), 1e-9)
        out = out / denom.astype(out.dtype)
    return out


def offsets_to_segment_ids(offsets: np.ndarray, total: int) -> np.ndarray:
    """torch-EmbeddingBag style offsets (B,) → segment_ids (N,). Host-side."""
    seg = np.zeros(total, dtype=np.int32)
    np.add.at(seg, offsets[1:][offsets[1:] < total], 1)
    return np.cumsum(seg).astype(np.int32)
