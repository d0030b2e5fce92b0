"""Wrapper of the embedding_bag kernel (``csrc/embedding_bag.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import launch, on_cpu, require
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

_ENTRY = {torch.float32: "embedding_bag_f32",
          torch.bfloat16: "embedding_bag_bf16"}


def embedding_bag(table, ids, weights=None, combiner: str = "sum"):
    """Drop-in EmbeddingBag over padded bags: table (V, D) float32 or
    bfloat16, ids (B, K) integer (clipped to [0, V-1]), weights (B, K) or
    None (= ones). ``combiner="mean"`` divides by max(sum w, 1e-9).
    Returns (B, D) in the table's dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    require(combiner in ("sum", "mean"), f"unknown combiner {combiner!r}")
    if on_cpu(table, ids, weights):
        return embedding_bag_ref(table, ids, weights, combiner)
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
    (V, D), (B, K) = table.shape, ids.shape
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    require(V > 0, "empty table")
    launch(_ENTRY[table.dtype], "embedding_bag", table.device,
           table.data_ptr(), ids.data_ptr(),
           None if weights is None else weights.data_ptr(), out.data_ptr(),
           V, D, B, K, int(combiner == "mean"))
    return out
