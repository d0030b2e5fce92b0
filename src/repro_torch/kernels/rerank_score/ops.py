"""Wrapper of the fused re-rank scorer (``csrc/rerank_score.cu``).

Callers hand the history already compacted/bucketed (serve/bucketing.py):
masked rows are exact no-ops, so scoring ``bucket(T_valid)`` rows equals
scoring the full padded history — but skips its cost. Neither T nor C is
padded here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import launch, on_cpu, require
from repro_torch.kernels.rerank_score.ref import rerank_score_ref

#: candidates and history steps per attention block (``kCands`` and
#: ``kChunk`` in the source); they size the scratch
CANDS, CHUNK = 2, 32
_MAX_GRID_Y = 65535


def rerank_score(hist, mask, target, user_other, item_other,
                 attn_mlp, score_mlp):
    """Score C candidates against one user's shared history, fused: the
    attention unit and the score MLP run on chip, with no (C, T, ·)
    intermediate in device memory.

    hist (T, D) embedded history, mask (T,), target (C, D) candidate
    embeddings, user_other (d_u,) user side features (NOT pre-broadcast),
    item_other (C, d_i) per-candidate side features; attn_mlp / score_mlp:
    3-layer towers as produced by ``mlp_tower_init`` (two silu hiddens +
    linear out). Returns per-candidate scores (C,) float32. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    require(len(attn_mlp) == 3 and len(score_mlp) == 3,
            "fused path expects 2-hidden-layer towers (got "
            f"{len(attn_mlp)}/{len(score_mlp)} layers)")
    weights = [p[k] for p in (*attn_mlp, *score_mlp) for k in ("w", "b")]
    args = (hist, mask, target, user_other, item_other, *weights)
    if on_cpu(*args):
        return rerank_score_ref(*args)
    T, D = hist.shape
    C, d_u, d_i = target.shape[0], user_other.shape[0], item_other.shape[1]
    H1, H2 = weights[0].shape[1], weights[2].shape[1]
    M1, M2 = weights[6].shape[1], weights[8].shape[1]
    shapes = [(T, D), (T,), (C, D), (d_u,), (C, d_i),
              (4 * D, H1), (H1,), (H1, H2), (H2,), (H2, 1), (1,),
              (2 * D + d_u + d_i, M1), (M1,), (M1, M2), (M2,), (M2, 1), (1,)]
    for i, (t, shape) in enumerate(zip(args, shapes)):
        require(tuple(t.shape) == shape,
                f"argument {i}: shape {tuple(t.shape)}, expected {shape}")
        require(t.dtype == torch.float32, f"argument {i} must be float32")
        require(t.is_contiguous(), f"argument {i} must be contiguous")
    require(-(-C // CANDS) <= _MAX_GRID_Y, f"C={C} exceeds the grid's y extent")
    out = torch.empty((C,), dtype=torch.float32, device=hist.device)
    if C == 0:
        return out
    # per (candidate, chunk) pooled partials, summed in chunk order
    partial = torch.empty((C, -(-T // CHUNK), D), dtype=torch.float32,
                          device=hist.device)
    launch("rerank_score_f32", "rerank_score", hist.device,
           *(t.data_ptr() for t in args), partial.data_ptr(), out.data_ptr(),
           T, D, C, d_u, d_i, H1, H2, M1, M2)
    return out
