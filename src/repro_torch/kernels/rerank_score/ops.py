"""Wrapper of the fused re-rank scorer (``csrc/rerank_score.cu``).

Callers hand the history already compacted/bucketed (serve/bucketing.py):
masked rows are exact no-ops, so scoring ``bucket(T_valid)`` rows equals
scoring the full padded history — but skips its cost. Neither T nor C is
padded here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (is_dry, launch, on_cpu, recorded,
                                 refuse_grad, require)
from repro_torch.kernels.rerank_score.ref import rerank_score_ref

#: candidates per block (``kCands`` in the source), and the widths of the
#: attention tower's register tiles (``kMaxH1``, ``kMaxH2``)
CANDS, MAX_H1, MAX_H2 = 4, 80, 40
_MAX_GRID_Y = 65535
#: what :func:`cost` takes on ``meta``, where it cannot read the mask
BOUND = "the mask's non-zeros taken as T (every history step active)"


def _weights(attn_mlp, score_mlp) -> list:
    return [p[k] for p in (*attn_mlp, *score_mlp) for k in ("w", "b")]


def rerank_score_plain(hist, mask, target, user_other, item_other,
                       attn_mlp, score_mlp):
    """:func:`rerank_score_ref` on :func:`rerank_score`'s arguments."""
    return rerank_score_ref(hist, mask, target, user_other, item_other,
                            *_weights(attn_mlp, score_mlp))


@recorded("rerank_score", rerank_score_plain)
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
    take the plain version; CUDA tensors launch the kernel, which has no
    backward: it raises where autograd would record the call."""
    require(len(attn_mlp) == 3 and len(score_mlp) == 3,
            "fused path expects 2-hidden-layer towers (got "
            f"{len(attn_mlp)}/{len(score_mlp)} layers)")
    weights = _weights(attn_mlp, score_mlp)
    args = (hist, mask, target, user_other, item_other, *weights)
    if on_cpu(*args):
        return rerank_score_ref(*args)
    refuse_grad("rerank_score", *args)
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
    require(H1 <= MAX_H1 and H2 <= MAX_H2,
            f"attention widths {H1}-{H2} exceed the kernel's tiles "
            f"({MAX_H1}-{MAX_H2})")
    require(-(-C // CANDS) <= _MAX_GRID_Y, f"C={C} exceeds the grid's y extent")
    out = torch.empty((C,), dtype=torch.float32, device=hist.device)
    if C == 0:
        return out
    launch("rerank_score_f32", "rerank_score", hist.device,
           *(t.data_ptr() for t in args), out.data_ptr(),
           T, D, C, d_u, d_i, H1, H2, M1, M2, cost=lambda: cost(*args),
           bound=BOUND)
    return out


def cost(hist, mask, target, user_other, item_other, *weights
         ) -> tuple[int, int]:
    """(flops, bytes) of one call with the towers' weights flat
    (w1, b1, ..., w6, b6), the work its roofline bound counts: the
    history's half of the first attention layer once, the target's half
    per candidate, the rest of the unit and the pooling for each
    candidate × unmasked step (the mask's non-zeros, read on the host;
    on ``meta`` :data:`BOUND`), the score MLP per candidate; bytes: each
    input read once, the (C,) scores written once."""
    T, D = hist.shape
    C, d_u, d_i = target.shape[0], user_other.shape[0], item_other.shape[1]
    H1, H2 = weights[0].shape[1], weights[2].shape[1]
    M1, M2 = weights[6].shape[1], weights[8].shape[1]
    K1 = 2 * D + d_u + d_i
    active = T if is_dry(mask) else int((mask != 0).sum())
    flops = (2 * T * D * H1 + C * 2 * D * H1
             + C * active * (2 * D * H1 + D + 2 * H1 * H2 + 2 * H2 + 2 * D)
             + C * 2 * (K1 * M1 + M1 * M2 + M2))
    nbytes = sum(t.numel() * t.element_size()
                 for t in (hist, mask, target, user_other, item_other, *weights))
    return flops, nbytes + C * 4
