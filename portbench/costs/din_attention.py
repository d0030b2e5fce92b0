"""B2, DIN's local activation unit and pooling for B pairs, each with its
own history. The first layer over [h, t, h - t, h * t] decomposes as
h (W_a + W_c) + t (W_b - W_c) + (h * t) W_d: the target's half once a
pair, the rest per valid step, then 80 → 40 → 1 and the weighted sum."""
from __future__ import annotations

from portbench.costs.common import F32, valid, weight_bytes


def per_step(D: int, H1: int, H2: int) -> int:
    """A valid step's flops: h (W_a + W_c) and (h * t) W_d (2 D H1 each),
    h * t (D), the hidden layers with their biases, the weight times h
    and its sum (2 D)."""
    return 4 * D * H1 + D + H1 + 2 * H1 * H2 + H2 + 2 * H2 + 1 + 2 * D


def pairs(cfg: dict, batch: dict, weights: dict) -> tuple[int, int]:
    D = cfg["embed_dim"]
    H1, H2 = cfg["attn_mlp"]
    hist = batch["user"]["hist"]
    B, n = hist.shape[0], valid(hist)
    flops = B * 2 * D * H1 + n * per_step(D, H1, H2)
    nbytes = (n * (D + 1) * F32 + B * D * F32
              + weight_bytes(weights["attn_mlp"]) + B * D * F32)
    return flops, nbytes
