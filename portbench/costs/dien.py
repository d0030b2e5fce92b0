"""DIEN's whole model step on B pairs: B3; the GRU over the valid steps
(x W + b, h U, the gates: 8 a hidden unit); the attention (W_a e_t once a
pair, then a dot product, the softmax's sum and division and the mask a
valid step); B4; the score MLP."""
from __future__ import annotations

from portbench.costs import augru, embedding_bag
from portbench.costs.common import F32, mlp_flops, side_dim, valid


def gru_step(D: int, H: int) -> int:
    return 2 * D * 3 * H + 3 * H + 2 * H * 3 * H + 8 * H


def pairs(cfg: dict, batch: dict, weights: dict) -> tuple[int, int]:
    D, H = cfg["embed_dim"], cfg["gru_dim"]
    hist = batch["user"]["hist"]
    B, n = hist.shape[0], valid(hist)
    f3, b3 = embedding_bag.pairs(cfg, batch, weights)
    f4, b4 = augru.pairs(cfg, batch, weights)
    f_gru = n * gru_step(D, H)
    f_att = B * 2 * H * D + n * (2 * H + 3)
    f_mlp = B * mlp_flops(H + D + side_dim(cfg), cfg["mlp"] + [1])
    return f3 + f_gru + f_att + f4 + f_mlp, b3 + b4 + B * F32
