"""DIN's whole model step on B pairs: B3, then B2 and the score MLP."""
from __future__ import annotations

from portbench.costs import din_attention, embedding_bag
from portbench.costs.common import F32, mlp_flops, side_dim


def pairs(cfg: dict, batch: dict, weights: dict) -> tuple[int, int]:
    D = cfg["embed_dim"]
    B = batch["item"]["item_id"].shape[0]
    f3, b3 = embedding_bag.pairs(cfg, batch, weights)
    f2, b2 = din_attention.pairs(cfg, batch, weights)
    f_mlp = B * mlp_flops(2 * D + side_dim(cfg), cfg["mlp"] + [1])
    return f3 + f2 + f_mlp, b3 + b2 + B * F32
