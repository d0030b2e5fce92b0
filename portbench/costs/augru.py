"""B4, DIEN's AUGRU over the GRU's states for B pairs: per valid step
the input projection x W + b and h U (2 H 3H flops each, 3H the bias),
the gates (r and z: a sum each; n: a product and a sum; the attention's
product on z; the update (1 - z) h + z n: 4) a hidden unit."""
from __future__ import annotations

from portbench.costs.common import F32, valid, weight_bytes


def per_step(H: int) -> int:
    return 2 * H * 3 * H + 3 * H + 2 * H * 3 * H + 9 * H


def pairs(cfg: dict, batch: dict, weights: dict) -> tuple[int, int]:
    H = cfg["gru_dim"]
    hist = batch["user"]["hist"]
    B, n = hist.shape[0], valid(hist)
    nbytes = (n * (H + 1) * F32 + weight_bytes(weights["augru"])
              + B * H * F32)
    return n * per_step(H), nbytes
