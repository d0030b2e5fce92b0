"""DIN [arXiv:1706.06978] in plain PyTorch, float32: the local activation
unit over [h, t, h - t, h * t] (80-40-1), the activation-weighted sum of
the history without softmax (paper section 4.3), then the score MLP
(200-80-1) over [pooled, target, user fields, item fields but item_id].
The broadcast form: the unit runs on the whole feature row of every
(pair, history step)."""
from __future__ import annotations

import torch

from portbench.reference.common import (blocks, draw_mlp, draw_tables,
                                        history, mlp, side_features, take)


def draw(gen: torch.Generator, cfg: dict) -> dict:
    """{"tables", "attn_mlp", "mlp"}, as the program's ``din.init``
    lays them out."""
    D, bias = cfg["embed_dim"], cfg["init"]["bias_std"]
    n_side = len(cfg["user_fields"]) + len(cfg["item_fields"]) - 1
    return {"tables": draw_tables(gen, cfg),
            "attn_mlp": draw_mlp(gen, 4 * D, cfg["attn_mlp"] + [1], bias),
            "mlp": draw_mlp(gen, 2 * D + n_side * D, cfg["mlp"] + [1], bias)}


def attention_pool(w: dict, hist, mask, target) -> torch.Tensor:
    """hist (B, T, D), mask (B, T), target (B, D) → (B, D)."""
    t = target[:, None].expand_as(hist)
    feat = torch.cat([hist, t, hist - t, hist * t], -1)
    a = mlp(w["attn_mlp"], feat)[..., 0] * mask
    return torch.einsum("bt,btd->bd", a, hist)


def logits(w: dict, batch: dict, cfg: dict) -> torch.Tensor:
    tables = w["tables"]
    hist, mask = history(tables, batch["user"]["hist"])
    target = tables["item_id"][batch["item"]["item_id"]]
    pooled = attention_pool(w, hist, mask, target)
    side = side_features(tables, cfg, batch["user"]["fields"], batch["item"])
    return mlp(w["mlp"], torch.cat([pooled, target, side], -1))[:, 0]


@torch.no_grad()
def scores(w: dict, batch: dict, cfg: dict, block: int = 4096) -> torch.Tensor:
    """The pairs' click probabilities (B,), in blocks of rows."""
    B = batch["item"]["item_id"].shape[0]
    out = torch.empty(B, dtype=torch.float32, device=w["mlp"][0]["w"].device)
    for lo, hi in blocks(B, block):
        out[lo:hi] = torch.sigmoid(logits(w, take(batch, lo, hi), cfg))
    return out

