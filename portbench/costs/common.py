"""Counting helpers shared by the layers' counts."""
from __future__ import annotations

import torch

F32 = 4


def valid(hist_ids: torch.Tensor) -> int:
    """The history steps that hold an item (ids >= 0)."""
    return int((hist_ids >= 0).sum())


def distinct(*ids: torch.Tensor) -> int:
    """Distinct ids over every tensor given (padding -1 left out)."""
    flat = torch.cat([i.reshape(-1) for i in ids])
    return int(torch.unique(flat[flat >= 0]).numel())


def weight_bytes(*layers) -> int:
    """Bytes of float32 weights given as tensors or lists of {w, b}."""
    n = 0
    for layer in layers:
        for p in layer if isinstance(layer, list) else [layer]:
            for t in (p.values() if isinstance(p, dict) else [p]):
                n += t.numel() * F32
    return n


def mlp_flops(d_in: int, widths) -> int:
    """One row through dense layers d_in → widths[0] → ...: 2 flops a
    multiply-add, 1 a bias."""
    n = 0
    for w in widths:
        n += 2 * d_in * w + w
        d_in = w
    return n


def side_dim(cfg: dict) -> int:
    """Width of [user fields, item fields but item_id]."""
    return cfg["embed_dim"] * (len(cfg["user_fields"])
                               + len(cfg["item_fields"]) - 1)
