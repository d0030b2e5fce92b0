"""Plain PyTorch pieces shared by the references: the weights' draw from
the seed, embedding bags and the score MLP. Imports nothing of the
program."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def draw_tables(gen: torch.Generator, cfg: dict) -> dict:
    """One (vocab, embed_dim) float32 table per field, N(0, table_std²),
    each in one draw on ``gen``'s device, user fields then item fields."""
    std = cfg["init"]["table_std"]
    return {f["name"]: torch.randn((f["vocab"], cfg["embed_dim"]),
                                   generator=gen, device=gen.device,
                                   dtype=torch.float32).mul_(std)
            for f in cfg["user_fields"] + cfg["item_fields"]}


def draw_dense(gen: torch.Generator, d_in: int, d_out: int,
               bias_std: float) -> dict:
    """{"w": (d_in, d_out) ~ N(0, 1/d_in), "b": (d_out,) ~ N(0, bias_std²)}."""
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32).div_(math.sqrt(d_in))
    b = torch.randn((d_out,), generator=gen, device=gen.device,
                    dtype=torch.float32).mul_(bias_std)
    return {"w": w, "b": b}


def draw_mlp(gen: torch.Generator, d_in: int, widths, bias_std: float) -> list:
    layers = []
    for w in widths:
        layers.append(draw_dense(gen, d_in, w, bias_std))
        d_in = w
    return layers


def mlp(layers: list, x: torch.Tensor) -> torch.Tensor:
    """SiLU after every layer but the last."""
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"]
        if i < len(layers) - 1:
            x = F.silu(x)
    return x


def bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """ids (B,) → the rows (B, D); ids (B, K) → the sum of each bag's K
    rows."""
    if ids.dim() == 1:
        return table[ids]
    return table[ids].sum(1)


def side_features(tables: dict, cfg: dict, user: dict, item: dict):
    """[every user field, every item field but item_id], side by side, as
    the score MLP reads them after the pooled interest and the target."""
    cols = [bag(tables[f["name"]], user[f["name"]]) for f in cfg["user_fields"]]
    cols += [bag(tables[f["name"]], item[f["name"]])
             for f in cfg["item_fields"] if f["name"] != "item_id"]
    return torch.cat(cols, -1)


def history(tables: dict, hist_ids: torch.Tensor):
    """(B, T) item ids, -1 = padding → rows (B, T, D), zero at padding,
    and the (B, T) float mask."""
    mask = (hist_ids >= 0).to(torch.float32)
    rows = tables["item_id"][hist_ids.clamp_min(0)]
    return rows * mask[..., None], mask


def blocks(n: int, size: int):
    for lo in range(0, n, size):
        yield lo, min(lo + size, n)


def take(tree, lo: int, hi: int):
    """Rows [lo, hi) of every tensor in a nested dict."""
    if isinstance(tree, dict):
        return {k: take(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]
