"""DIEN [arXiv:1809.03672] in plain PyTorch, float32: a GRU over the
embedded history (interest extraction), softmax attention of each state
against the target over the valid steps, an AUGRU (the update gate scaled
by the attention) whose final state is the evolved interest, then the
score MLP (200-80-1) over [interest, target, user fields, item fields but
item_id]. Gate order [r | z | n] in every (d, 3H) weight."""
from __future__ import annotations

import math

import torch

from portbench.reference.common import (blocks, draw_dense, draw_mlp,
                                        draw_tables, history, mlp,
                                        side_features, take)


def draw(gen: torch.Generator, cfg: dict) -> dict:
    """{"tables", "gru", "augru", "att_w", "mlp", "aux_w"}, as the
    program's ``dien.init`` lays them out (``aux_w`` serves only the
    training loss)."""
    D, H, bias = cfg["embed_dim"], cfg["gru_dim"], cfg["init"]["bias_std"]
    n_side = len(cfg["user_fields"]) + len(cfg["item_fields"]) - 1

    def gru(d_in):
        g = draw_dense(gen, d_in, 3 * H, bias)
        u = torch.randn((H, 3 * H), generator=gen, device=gen.device,
                        dtype=torch.float32).div_(math.sqrt(H))
        return {"w": g["w"], "u": u, "b": g["b"]}

    def proj():
        return torch.randn((H, D), generator=gen, device=gen.device,
                           dtype=torch.float32).div_(math.sqrt(H))

    tables = draw_tables(gen, cfg)
    return {"tables": tables, "gru": gru(D), "augru": gru(H), "att_w": proj(),
            "mlp": draw_mlp(gen, H + D + n_side * D, cfg["mlp"] + [1], bias),
            "aux_w": proj()}


def gru_step(p: dict, x, h, att=None):
    """One step from input x (B, d) and state h (B, H). The GRU keeps
    z of the old state, h' = (1 - z) n + z h (torch's convention; the
    paper's u is 1 - z); with ``att`` (B,) the AUGRU step of the paper,
    u' = att u, h' = (1 - u') h + u' n."""
    H = h.shape[-1]
    gx = x @ p["w"] + p["b"]
    gh = h @ p["u"]
    r = torch.sigmoid(gx[:, :H] + gh[:, :H])
    z = torch.sigmoid(gx[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gx[:, 2 * H:] + r * gh[:, 2 * H:])
    if att is None:
        return (1 - z) * n + z * h
    z = z * att[:, None]
    return (1 - z) * h + z * n


def interest(w: dict, hist, mask, target) -> torch.Tensor:
    """hist (B, T, D), mask (B, T), target (B, D) → the final AUGRU state
    (B, H)."""
    B, T, _ = hist.shape
    H = w["gru"]["u"].shape[0]
    h = hist.new_zeros((B, H))
    states = []
    for t in range(T):
        h = gru_step(w["gru"], hist[:, t], h)
        states.append(h)
    states = torch.stack(states, 1)                           # (B, T, H)
    e = torch.einsum("bth,hd,bd->bt", states, w["att_w"], target)
    att = torch.softmax(e.masked_fill(mask == 0, float("-inf")), -1) * mask
    h = hist.new_zeros((B, H))
    for t in range(T):
        h = gru_step(w["augru"], states[:, t], h, att[:, t])
    return h


def logits(w: dict, batch: dict, cfg: dict) -> torch.Tensor:
    tables = w["tables"]
    hist, mask = history(tables, batch["user"]["hist"])
    target = tables["item_id"][batch["item"]["item_id"]]
    final = interest(w, hist, mask, target)
    side = side_features(tables, cfg, batch["user"]["fields"], batch["item"])
    return mlp(w["mlp"], torch.cat([final, target, side], -1))[:, 0]


@torch.no_grad()
def scores(w: dict, batch: dict, cfg: dict, block: int = 16384) -> torch.Tensor:
    """The pairs' click probabilities (B,), in blocks of rows."""
    B = batch["item"]["item_id"].shape[0]
    out = torch.empty(B, dtype=torch.float32, device=w["mlp"][0]["w"].device)
    for lo, hi in blocks(B, block):
        out[lo:hi] = torch.sigmoid(logits(w, take(batch, lo, hi), cfg))
    return out
