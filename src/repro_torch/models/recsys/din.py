"""DIN [arXiv:1706.06978] — deep interest network (target attention).

The local activation unit scores each history item against the candidate via
an MLP over [h, t, h−t, h⊙t] (80→40→1, paper-exact), then weighted-sum pools
WITHOUT softmax normalization (paper §4.3). In the port the unit runs as
the hand-written ``din_attention`` kernel, the candidate re-rank as the
fused ``rerank_score`` kernel, and every table lookup as the
``embedding_bag`` kernel; tensors on the CPU take their plain versions.
"""
from __future__ import annotations

import torch

from repro_torch import default_device
from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels.din_attention import din_attention
from repro_torch.kernels.rerank_score import rerank_score
from repro_torch.models.layers import mlp_tower_apply, mlp_tower_init
from repro_torch.models.recsys.common import bce_loss, embed_fields, tables_init
from repro_torch.sparse.sharded import (sharded_embedding_bag_2d,
                                        sharded_gather_a2a)


def init(generator: torch.Generator, cfg: RecsysConfig, device=None) -> dict:
    """Random DIN parameters drawn from ``generator`` (which must live on
    ``device``), in the reference's layout: {"tables", "attn_mlp", "mlp"}."""
    dev = default_device(device)
    D = cfg.embed_dim
    # final MLP sees [pooled, target, all user fields, item fields sans item_id]
    d_other = (len(cfg.user_fields) + len(cfg.item_fields) - 1) * D
    return {
        "tables": tables_init(generator, cfg, device=dev),
        "attn_mlp": mlp_tower_init(generator, 4 * D, cfg.attn_mlp + (1,),
                                   torch.float32, device=dev),
        "mlp": mlp_tower_init(generator, D + D + d_other, cfg.mlp + (1,),
                              torch.float32, device=dev),
    }


def attention_pool(params, hist: torch.Tensor, mask: torch.Tensor,
                   target: torch.Tensor) -> torch.Tensor:
    """hist (B,T,D), target (B,D) → (B,D) activation-weighted sum, through
    the ``din_attention`` kernel (2-hidden-layer attention MLP)."""
    layers = params["attn_mlp"]
    if len(layers) != 3:
        raise ValueError("attention_pool expects a 2-hidden-layer attention "
                         f"MLP, got {len(layers)} layers")
    flat = [p[k] for p in layers for k in ("w", "b")]
    return din_attention(hist.contiguous(), mask.contiguous(),
                         target.contiguous(), *flat)


def _hist_emb(params, hist_ids, cfg):
    mask = (hist_ids >= 0).to(torch.float32)
    emb = sharded_embedding_bag_2d(
        params["tables"]["item_id"], hist_ids.clamp_min(0).reshape(-1, 1))
    emb = emb.reshape(*hist_ids.shape, cfg.embed_dim) * mask[..., None]
    return emb, mask


def logits_fn(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    hist, mask = _hist_emb(params, batch["user"]["hist"], cfg)
    target = sharded_embedding_bag_2d(params["tables"]["item_id"],
                                      batch["item"]["item_id"])
    other_u = embed_fields(params["tables"], cfg.user_fields,
                           batch["user"]["fields"])
    other_i = embed_fields(params["tables"],
                           tuple(f for f in cfg.item_fields if f.name != "item_id"),
                           batch["item"])
    pooled = attention_pool(params, hist, mask, target)
    x = torch.cat([pooled, target, other_u, other_i], dim=-1)
    return mlp_tower_apply(params["mlp"], x, act="silu")[..., 0]


def loss_fn(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """Forward loss only: the kernels on this path have no backward yet."""
    return bce_loss(logits_fn(params, batch, cfg), batch["label"])


@torch.no_grad()
def serve_scores(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    return torch.sigmoid(logits_fn(params, batch, cfg))


@torch.no_grad()
def score_candidates(params, user_batch: dict, cand_ids: dict,
                     cfg: RecsysConfig, top_k: int = 100,
                     path: str = "fused"):
    """Re-rank phase vs C candidates: hist computed once, attention per
    candidate (C as batch).

    ``path="fused"`` (the serving default) routes through the
    ``rerank_score`` kernel: the shared history is NEVER broadcast to
    (C, T, D) and the attention + score MLPs run in one pass.
    ``path="jnp"`` is the reference's broadcast-everything math (history
    broadcast to every candidate, ``attention_pool`` as a batch of C, then
    the score MLP), kept as the parity oracle of the fused path. Callers
    should hand ``user_batch["hist"]`` compacted/bucketed
    (serve/bucketing.compact_history) so the fused pass scores only the
    valid history rows.

    Returns (values, indices) of the ``top_k`` best scores, best first;
    ``torch.topk`` does not fix the order of equal scores."""
    C = cand_ids["item_id"].shape[0]
    hist, mask = _hist_emb(params, user_batch["hist"], cfg)   # (1,T,D)
    target = sharded_gather_a2a(params["tables"]["item_id"],
                                cand_ids["item_id"])           # (C,D)
    item_side = tuple(f for f in cfg.item_fields if f.name != "item_id")
    if path == "fused" and len(cfg.attn_mlp) == 2 and len(cfg.mlp) == 2:
        other_u = embed_fields(params["tables"], cfg.user_fields,
                               user_batch["fields"])[0]        # (d_u,)
        other_i = embed_fields(params["tables"], item_side, cand_ids)  # (C, d_i)
        scores = rerank_score(hist[0], mask[0], target, other_u, other_i,
                              params["attn_mlp"], params["mlp"])
    else:
        hist = hist.expand(C, *hist.shape[1:])
        mask = mask.expand(C, mask.shape[1])
        pooled = attention_pool(params, hist, mask, target)
        other_u = embed_fields(params["tables"], cfg.user_fields,
                               user_batch["fields"])           # (1, ...)
        other_u = other_u.expand(C, other_u.shape[-1])
        other_i = embed_fields(params["tables"], item_side, cand_ids)
        x = torch.cat([pooled, target, other_u, other_i], dim=-1)
        scores = mlp_tower_apply(params["mlp"], x, act="silu")[..., 0]
    return torch.topk(scores.float(), top_k, sorted=True)
