"""DIN [arXiv:1706.06978] — deep interest network (target attention).

The local activation unit scores each history item against the candidate via
an MLP over [h, t, h−t, h⊙t] (80→40→1, paper-exact), then weighted-sum pools
WITHOUT softmax normalization (paper §4.3). In the port the unit runs as
the hand-written ``din_attention`` kernel, the candidate re-rank as the
fused ``rerank_score`` kernel, and the table lookups of each model call
as one grouped ``embedding_bag`` launch; tensors on the CPU take their
plain versions.
"""
from __future__ import annotations

import torch

from repro_torch import default_device, runtime
from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels.din_attention import din_attention
from repro_torch.kernels.rerank_score import rerank_score
from repro_torch.models.layers import mlp_tower_apply, mlp_tower_init
from repro_torch.models.recsys.common import (bce_loss, field_lookups,
                                              hist_lookup, masked_hist,
                                              tables_init)
from repro_torch.obs.layer import span
from repro_torch.sparse.sharded import (BIG_AXES, sharded_embedding_bag_group,
                                        sharded_gather_a2a)
from repro_torch.topk import ordered_topk, sharded_topk


def init(generator: torch.Generator, cfg: RecsysConfig, device=None,
         mesh=None) -> dict:
    """Random DIN parameters drawn from ``generator`` (which must live on
    ``device``), in the reference's layout: {"tables", "attn_mlp", "mlp"};
    on a live ``mesh`` the split tables are this rank's RowShards
    (``tables_init``)."""
    dev = default_device(device)
    D = cfg.embed_dim
    # final MLP sees [pooled, target, all user fields, item fields sans item_id]
    d_other = (len(cfg.user_fields) + len(cfg.item_fields) - 1) * D
    return {
        "tables": tables_init(generator, cfg, device=dev, mesh=mesh),
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


def logits_fn(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    tables = params["tables"]
    item_side = tuple(f for f in cfg.item_fields if f.name != "item_id")
    hist_ids = batch["user"]["hist"]
    # one grouped lookup: the history, then [target, user fields, item
    # fields] side by side, as the score MLP reads them
    with span("model.lookup"):
        emb, feats = sharded_embedding_bag_group(
            [hist_lookup(tables, hist_ids),
             (tables["item_id"], batch["item"]["item_id"], None, "sum"),
             *field_lookups(tables, cfg.user_fields, batch["user"]["fields"]),
             *field_lookups(tables, item_side, batch["item"])],
            blocks=(1, 1 + len(cfg.user_fields) + len(item_side)))
    with span("model.hist_mask"):
        hist, mask = masked_hist(emb, hist_ids, cfg.embed_dim)
    target = feats[:, :cfg.embed_dim]
    with span("model.attention"):
        pooled = attention_pool(params, hist, mask, target)
    with span("model.score_mlp"):
        x = torch.cat([pooled, feats], dim=-1)
        return mlp_tower_apply(params["mlp"], x, act="silu")[..., 0]


def loss_fn(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """BCE of the logits, differentiable on both devices: on the card the
    grouped embedding_bag and din_attention kernels run the forward and
    take their plain versions' gradients."""
    return bce_loss(logits_fn(params, batch, cfg), batch["label"])


@torch.no_grad()
def serve_scores(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    with span("model.step"):
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

    On a mesh (``user_batch`` and ``cand_ids`` whole on every rank) the
    fused path gathers the candidates' target rows (all-to-all, then
    all_gather) and runs the kernel on every rank over all C, as the
    reference's jit replicates a kernel call no shard_map wraps
    (din.py:93-102); the broadcast path splits C over ("data", "model")
    as the reference's launch cells pin it (din.py:106, 111), each rank
    scoring its block, and the ranks' top-k lists are merged.

    Returns (values, indices) of the ``top_k`` best scores, best first,
    the lower index first among equal scores (``lax.top_k``'s order), the
    same on every rank."""
    C = cand_ids["item_id"].shape[0]
    tables = params["tables"]
    item_side = tuple(f for f in cfg.item_fields if f.name != "item_id")
    hist_ids = user_batch["hist"]
    fused = path == "fused" and len(cfg.attn_mlp) == 2 and len(cfg.mlp) == 2
    # the broadcast path's candidates: the rank's block over ("data",
    # "model") (a local slice; the reference's shard at din.py:106, 111)
    cands = cand_ids if fused else {
        k: runtime.shard(v, BIG_AXES) for k, v in cand_ids.items()}
    emb, other_u, other_i = sharded_embedding_bag_group(
        [hist_lookup(tables, hist_ids),
         *field_lookups(tables, cfg.user_fields, user_batch["fields"]),
         *field_lookups(tables, item_side, cands)],
        blocks=(1, len(cfg.user_fields), len(item_side)),
        batch_axes=() if fused else BIG_AXES)
    hist, mask = masked_hist(emb, hist_ids, cfg.embed_dim)    # (1,T,D)
    target = sharded_gather_a2a(
        tables["item_id"], runtime.shard(cand_ids["item_id"], BIG_AXES))
    if fused:
        target = runtime.gather_rows(target, BIG_AXES, C)     # (C,D)
        scores = rerank_score(hist[0], mask[0], target, other_u[0], other_i,
                              params["attn_mlp"], params["mlp"])
        return ordered_topk(scores.float(), top_k)
    n = target.shape[0]                     # the rank's candidates
    # the history broadcast to the rank's rows only (din.py:106)
    hist = hist.expand(n, *hist.shape[1:])
    mask = mask.expand(n, mask.shape[1])
    pooled = attention_pool(params, hist, mask, target)
    other_u = other_u.expand(n, other_u.shape[-1])
    x = torch.cat([pooled, target, other_u, other_i], dim=-1)
    scores = mlp_tower_apply(params["mlp"], x, act="silu")[..., 0]
    return sharded_topk(scores.float(), top_k, C)
