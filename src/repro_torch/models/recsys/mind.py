"""MIND [arXiv:1904.08030] — multi-interest capsule network.

Behavior-to-interest (B2I) dynamic routing: T history embeddings → K interest
capsules (squash nonlinearity, routing logits NOT backpropagated across
iterations, per the paper). Label-aware attention (pow-2) for training;
serving scores are max over interests. The table lookups of each model
call run as one grouped ``embedding_bag`` launch; ``retrieve`` takes a max over K interests, which
is not the ``candidate_scorer`` kernel's single-query function, so it is a
plain product and a top-k in ``lax.top_k``'s order, as the reference
keeps it outside any kernel. ``loss_fn`` is differentiable on both
devices (the grouped lookup takes its plain version's gradient on the
card).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import default_device, runtime
from repro_torch.configs.base import RecsysConfig
from repro_torch.models.layers import mlp_tower_apply, mlp_tower_init
from repro_torch.models.recsys.common import (hist_lookup, l2_normalize,
                                              masked_hist,
                                              sampled_softmax_loss, tables_init)
from repro_torch.sparse.sharded import (BIG_AXES, sharded_embedding_bag_group,
                                        sharded_gather_a2a)
from repro_torch.topk import sharded_topk


def init(generator: torch.Generator, cfg: RecsysConfig, device=None,
         mesh=None) -> dict:
    """Random MIND parameters drawn from ``generator`` (which must live on
    ``device``), in the reference's layout: {"tables", "s_bilinear",
    "interest_mlp"}.; on a live
    ``mesh`` the split tables are this rank's RowShards (``tables_init``)."""
    dev = default_device(device)
    D = cfg.embed_dim
    return {
        "tables": tables_init(generator, cfg, device=dev, mesh=mesh),
        "s_bilinear": torch.randn((D, D), generator=generator, device=dev,
                                  dtype=torch.float32) / np.sqrt(D),
        "interest_mlp": mlp_tower_init(generator, D, cfg.mlp + (D,),
                                       torch.float32, device=dev),
    }


def squash(s: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(s * s, -1, keepdim=True)
    return (n2 / (1.0 + n2)) * s / torch.sqrt(n2 + 1e-9)


def interests(params, hist_emb: torch.Tensor, hist_mask: torch.Tensor,
              cfg: RecsysConfig) -> torch.Tensor:
    """hist_emb (B,T,D), mask (B,T) → (B,K,D) interest capsules."""
    B, T, D = hist_emb.shape
    K = cfg.n_interests
    low = hist_emb @ params["s_bilinear"]                    # (B,T,D)
    # fixed pseudo-random routing init (paper: random, not learned): the
    # reference's numpy draw, in float64 then cast, so both packages start
    # from the same logits
    b0 = torch.as_tensor(
        np.random.default_rng(0).normal(size=(1, K, T)).astype(np.float32),
        device=hist_emb.device)
    b = b0.expand(B, K, T)
    neg = -1e30 * (1.0 - hist_mask)[:, None, :]
    low_sg = low.detach()
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b + neg, dim=1)                    # over K
        s = torch.einsum("bkt,btd->bkd", w, low_sg)
        u = squash(s)
        b = b + torch.einsum("bkd,btd->bkt", u, low_sg)
    # final pass lets gradients flow through the last aggregation
    w = torch.softmax(b + neg, dim=1)
    u = squash(torch.einsum("bkt,btd->bkd", w, low))
    u = mlp_tower_apply(params["interest_mlp"], u, final_act=False)
    return l2_normalize(u)


def _hist(params, batch, cfg):
    hist_ids = batch["user"]["hist"]                          # (B,T)
    emb, = sharded_embedding_bag_group(
        [hist_lookup(params["tables"], hist_ids)])            # (B*T, D)
    return masked_hist(emb, hist_ids, cfg.embed_dim)


def _hist_and_target(params, batch, cfg):
    """The history (as :func:`_hist`) and the target items, (B, D), from
    one grouped lookup."""
    hist_ids = batch["user"]["hist"]
    emb, tgt = sharded_embedding_bag_group(
        [hist_lookup(params["tables"], hist_ids),
         (params["tables"]["item_id"], batch["item"]["item_id"], None,
          "sum")])
    return (*masked_hist(emb, hist_ids, cfg.embed_dim), tgt)


def loss_fn(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """In-batch sampled softmax of the label-aware user vector;
    differentiable."""
    emb, mask, tgt = _hist_and_target(params, batch, cfg)
    I = interests(params, emb, mask, cfg)                     # (B,K,D)
    tgt = l2_normalize(tgt)                                   # (B,D)
    # label-aware attention, pow 2
    att = torch.softmax(torch.einsum("bkd,bd->bk", I, tgt) ** 2 * 8.0, dim=-1)
    u = torch.einsum("bk,bkd->bd", att, I)
    return sampled_softmax_loss(l2_normalize(u), tgt)


@torch.no_grad()
def serve_scores(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    emb, mask, tgt = _hist_and_target(params, batch, cfg)
    I = interests(params, emb, mask, cfg)
    tgt = l2_normalize(tgt)
    return torch.amax(torch.einsum("bkd,bd->bk", I, tgt), dim=-1)


@torch.no_grad()
def retrieve(params, user_batch: dict, cand_ids: dict, cfg: RecsysConfig,
             top_k: int = 100):
    """One user's K interests vs C candidates: the best interest's score
    per candidate, then the top ``top_k`` (values, indices), best first.
    On a mesh (``user_batch`` and ``cand_ids`` whole on every rank) each
    rank scores its block of C over ("data", "model") and the ranks'
    top-k lists are merged."""
    C = cand_ids["item_id"].shape[0]
    emb, mask = _hist(params, {"user": user_batch}, cfg)
    I = interests(params, emb, mask, cfg)[0]                  # (K,D)
    # already split over ("data", "model"): the reference's shard at
    # mind.py:98 holds
    v = l2_normalize(sharded_gather_a2a(
        params["tables"]["item_id"],
        runtime.shard(cand_ids["item_id"], BIG_AXES)))
    scores = torch.amax(v @ I.T, dim=-1).float()              # (n,)
    return sharded_topk(scores, top_k, C)
