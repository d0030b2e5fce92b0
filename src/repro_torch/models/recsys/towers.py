"""Two-tower retrieval [Covington RecSys'16; Yi et al. RecSys'19].

In the port the user fields (single ids and the multi-hot ``user_hist`` /
``user_ctx`` bags) run as one grouped ``embedding_bag`` launch, and ``retrieve``'s
dot product of every candidate with the user vector plus its top-k run as
the ``candidate_scorer`` kernel. Tensors on the CPU take the kernels'
plain versions. ``loss_fn`` is differentiable on both devices (the
grouped lookups take their plain version's gradient on the card).
"""
from __future__ import annotations

import torch

from repro_torch import default_device, runtime
from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels.candidate_scorer import candidate_scorer
from repro_torch.models.layers import mlp_tower_apply, mlp_tower_init
from repro_torch.models.recsys.common import (embed_fields, l2_normalize,
                                              sampled_softmax_loss, tables_init)
from repro_torch.sparse.sharded import BIG_AXES, sharded_gather_a2a
from repro_torch.topk import merge_over_mesh


def init(generator: torch.Generator, cfg: RecsysConfig, device=None,
         mesh=None) -> dict:
    """Random two-tower parameters drawn from ``generator`` (which must live
    on ``device``), in the reference's layout: {"tables", "user_tower",
    "item_tower"}.; on a live
    ``mesh`` the split tables are this rank's RowShards (``tables_init``)."""
    dev = default_device(device)
    d_user = len(cfg.user_fields) * cfg.embed_dim
    d_item = len(cfg.item_fields) * cfg.embed_dim
    return {
        "tables": tables_init(generator, cfg, device=dev, mesh=mesh),
        "user_tower": mlp_tower_init(generator, d_user, cfg.tower_mlp,
                                     torch.float32, device=dev),
        "item_tower": mlp_tower_init(generator, d_item, cfg.tower_mlp,
                                     torch.float32, device=dev),
    }


def user_vec(params, user_ids: dict, cfg: RecsysConfig) -> torch.Tensor:
    x = embed_fields(params["tables"], cfg.user_fields, user_ids)
    return l2_normalize(mlp_tower_apply(params["user_tower"], x))


def item_vec(params, item_ids: dict, cfg: RecsysConfig) -> torch.Tensor:
    x = embed_fields(params["tables"], cfg.item_fields, item_ids)
    return l2_normalize(mlp_tower_apply(params["item_tower"], x))


def loss_fn(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction; differentiable."""
    u = user_vec(params, batch["user"]["fields"], cfg)
    v = item_vec(params, batch["item"], cfg)
    return sampled_softmax_loss(u, v, batch.get("log_q"))


@torch.no_grad()
def serve_scores(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """Paired (user, item) relevance scores, (B,)."""
    u = user_vec(params, batch["user"]["fields"], cfg)
    v = item_vec(params, batch["item"], cfg)
    return torch.sum(u * v, dim=-1)


@torch.no_grad()
def retrieve(params, user_ids: dict, cand_ids: dict, cfg: RecsysConfig,
             top_k: int = 100):
    """One query vs n_candidates (recall phase): the candidates' item
    tower, then the ``candidate_scorer`` kernel's dot and top-k. Returns
    (values, indices), best first. On a mesh (``user_ids`` and
    ``cand_ids`` whole on every rank) each rank gathers, embeds and scores
    its block of candidates over ("data", "model") and the ranks' top-k
    lists are merged."""
    C = next(iter(cand_ids.values())).shape[0]
    if not 0 <= top_k <= C:
        raise ValueError(f"top-k: k={top_k} must lie in [0, {C}]")
    u = user_vec(params, user_ids, cfg)                       # (1, D)
    # multi-hot item fields keep the reference's per-column gathers (each
    # row moves once on a mesh), pooled here
    cols = []
    for f in cfg.item_fields:
        ids = runtime.shard(cand_ids[f.name], BIG_AXES)
        if f.bag == 1:
            cols.append(sharded_gather_a2a(params["tables"][f.name], ids))
        else:
            acc = sum(sharded_gather_a2a(params["tables"][f.name],
                                         ids[:, j].contiguous())
                      for j in range(f.bag))
            cols.append(acc / f.bag if f.combiner == "mean" else acc)
    # already split over ("data", "model"): the reference's shard at
    # towers.py:72 holds
    x = torch.cat(cols, dim=-1)
    v = l2_normalize(mlp_tower_apply(params["item_tower"], x))  # (n, D)
    start, per = runtime.block(C, BIG_AXES)
    valid = max(0, min(per, C - start))
    k = min(top_k, valid)
    if k:
        vals, idx = candidate_scorer(v[:valid].contiguous(),
                                     u[0].contiguous(), k)
    else:
        vals = v.new_zeros((0,))
        idx = torch.zeros((0,), dtype=torch.long, device=v.device)
    return merge_over_mesh(vals, idx, start, top_k, BIG_AXES)
