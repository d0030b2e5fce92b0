"""Shared recsys substrate: hashed feature fields → embedding tables."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import default_device
from repro_torch.configs.base import FeatureField, RecsysConfig
from repro_torch.sparse.sharded import sharded_embedding_bag_2d


def tables_init(generator: torch.Generator, cfg: RecsysConfig,
                device=None) -> dict:
    """One (vocab, embed_dim) table per feature field, ~ N(0, 0.01²), keyed
    by field name. Drawn in place so a multi-GB table never exists twice."""
    dev = default_device(device)
    fields = cfg.user_fields + cfg.item_fields
    return {f.name: torch.randn((f.vocab, cfg.embed_dim), generator=generator,
                                device=dev, dtype=torch.float32).mul_(0.01)
            for f in fields}


def embed_fields(tables: dict, fields: tuple[FeatureField, ...],
                 ids: dict) -> torch.Tensor:
    """ids[name]: (B,) or (B, bag) int → concat (B, n_fields * D)."""
    outs = []
    for f in fields:
        outs.append(sharded_embedding_bag_2d(tables[f.name], ids[f.name],
                                             combiner=f.combiner))
    return torch.cat(outs, dim=-1)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    ls = F.logsigmoid(logits)
    return -torch.mean(labels * ls + (1 - labels) * (ls - logits))


def sampled_softmax_loss(user_vecs: torch.Tensor, item_vecs: torch.Tensor,
                         log_q: torch.Tensor | None = None,
                         temperature: float = 0.05) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction [Yi et al., RecSys'19].
    user/item (B, D) row-aligned positives."""
    logits = (user_vecs @ item_vecs.T) / temperature       # (B, B)
    if log_q is not None:
        logits = logits - log_q[None, :]
    labels = torch.arange(user_vecs.shape[0], device=logits.device)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.mean(lse - gold)


def l2_normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(x * x, -1, keepdim=True) + eps)
