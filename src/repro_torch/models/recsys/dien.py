"""DIEN [arXiv:1809.03672] — interest extraction (GRU) + interest evolution
(AUGRU: attentional update gate), plus the auxiliary next-behavior loss.

The AUGRU recurrence is the serving hot spot (one sequence scan per
candidate); in the port it runs as the hand-written ``augru`` kernel and
the table lookups of each model call as one grouped ``embedding_bag``
launch, while the GRU stays
plain PyTorch, as the reference keeps it in jnp. Tensors on the CPU take
the kernels' plain versions. ``loss_fn`` is differentiable on both
devices: on the card the kernels run the forward and take their plain
versions' gradients.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import default_device, runtime
from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels.augru import augru
from repro_torch.models.layers import mlp_tower_apply, mlp_tower_init
from repro_torch.models.recsys.common import (batch_roll, batch_sum,
                                              bce_loss, field_lookups,
                                              hist_lookup, log_sigmoid,
                                              masked_hist, tables_init)
from repro_torch.obs.layer import span
from repro_torch.sparse.sharded import (BIG_AXES, sharded_embedding_bag_group,
                                        sharded_gather_a2a)
from repro_torch.topk import sharded_topk


def _randn(generator, shape, dev):
    return torch.randn(shape, generator=generator, device=dev,
                       dtype=torch.float32)


def gru_init(generator: torch.Generator, d_in: int, h: int,
             device=None) -> dict:
    dev = default_device(device)
    return {"w": _randn(generator, (d_in, 3 * h), dev) / np.sqrt(d_in),
            "u": _randn(generator, (h, 3 * h), dev) / np.sqrt(h),
            "b": torch.zeros((3 * h,), dtype=torch.float32, device=dev)}


def _gates(p, gx, h):
    """gx = x_t @ w + b (already projected) → update gate z, candidate n."""
    gh = h @ p["u"]
    H = h.shape[-1]
    r = torch.sigmoid(gx[..., :H] + gh[..., :H])
    z = torch.sigmoid(gx[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gx[..., 2 * H:] + r * gh[..., 2 * H:])
    return z, n


def gru_apply(p, x: torch.Tensor) -> torch.Tensor:
    """x (B,T,D) → all hidden states (B,T,H). The input projection of every
    step is one product up front, as the AUGRU kernel does it."""
    B, T, _ = x.shape
    H = p["u"].shape[0]
    gx = x @ p["w"] + p["b"]                                  # (B,T,3H)
    h = x.new_zeros((B, H))
    hs = []
    for t in range(T):
        z, n = _gates(p, gx[:, t], h)
        h = (1 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, 1) if hs else x.new_zeros((B, 0, H))


def augru_apply(p, x: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
    """AUGRU: att (B,T) scales the update gate. Returns the final hidden
    state (B,H), through the ``augru`` kernel."""
    return augru(x.contiguous(), att.contiguous(), p["w"], p["u"], p["b"])


def init(generator: torch.Generator, cfg: RecsysConfig, device=None,
         mesh=None) -> dict:
    """Random DIEN parameters drawn from ``generator`` (which must live on
    ``device``), in the reference's layout: {"tables", "gru", "augru",
    "att_w", "mlp", "aux_w"}.; on a live
    ``mesh`` the split tables are this rank's RowShards (``tables_init``)."""
    dev = default_device(device)
    D, H = cfg.embed_dim, cfg.gru_dim
    d_other = (len(cfg.user_fields) + len(cfg.item_fields) - 1) * D
    return {
        "tables": tables_init(generator, cfg, device=dev, mesh=mesh),
        "gru": gru_init(generator, D, H, device=dev),
        "augru": gru_init(generator, H, H, device=dev),
        "att_w": _randn(generator, (H, D), dev) / np.sqrt(H),
        "mlp": mlp_tower_init(generator, H + D + d_other, cfg.mlp + (1,),
                              torch.float32, device=dev),
        "aux_w": _randn(generator, (H, D), dev) / np.sqrt(H),
    }


def _attention(states, att_w, target, mask):
    """Softmax attention of each state against the target, masked as the
    reference does it: -1e30 before the softmax, times the mask after it
    (an all-padding history gives att = 0)."""
    att = torch.einsum("bth,hd,bd->bt", states, att_w, target)
    return torch.softmax(torch.where(mask > 0, att, -1e30), dim=-1) * mask


def _evolved_interest(params, hist, mask, target):
    """GRU states → attention vs target → AUGRU final state. (B,H)."""
    with span("model.gru"):
        states = gru_apply(params["gru"], hist)               # (B,T,H)
    with span("model.attention"):
        att = _attention(states, params["att_w"], target, mask)
    with span("model.augru"):
        return states, augru_apply(params["augru"], states, att)


def logits_fn(params, batch: dict, cfg: RecsysConfig, return_aux=False):
    tables = params["tables"]
    item_side = tuple(f for f in cfg.item_fields if f.name != "item_id")
    hist_ids = batch["user"]["hist"]
    # one grouped lookup: the history, then [target, user fields, item
    # fields] side by side
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
    states, final = _evolved_interest(params, hist, mask, target)
    with span("model.score_mlp"):
        x = torch.cat([final, feats], dim=-1)
        logits = mlp_tower_apply(params["mlp"], x, act="silu")[..., 0]
    if not return_aux:
        return logits
    # auxiliary loss: state_t should predict behavior t+1 (vs shuffled negative)
    pred = states[:, :-1] @ params["aux_w"]                   # (B,T-1,D)
    pos = torch.sum(pred * hist[:, 1:], -1)
    neg = torch.sum(pred * batch_roll(hist[:, 1:]), -1)
    m = mask[:, 1:]
    aux = -(log_sigmoid(pos) + log_sigmoid(-neg)) * m
    aux = batch_sum(aux) / torch.clamp(batch_sum(m), min=1.0)
    return logits, aux


def loss_fn(params, batch: dict, cfg: RecsysConfig,
            aux_weight=0.5) -> torch.Tensor:
    """BCE + aux_weight x the next-behavior aux loss; differentiable."""
    logits, aux = logits_fn(params, batch, cfg, return_aux=True)
    return bce_loss(logits, batch["label"]) + aux_weight * aux


@torch.no_grad()
def serve_scores(params, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    with span("model.step"):
        return torch.sigmoid(logits_fn(params, batch, cfg))


@torch.no_grad()
def score_candidates(params, user_batch: dict, cand_ids: dict,
                     cfg: RecsysConfig, top_k: int = 100):
    """Re-rank vs C candidates: GRU once, AUGRU per candidate (C rows of
    one ``augru`` launch). On a mesh (``user_batch`` and ``cand_ids``
    whole on every rank) C splits over ("data", "model") as in the
    reference (dien.py:141-142): each rank runs the AUGRU over its block
    and the ranks' top-k lists are merged. Returns (values, indices) of
    the ``top_k`` best scores, best first, the lower index first among
    equal scores (``lax.top_k``'s order), the same on every rank."""
    C = cand_ids["item_id"].shape[0]
    tables = params["tables"]
    item_side = tuple(f for f in cfg.item_fields if f.name != "item_id")
    hist_ids = user_batch["hist"]
    # the rank's candidates (a local slice of the whole ids)
    cands = {k: runtime.shard(v, BIG_AXES) for k, v in cand_ids.items()}
    emb, other_u, other_i = sharded_embedding_bag_group(
        [hist_lookup(tables, hist_ids),
         *field_lookups(tables, cfg.user_fields, user_batch["fields"]),
         *field_lookups(tables, item_side, cands)],
        blocks=(1, len(cfg.user_fields), len(item_side)),
        batch_axes=BIG_AXES)
    hist, mask = masked_hist(emb, hist_ids, cfg.embed_dim)    # (1,T,D)
    states = gru_apply(params["gru"], hist)                   # (1,T,H)
    # already split over ("data", "model"): the reference's shard at
    # dien.py:141 holds; its broadcast (dien.py:142) covers the rank's rows
    target = sharded_gather_a2a(tables["item_id"], cands["item_id"])  # (n,D)
    n = target.shape[0]
    states_b = states.expand(n, *states.shape[1:])
    mask_b = mask.expand(n, mask.shape[1])
    att = _attention(states_b, params["att_w"], target, mask_b)
    final = augru_apply(params["augru"], states_b, att)        # (n,H)
    other_u = other_u.expand(n, other_u.shape[-1])
    x = torch.cat([final, target, other_u, other_i], dim=-1)
    scores = mlp_tower_apply(params["mlp"], x, act="silu")[..., 0]
    return sharded_topk(scores.float(), top_k, C)
