"""MoE (DeepSeek-style: shared + fine-grained routed experts), the
single-device path, in PyTorch.

Dispatch is sort-based, as in the reference: argsort by expert,
rank-in-expert capacity, a gather into (E, C, d) buffers, one batched
product per expert weight, and a combine through a zero sentinel row for
dropped pairs. The expert-parallel path over a device mesh is not ported
yet: passing a ``mesh`` raises ``NotImplementedError``. Shared experts are
a plain dense GLU handled by the caller.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import default_device, runtime
from repro_torch.models.layers import activation, as_dtype, randn_scaled
from repro_torch.topk import ordered_topk


def moe_expert_init(generator: torch.Generator, d_model: int, cfg, dtype,
                    device=None) -> dict:
    """Routed experts + router. Weights stacked (E, d, f) / (E, f, d); the
    router stays float32 (routing stability)."""
    dev = default_device(device)
    dt = as_dtype(dtype)
    E, f = cfg.n_routed, cfg.d_ff_expert
    s_in, s_f = 1.0 / np.sqrt(d_model), 1.0 / np.sqrt(f)
    return {"router": randn_scaled(generator, (d_model, E), s_in, dev),
            "w1": randn_scaled(generator, (E, d_model, f), s_in, dev).to(dt),
            "w3": randn_scaled(generator, (E, d_model, f), s_in, dev).to(dt),
            "w2": randn_scaled(generator, (E, f, d_model), s_f, dev).to(dt)}


def _capacity(tokens: int, cfg) -> int:
    c = int(np.ceil(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_routed))
    return max(8, -(-c // 8) * 8)


def _route(x, router_w, top_k: int):
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    gate, idx = ordered_topk(probs, top_k)                        # (T, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux (Switch-style), for a training loss
    T, E = logits.shape
    me = probs.mean(0)
    ce = torch.bincount(idx.reshape(-1), minlength=E).float() / (T * top_k)
    aux = E * torch.sum(me * ce)
    return gate, idx, aux


def _dispatch_compute_combine(xg, gate, idx, w1, w3, w2, *, e0: int, C: int,
                              act: str):
    """Sort-based pack → per-expert products → combine, for experts
    [e0, e0+E_loc). xg (T, d); gate/idx (T, k); w* (E_loc, d, f) /
    (E_loc, f, d). Returns (T, d)."""
    T, d = xg.shape
    k = idx.shape[1]
    E_loc = w1.shape[0]
    N = T * k
    dev = xg.device
    e_flat = idx.reshape(-1) - e0                                 # (N,)
    mine = (e_flat >= 0) & (e_flat < E_loc)
    sort_key = torch.where(mine, e_flat, torch.full_like(e_flat, E_loc))
    order = torch.argsort(sort_key, stable=True)
    sorted_e = sort_key[order]
    counts = torch.bincount(sorted_e, minlength=E_loc + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(N, device=dev) - starts[sorted_e]
    keep = (sorted_e < E_loc) & (pos < C)
    sentinel = E_loc * C
    slot = torch.where(keep, sorted_e * C + pos, torch.full_like(pos, sentinel))
    src_tok = order // k

    # slot → source token; a slot no pair fills stays empty (zero row)
    idx_buf = torch.zeros((sentinel + 1,), dtype=torch.long, device=dev)
    idx_buf[slot[keep]] = src_tok[keep]
    occ = torch.zeros((sentinel + 1,), dtype=xg.dtype, device=dev)
    occ[slot[keep]] = 1
    buf = xg.index_select(0, idx_buf[:sentinel]) * occ[:sentinel, None]
    buf = buf.reshape(E_loc, C, d)

    h1 = torch.bmm(buf, w1)
    h3 = torch.bmm(buf, w3)
    h = activation(h1, act) * h3
    out_buf = torch.bmm(h, w2)
    flat = torch.cat([out_buf.reshape(sentinel, d),
                      torch.zeros((1, d), dtype=out_buf.dtype, device=dev)])
    # token → its k slots (dropped or foreign pairs hit the zero sentinel)
    slot_tok = torch.empty((N,), dtype=torch.long, device=dev)
    slot_tok[order] = slot
    slot_tok = slot_tok.reshape(T, k)
    out = torch.zeros((T, d), dtype=xg.dtype, device=dev)
    for j in range(k):
        out = out + flat.index_select(0, slot_tok[:, j]) \
            * gate[:, j, None].to(xg.dtype)
    return out


def moe_apply(p: dict, x: torch.Tensor, cfg, act: str = "silu", mesh=None):
    """x (..., d) → (same, aux_loss). Token dims are flattened internally.
    Single device only: a ``mesh``, or an installed mesh
    (``runtime.current_mesh()``) whose ``model`` axis is larger than 1,
    raises."""
    if mesh is not None or runtime.axis_size("model") > 1:
        raise NotImplementedError(
            "the expert-parallel MoE over a device mesh is not ported yet "
            "(ROADMAP A8); only the single-device path exists")
    lead = x.shape[:-1]
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    gate, idx, aux = _route(xt, p["router"], cfg.top_k)
    out = _dispatch_compute_combine(
        xt, gate, idx, p["w1"], p["w3"], p["w2"],
        e0=0, C=_capacity(xt.shape[0], cfg), act=act)
    return out.reshape(*lead, d), aux
