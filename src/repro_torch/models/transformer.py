"""LM transformer: dense (qwen3 / smollm / starcoder2) and MoE + MLA
(deepseek v2-lite / v3) parameters; the training half (blocks with remat,
the chunked vocab loss, the next-token loss with deepseek-v3's MTP head
and the MoE aux term) and the serving half (prefill, KV-cache decode), in
PyTorch on one device.

Params layout (the reference's, stacked over layers, so weights carry
across unchanged):
  embed.table (V, d)
  dense_layers.* (n_dense, ...)     -- MoE configs' leading dense FFN layers
  layers.* (n_scan, ...)            -- the homogeneous stack
  final_norm, lm_head.w (d, V)      -- lm_head absent when tie_embeddings
  mtp.{proj, norm_h, norm_e, block} -- deepseek-v3 multi-token prediction

The reference scans over the stacked layers; here a Python loop indexes
them, and where ``cfg.remat`` a layer of the stack runs under
``torch.utils.checkpoint`` (its activations recomputed in the backward,
the reference's ``jax.checkpoint`` with ``nothing_saveable``). Decode
writes each layer's new K/V into the cache in place.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import default_device
from repro_torch.configs.base import LMConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (as_dtype, mlp_apply, mlp_init,
                                       norm_apply, norm_init, randn_scaled)
from repro_torch.sparse.sharded import sharded_lookup


def _dtype(cfg: LMConfig) -> torch.dtype:
    return as_dtype(cfg.param_dtype)


def _layer_init(generator, cfg: LMConfig, moe_layer: bool, device) -> dict:
    dt = _dtype(cfg)
    p = {"ln1": norm_init(cfg.d_model, cfg.norm, dt, device),
         "ln2": norm_init(cfg.d_model, cfg.norm, dt, device),
         "attn": attn.attn_init(generator, cfg, dt, device)}
    if moe_layer:
        p["moe"] = moe_lib.moe_expert_init(generator, cfg.d_model, cfg.moe, dt,
                                           device)
        if cfg.moe.n_shared:
            p["shared"] = mlp_init(generator, cfg.d_model,
                                   cfg.moe.n_shared * cfg.moe.d_ff_expert,
                                   cfg.d_model, cfg.glu, dt, device)
    else:
        d_ff = cfg.d_ff
        if cfg.moe is not None:
            d_ff = cfg.moe.dense_d_ff or cfg.d_ff
        p["mlp"] = mlp_init(generator, cfg.d_model, d_ff, cfg.d_model,
                            cfg.glu, dt, device)
    return p


def _stack(trees: list):
    """A list of equal parameter trees → one tree of stacked tensors."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(stacked, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def init(generator: torch.Generator, cfg: LMConfig, device=None) -> dict:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``), in the reference's layout."""
    dev = default_device(device)
    dt = _dtype(cfg)
    n_dense = cfg.moe.n_dense_layers if cfg.moe else 0
    n_scan = cfg.n_layers - n_dense
    params: dict = {
        "embed": {"table": randn_scaled(generator, (cfg.vocab, cfg.d_model),
                                        0.02, dev).to(dt)},
        "final_norm": norm_init(cfg.d_model, cfg.norm, dt, dev),
    }
    if n_dense:
        params["dense_layers"] = _stack([
            _layer_init(generator, cfg, False, dev) for _ in range(n_dense)])
    params["layers"] = _stack([
        _layer_init(generator, cfg, cfg.moe is not None, dev)
        for _ in range(n_scan)])
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": randn_scaled(
            generator, (cfg.d_model, cfg.vocab), 1.0 / np.sqrt(cfg.d_model),
            dev).to(dt)}
    if cfg.mtp:
        params["mtp"] = {
            "proj": randn_scaled(generator, (2 * cfg.d_model, cfg.d_model),
                                 1.0 / np.sqrt(2 * cfg.d_model), dev).to(dt),
            "norm_h": norm_init(cfg.d_model, cfg.norm, dt, dev),
            "norm_e": norm_init(cfg.d_model, cfg.norm, dt, dev),
            "block": _layer_init(generator, cfg, cfg.moe is not None, dev),
        }
    return params


# ----------------------------------------------------------------- blocks

def _ffn_aux(p, x, cfg: LMConfig, moe_layer: bool):
    """The block's feed-forward and its MoE load-balance aux (0 if dense)."""
    if moe_layer:
        ff, aux = moe_lib.moe_apply(p["moe"], x, cfg.moe, cfg.act)
        if "shared" in p:
            ff = ff + mlp_apply(p["shared"], x, cfg.act, cfg.glu)
        return ff, aux
    return (mlp_apply(p["mlp"], x, cfg.act, cfg.glu),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _ffn(p, x, cfg: LMConfig, moe_layer: bool):
    return _ffn_aux(p, x, cfg, moe_layer)[0]


def _block(p, x, positions, cfg: LMConfig, moe_layer: bool):
    """Pre-norm transformer block. Returns (x, aux_loss)."""
    h, _ = attn.attn_forward(
        p["attn"], norm_apply(x, p["ln1"], cfg.norm, cfg.norm_eps),
        positions, cfg)
    x = x + h
    ff, aux = _ffn_aux(p, norm_apply(x, p["ln2"], cfg.norm, cfg.norm_eps),
                       cfg, moe_layer)
    return x + ff, aux


def _block_decode(p, x, positions, cfg: LMConfig, moe_layer: bool, cache,
                  cache_len):
    h, new_cache = attn.attn_forward(
        p["attn"], norm_apply(x, p["ln1"], cfg.norm, cfg.norm_eps),
        positions, cfg, cache=cache, cache_len=cache_len)
    x = x + h
    ff_in = norm_apply(x, p["ln2"], cfg.norm, cfg.norm_eps)
    return x + _ffn(p, ff_in, cfg, moe_layer), new_cache


def _head_w(params, cfg: LMConfig):
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def hidden_states(params, tokens, cfg: LMConfig):
    """Embed + all blocks + final norm. tokens (B,S) → (B,S,d), aux."""
    B, S = tokens.shape
    x = sharded_lookup(params["embed"]["table"], tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if "dense_layers" in params:
        for i in range(params["dense_layers"]["ln1"]["scale"].shape[0]):
            x, _ = _block(_layer(params["dense_layers"], i), x, positions, cfg,
                          moe_layer=False)
    moe_layer = cfg.moe is not None

    def body(p, x):
        return _block(p, x, positions, cfg, moe_layer)

    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(params["layers"]["ln1"]["scale"].shape[0]):
        p = _layer(params["layers"], i)
        if remat:
            x, aux = checkpoint(body, p, x, use_reentrant=False)
        else:
            x, aux = body(p, x)
        aux_total = aux_total + aux
    x = norm_apply(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return x, aux_total


def chunked_xent(x, head_w, labels, mask, chunk: int = 512):
    """Cross-entropy without materializing (B,S,V): a loop over S chunks,
    each chunk's logits in float32. Mean over the positions ``mask``
    keeps."""
    B, S, d = x.shape
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        at = slice(i * chunk, (i + 1) * chunk)
        xi, li, mi = x[:, at], labels[:, at], mask[:, at]
        logits = (xi @ head_w).float()                       # (B,c,V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, li[..., None].long())[..., 0]
        nll = (lse - gold) * mi
        tot = tot + nll.sum()
        cnt = cnt + mi.sum()
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, tokens, cfg: LMConfig, aux_weight: float = 1e-3):
    """Next-token loss (+MTP loss for deepseek-v3, + aux_weight x the MoE
    load-balance aux). tokens (B,S)."""
    x, aux = hidden_states(params, tokens, cfg)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1] * 0], dim=1)
    ones = torch.ones(tokens[:, 1:].shape, dtype=torch.float32,
                      device=tokens.device)
    mask = F.pad(ones, (0, 1))
    head_w = _head_w(params, cfg)
    loss = chunked_xent(x, head_w, labels, mask)
    if cfg.mtp and "mtp" in params:
        # MTP depth 1: combine h_t with the embedding of token t+1, one
        # extra block, predict token t+2 (deepseek-v3 §2.2)
        mp = params["mtp"]
        emb_next = sharded_lookup(params["embed"]["table"],
                                  torch.roll(tokens, -1, dims=1))
        h = torch.cat([
            norm_apply(x, mp["norm_h"], cfg.norm, cfg.norm_eps),
            norm_apply(emb_next, mp["norm_e"], cfg.norm, cfg.norm_eps)], -1)
        h = h @ mp["proj"]
        B, S = tokens.shape
        positions = torch.arange(S, device=h.device).expand(B, S)
        h, _ = _block(mp["block"], h, positions, cfg,
                      moe_layer=cfg.moe is not None)
        labels2 = torch.roll(tokens, -2, dims=1)
        mask2 = F.pad(ones[:, 1:], (0, 2))
        loss = loss + 0.3 * chunked_xent(h, head_w, labels2, mask2)
    return loss + aux_weight * aux


# ----------------------------------------------------------------- serving

class KVCache(NamedTuple):
    """Per-layer stacks. GQA: a=(L,B,Smax,Hkv,D) k, b=v. MLA:
    a=(L,B,Smax,kv_lora) latent, b=(L,B,Smax,d_rope) rope keys. length: the
    valid prefix, one 0-d int32 on the cache's device."""
    a: torch.Tensor
    b: torch.Tensor
    length: torch.Tensor

    @staticmethod
    def zeros(cfg: LMConfig, batch: int, smax: int, device=None) -> "KVCache":
        """An empty cache (zeros, length 0) on ``device``: the reference's
        ``KVCache.shapes`` made into an allocator."""
        dev = default_device(device)
        L = cfg.n_layers
        if cfg.mla:
            a = (L, batch, smax, cfg.mla.kv_lora)
            b = (L, batch, smax, cfg.mla.d_rope)
        else:
            a = b = (L, batch, smax, cfg.n_kv, cfg.d_head)
        return KVCache(a=torch.zeros(a, dtype=_dtype(cfg), device=dev),
                       b=torch.zeros(b, dtype=_dtype(cfg), device=dev),
                       length=torch.zeros((), dtype=torch.int32, device=dev))


def _split_cache(cache: KVCache, cfg: LMConfig):
    n_dense = cfg.moe.n_dense_layers if cfg.moe else 0
    dense = (cache.a[:n_dense], cache.b[:n_dense])
    scanned = (cache.a[n_dense:], cache.b[n_dense:])
    return dense, scanned, n_dense


def decode_step(params, cache: KVCache, tokens, cfg: LMConfig):
    """One decode step: tokens (B,1) + cache → (logits (B,V) float32, cache
    with length + 1).

    Unlike the reference, which returns new cache arrays, the new K/V are
    written into ``cache.a`` / ``cache.b`` in place (no copy of the whole
    cache per step): the returned cache shares those tensors, and the one
    passed in sees the writes. The length stays on the device, so a step
    never waits on the host."""
    B = tokens.shape[0]
    x = sharded_lookup(params["embed"]["table"], tokens)
    positions = cache.length.expand(B, 1)
    (da, db), (sa, sb), n_dense = _split_cache(cache, cfg)
    for i in range(n_dense):
        x, _ = _block_decode(_layer(params["dense_layers"], i), x, positions,
                             cfg, False, (da[i], db[i]), cache.length)
    moe_layer = cfg.moe is not None
    for i in range(sa.shape[0]):
        x, _ = _block_decode(_layer(params["layers"], i), x, positions, cfg,
                             moe_layer, (sa[i], sb[i]), cache.length)
    x = norm_apply(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = (x[:, -1] @ _head_w(params, cfg)).float()
    return logits, cache._replace(length=cache.length + 1)


def prefill(params, tokens, cfg: LMConfig, smax: int):
    """Prefill: tokens (B,S) → (last-position logits (B,V) float32, KVCache
    padded to smax)."""
    B, S = tokens.shape
    dev = params["embed"]["table"].device
    x = sharded_lookup(params["embed"]["table"], tokens)
    positions = torch.arange(S, device=dev).expand(B, S)
    n_dense = cfg.moe.n_dense_layers if cfg.moe else 0
    pad = smax - S

    def pad_kv(t):
        return torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 2) + (0, pad))

    new_a, new_b = [], []
    n_scan = params["layers"]["ln1"]["scale"].shape[0]
    for i in range(n_dense + n_scan):
        dense = i < n_dense
        p = _layer(params["dense_layers"] if dense else params["layers"],
                   i if dense else i - n_dense)
        h, kv = attn.attn_forward(
            p["attn"], norm_apply(x, p["ln1"], cfg.norm, cfg.norm_eps),
            positions, cfg)
        x = x + h
        ff_in = norm_apply(x, p["ln2"], cfg.norm, cfg.norm_eps)
        x = x + _ffn(p, ff_in, cfg, moe_layer=not dense and cfg.moe is not None)
        new_a.append(pad_kv(kv[0]))
        new_b.append(pad_kv(kv[1]))
    x = norm_apply(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = (x[:, -1] @ _head_w(params, cfg)).float()
    return logits, KVCache(a=torch.stack(new_a), b=torch.stack(new_b),
                           length=torch.tensor(S, dtype=torch.int32, device=dev))
