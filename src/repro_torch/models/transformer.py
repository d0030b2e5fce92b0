"""LM transformer, serving half: dense (qwen3 / smollm / starcoder2) and
MoE + MLA (deepseek v2-lite / v3) parameters, prefill and KV-cache decode,
in PyTorch on one device.

Params layout (the reference's, stacked over layers, so weights carry
across unchanged):
  embed.table (V, d)
  dense_layers.* (n_dense, ...)     -- MoE configs' leading dense FFN layers
  layers.* (n_scan, ...)            -- the homogeneous stack
  final_norm, lm_head.w (d, V)      -- lm_head absent when tie_embeddings
  mtp.{proj, norm_h, norm_e, block} -- deepseek-v3 multi-token prediction

The reference scans over the stacked layers; here a Python loop indexes
them. Decode writes each layer's new K/V into the cache in place.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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

def _ffn(p, x, cfg: LMConfig, moe_layer: bool):
    if moe_layer:
        ff, _ = moe_lib.moe_apply(p["moe"], x, cfg.moe, cfg.act)
        if "shared" in p:
            ff = ff + mlp_apply(p["shared"], x, cfg.act, cfg.glu)
        return ff
    return mlp_apply(p["mlp"], x, cfg.act, cfg.glu)


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
