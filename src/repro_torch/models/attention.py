"""Attention: GQA + MLA, with memory-efficient (online-softmax) prefill and
KV-cache decode, in PyTorch.

Layouts (the reference's):
  q: (B, Sq, Hkv, G, D)   grouped — G = n_heads // n_kv (no KV repeat)
  k: (B, Sk, Hkv, D)
  v: (B, Sk, Hkv, Dv)

Training and prefill never materialize (Sq, Sk): a loop over KV chunks
carries a running (m, l, acc), the reference's ``lax.scan`` written out
(each chunk checkpointed where autograd records, as there). Single-token
GQA decode on a CUDA tensor runs the hand-written ``flash_decode`` kernel;
on a CPU tensor it is the reference's math. MLA's expanded prefill and
absorbed decode are plain PyTorch, as in the reference (no kernel covers
them, and Dv differs from D there).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import default_device
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models.layers import (apply_rope, as_dtype, norm_init,
                                      randn_scaled, rmsnorm)

NEG_INF = -1e30


def _chunk_scores(q, k, scale):
    # q (B,Sq,H,G,D) k (B,C,H,D) -> (B,H,G,Sq,C), float32
    return torch.einsum("bqhgd,bchd->bhgqc", q.float(), k.float()) * scale


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int, q_offset=0,
                      scale: Optional[float] = None,
                      q_blocks: int = 4) -> torch.Tensor:
    """Online-softmax attention, O(Sq/q_blocks * chunk) live memory.

    q (B,Sq,H,G,D); k,v (B,Sk,H,D/Dv). q_offset: position of q[0] within the
    kv axis (chunked prefill). Returns (B,Sq,H,G,Dv).

    Causal inputs are processed in ``q_blocks`` row blocks, each scanning
    only the KV chunks at or below its diagonal (the reference's causal
    block skipping)."""
    B, Sq, H, G, D = q.shape
    Sk = k.shape[1]
    if (causal and q_blocks > 1 and Sq == Sk and q_offset == 0
            and Sq % q_blocks == 0 and Sq // q_blocks >= chunk):
        qb = Sq // q_blocks
        outs = []
        for i in range(q_blocks):
            hi = (i + 1) * qb
            outs.append(_chunked_attention(
                q[:, i * qb: hi], k[:, :hi], v[:, :hi],
                causal=True, chunk=chunk, q_offset=i * qb, scale=scale))
        return torch.cat(outs, dim=1)
    return _chunked_attention(q, k, v, causal=causal, chunk=chunk,
                              q_offset=q_offset, scale=scale)


def _chunked_attention(q, k, v, *, causal, chunk, q_offset=0, scale=None):
    B, Sq, H, G, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    n_chunks = -(-Sk // chunk)
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)

    def body(m, l, acc, q, k_i, v_i, k0: int):
        s = _chunk_scores(q, k_i, scale)                         # (B,H,G,Sq,C)
        if causal:
            k_pos = k0 + torch.arange(k_i.shape[1], device=dev)
            valid = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhgqc,bchd->bhgqd", p.to(v_i.dtype).float(),
                          v_i.float())
        return m_new, l, acc * alpha[..., None] + pv

    # where autograd records, each chunk is checkpointed as in the
    # reference: the backward recomputes its (Sq, C) score block instead
    # of keeping one per chunk
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    m = torch.full((B, H, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, G, Sq, Dv), dtype=torch.float32, device=dev)
    for idx in range(n_chunks):
        # the reference pads the last chunk; its padded rows are masked,
        # so the slice computes the same sums
        k_i = k[:, idx * chunk: (idx + 1) * chunk]
        v_i = v[:, idx * chunk: (idx + 1) * chunk]
        if remat:
            m, l, acc = checkpoint(body, m, l, acc, q, k_i, v_i, idx * chunk,
                                   use_reentrant=False)
        else:
            m, l, acc = body(m, l, acc, q, k_i, v_i, idx * chunk)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)                # (B,Sq,H,G,Dv)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode. q (B,1,H,G,D); caches (B,Smax,H,D/Dv);
    cache_len: number of valid cache positions (an int or a 0-d int tensor
    on q's device) → (B,1,H,G,Dv) in q's dtype.

    A CUDA tensor runs the ``flash_decode`` kernel on ``q[:, 0]``, which
    reads cache_len on the device. A CPU tensor takes the reference's math
    verbatim: normalize p, cast it to v's dtype, then the PV product."""
    if q.device.type == "cuda":
        if q.shape[1] != 1:
            raise ValueError(f"decode takes one query token, got {q.shape[1]}")
        return flash_decode(q[:, 0].contiguous(), k_cache, v_cache, cache_len,
                            scale)[:, None]
    B, _, H, G, D = q.shape
    Smax = k_cache.shape[1]
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    s = torch.einsum("bqhgd,bshd->bhgqs", q.float(), k_cache.float()) * scale
    mask = torch.arange(Smax, device=q.device) < cache_len
    s = torch.where(mask[None, None, None, None, :], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgqs,bshd->bhgqd", (p / l).to(v_cache.dtype).float(),
                       v_cache.float())
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)                # (B,1,H,G,Dv)


def _write_cache(cache: torch.Tensor, new: torch.Tensor, cache_len):
    """Write ``new`` (B,S,...) into ``cache`` (B,Smax,...) along dim 1 at
    cache_len, in place and on the device. The start is clamped so the
    update fits, as ``dynamic_update_slice`` clamps it."""
    Smax, S = cache.shape[1], new.shape[1]
    start = torch.as_tensor(cache_len, device=cache.device).clamp(0, Smax - S)
    idx = start.long() + torch.arange(S, device=cache.device)
    return cache.index_copy_(1, idx, new.to(cache.dtype))


# ---------------------------------------------------------------- GQA block

def gqa_init(generator: torch.Generator, cfg, dtype, device=None) -> dict:
    dev = default_device(device)
    dt = as_dtype(dtype)
    d, Hq, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    s = 1.0 / np.sqrt(d)
    p = {"wq": randn_scaled(generator, (d, Hq * D), s, dev).to(dt),
         "wk": randn_scaled(generator, (d, Hkv * D), s, dev).to(dt),
         "wv": randn_scaled(generator, (d, Hkv * D), s, dev).to(dt),
         "wo": randn_scaled(generator, (Hq * D, d), 1.0 / np.sqrt(Hq * D),
                            dev).to(dt)}
    if cfg.qk_norm:
        p["q_norm"] = norm_init(D, "rmsnorm", dt, dev)
        p["k_norm"] = norm_init(D, "rmsnorm", dt, dev)
    return p


def _gqa_qkv(p, x, positions, cfg):
    B, S, _ = x.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv, cfg.d_head
    G = Hq // Hkv
    q = (x @ p["wq"]).reshape(B, S, Hkv, G, D)
    k = (x @ p["wk"]).reshape(B, S, Hkv, D)
    v = (x @ p["wv"]).reshape(B, S, Hkv, D)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"]["scale"], cfg.norm_eps)
    # RoPE on the last dim; the grouped q rotates per (Hkv, G) head
    q = apply_rope_grouped(q, positions, cfg.rope_theta)
    k = apply_rope_heads(k, positions, cfg.rope_theta)
    return q, k, v


def apply_rope_heads(x, positions, theta):
    return apply_rope(x, positions, theta)


def apply_rope_grouped(q, positions, theta):
    B, S, H, G, D = q.shape
    q = apply_rope(q.reshape(B, S, H * G, D), positions, theta)
    return q.reshape(B, S, H, G, D)


def gqa_forward(p, x, positions, cfg, *, cache=None, cache_len=None):
    """cache=None: full causal self-attention (prefill). With cache: decode
    — x is (B,1,d); the new K/V are written into the cache in place at
    cache_len, and (out, (k_cache, v_cache)) is returned."""
    B, S, _ = x.shape
    q, k, v = _gqa_qkv(p, x, positions, cfg)
    if cache is None:
        o = chunked_attention(q, k, v, causal=True, chunk=min(cfg.attn_chunk, S))
        new_kv = (k, v)
    else:
        k_cache, v_cache = cache
        _write_cache(k_cache, k, cache_len)
        _write_cache(v_cache, v, cache_len)
        o = decode_attention(q, k_cache, v_cache, cache_len + S)
        new_kv = (k_cache, v_cache)
    o = o.reshape(B, S, cfg.n_heads * cfg.d_head)
    return o @ p["wo"], new_kv


# ---------------------------------------------------------------- MLA block

def mla_init(generator: torch.Generator, cfg, dtype, device=None) -> dict:
    dev = default_device(device)
    dt = as_dtype(dtype)
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dq = m.d_nope + m.d_rope
    s = 1.0 / np.sqrt(d)
    p = {}
    if m.q_lora:
        p["wq_a"] = randn_scaled(generator, (d, m.q_lora), s, dev).to(dt)
        p["q_norm"] = norm_init(m.q_lora, "rmsnorm", dt, dev)
        p["wq_b"] = randn_scaled(generator, (m.q_lora, H * dq),
                                 1.0 / np.sqrt(m.q_lora), dev).to(dt)
    else:
        p["wq"] = randn_scaled(generator, (d, H * dq), s, dev).to(dt)
    p["wkv_a"] = randn_scaled(generator, (d, m.kv_lora + m.d_rope), s,
                              dev).to(dt)
    p["kv_norm"] = norm_init(m.kv_lora, "rmsnorm", dt, dev)
    p["wk_b"] = randn_scaled(generator, (m.kv_lora, H * m.d_nope),
                             1.0 / np.sqrt(m.kv_lora), dev).to(dt)
    p["wv_b"] = randn_scaled(generator, (m.kv_lora, H * m.v_dim),
                             1.0 / np.sqrt(m.kv_lora), dev).to(dt)
    p["wo"] = randn_scaled(generator, (H * m.v_dim, d),
                           1.0 / np.sqrt(H * m.v_dim), dev).to(dt)
    return p


def _mla_q(p, x, positions, cfg):
    m = cfg.mla
    B, S, _ = x.shape
    H, dq = cfg.n_heads, m.d_nope + m.d_rope
    if m.q_lora:
        ql = rmsnorm(x @ p["wq_a"], p["q_norm"]["scale"], cfg.norm_eps)
        q = (ql @ p["wq_b"]).reshape(B, S, H, dq)
    else:
        q = (x @ p["wq"]).reshape(B, S, H, dq)
    q_nope, q_rope = q[..., : m.d_nope], q[..., m.d_nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def mla_forward(p, x, positions, cfg, *, cache=None, cache_len=None):
    """MLA attention. The cache holds the latent (c_kv, k_rope): kv_lora +
    d_rope per token. Decode uses the absorbed form (w_k_b folds into q,
    w_v_b applies after the latent-space attention); the latent caches are
    written in place at cache_len."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    scale = 1.0 / np.sqrt(m.d_nope + m.d_rope)

    kv = x @ p["wkv_a"]                                     # (B,S,kv_lora+d_rope)
    c_kv = rmsnorm(kv[..., : m.kv_lora], p["kv_norm"]["scale"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, m.kv_lora:], positions,
                        cfg.rope_theta)[:, :, 0]

    q_nope, q_rope = _mla_q(p, x, positions, cfg)           # (B,S,H,d_nope/d_rope)

    if cache is None:
        # prefill: expand per-head k, v from the latent
        k_nope = (c_kv @ p["wk_b"]).reshape(B, S, H, m.d_nope)
        v = (c_kv @ p["wv_b"]).reshape(B, S, H, m.v_dim)
        q = torch.cat([q_nope, q_rope], -1)[:, :, :, None]  # (B,S,H,1,dq)
        k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, m.d_rope)],
                      -1)
        o = chunked_attention(q, k, v, causal=True,
                              chunk=min(cfg.attn_chunk, S), scale=scale)
        o = o[:, :, :, 0]                                   # (B,S,H,v_dim)
        new_cache = (c_kv, k_rope)
    else:
        c_cache, r_cache = cache                            # (B,Smax,kv_lora),(B,Smax,d_rope)
        _write_cache(c_cache, c_kv, cache_len)
        _write_cache(r_cache, k_rope, cache_len)
        Smax = c_cache.shape[1]
        wkb = p["wk_b"].reshape(m.kv_lora, H, m.d_nope)
        q_c = torch.einsum("bshd,lhd->bshl", q_nope, wkb)   # (B,1,H,kv_lora)
        s_l = torch.einsum("bshl,bSl->bhsS", q_c.float(), c_cache.float())
        s_r = torch.einsum("bshd,bSd->bhsS", q_rope.float(), r_cache.float())
        s = (s_l + s_r) * scale                             # (B,H,1,Smax)
        mask = torch.arange(Smax, device=x.device) < (cache_len + S)
        s = torch.where(mask[None, None, None], s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhsS,bSl->bshl", pr.to(c_cache.dtype), c_cache)
        wvb = p["wv_b"].reshape(m.kv_lora, H, m.v_dim)
        o = torch.einsum("bshl,lhv->bshv", o_lat, wvb)      # (B,1,H,v_dim)
        new_cache = (c_cache, r_cache)
    o = o.reshape(B, S, H * m.v_dim).to(x.dtype)
    return o @ p["wo"], new_cache


def attn_init(generator, cfg, dtype, device=None):
    return (mla_init(generator, cfg, dtype, device) if cfg.mla
            else gqa_init(generator, cfg, dtype, device))


def attn_forward(p, x, positions, cfg, *, cache=None, cache_len=None):
    if cfg.mla:
        return mla_forward(p, x, positions, cfg, cache=cache, cache_len=cache_len)
    return gqa_forward(p, x, positions, cfg, cache=cache, cache_len=cache_len)
