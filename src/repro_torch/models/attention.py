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

On a device mesh (``runtime.current_mesh()``) each rank holds its part of
the parameters by ``launch/sharding.py::lm_param_specs`` and of the KV
cache by ``kv_cache_specs``; GSPMD partitions the reference's attention
from those specs, and every collective it would insert is written out
here:

  * head tensor parallelism (reference ``launch/sharding.py:75-88``):
    ``wq`` / ``wk`` / ``wv`` (MLA: ``wq_b`` / ``wk_b`` / ``wv_b``) hold the
    rank's heads where the head counts divide ``model``, ``wo`` the
    matching rows; the row-parallel ``wo`` ends in one ``all_reduce`` over
    ``model``. :func:`head_split` is the one place that says which query
    heads a rank holds and which kv head each uses (query head h uses kv
    head h // G, also where ``wq`` is split and ``wk`` / ``wv`` are not);
  * prefill attends over the whole prompt for the rank's heads, then
    returns its cache rows in ``kv_cache_specs``' layout (every kv head,
    the rank's sequence rows; kv heads split over ``model`` are gathered
    first);
  * training runs the prefill's forward under autograd: where the heads
    split, the block's input and every replicated leaf a rank uses only
    for its heads (the norms' scales, ``wk`` / ``wv`` where they do not
    split; MLA's latents) enter the split through ``runtime.enter``, so
    their gradients are summed over ``model``; the row-parallel ``wo``'s
    all_reduce is the exit (its backward is the identity), or, where the
    residual is split over ``model`` (``cfg.shard_carry``), a
    reduce_scatter onto the rank's block of d_model;
  * decode over a sequence-sharded cache is a distributed softmax
    (reference ``attention.py:109-133``): the new token's K/V row goes to
    the rank that owns its position (a masked write on the device), every
    rank runs B6 with ``return_lse`` over its own valid rows, and the
    partials meet by one max and one sum over the sequence axes
    (:func:`combine_shards`). MLA's absorbed decode takes the same max and
    sum over its latent rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import default_device, runtime
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models.layers import (apply_rope, as_dtype, norm_init,
                                      randn_scaled, rmsnorm, row_parallel)

NEG_INF = -1e30


# ------------------------------------------------------------ on a mesh

class SeqShard(NamedTuple):
    """A rank's rows of a KV cache whose sequence dim is split over mesh
    ``axes`` (``kv_cache_specs``): global rows [r0, r0 + rows) of
    ``smax``."""
    axes: tuple
    r0: int
    rows: int
    smax: int


class HeadSplit(NamedTuple):
    """The query heads a rank holds under ``lm_param_specs`` and the
    grouped layout it attends them in: ``n`` heads from global head
    ``h0``, as ``groups`` kv groups of ``group`` query heads;
    ``kv_heads`` names the global kv head of each local group."""
    n: int
    h0: int
    q_split: bool
    kv_split: bool
    groups: int
    group: int
    kv_heads: tuple


def head_split(cfg) -> HeadSplit:
    """The rank's heads on the installed mesh (all of them without one).
    ``wq`` splits where ``model`` divides n_heads, ``wk`` / ``wv`` where it
    divides n_kv (MLA: every per-head weight with n_heads). Query head h
    uses kv head h // G, so the local heads group as: whole groups of G
    where the rank holds a multiple of G; one group of all its heads where
    it holds fewer than G within one kv head (qwen3-8b at ``model`` = 16,
    the reduced GQA configs at (2, 4)); else one head per group."""
    H = cfg.n_heads
    G = 1 if cfg.mla else H // cfg.n_kv
    q_split = runtime.splits(H, "model")
    kv_split = not cfg.mla and runtime.splits(cfg.n_kv, "model")
    n = H // runtime.axis_size("model") if q_split else H
    h0 = runtime.axis_index("model") * n if q_split else 0
    if n % G == 0:
        groups, group = n // G, G
        kv_heads = tuple(h0 // G + j for j in range(groups))
    elif G % n == 0:
        groups, group, kv_heads = 1, n, (h0 // G,)
    else:
        groups, group = n, 1
        kv_heads = tuple((h0 + j) // G for j in range(n))
    return HeadSplit(n, h0, q_split, kv_split, groups, group, kv_heads)


def _gather_heads(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, n, ...) holding the rank's heads → every head, gathered
    over ``model`` (``all_gather`` concatenates dim 0: the head dim moves
    there and back)."""
    return runtime.all_gather(x.movedim(2, 0), "model").movedim(0, 2)


def _cache_rows(t: torch.Tensor, seq: SeqShard) -> torch.Tensor:
    """The rank's rows [r0, r0 + rows) of a prompt's ``t`` (B, S, ...)
    padded with zeros to ``seq.smax``: its block of the prefill cache."""
    S = t.shape[1]
    lo, hi = min(seq.r0, S), min(seq.r0 + seq.rows, S)
    pad = seq.rows - (hi - lo)
    return F.pad(t[:, lo:hi], (0, 0) * (t.dim() - 2) + (0, pad)).contiguous()


def combine_shards(out: torch.Tensor, lse: torch.Tensor,
                   axes) -> torch.Tensor:
    """The softmax over every sequence shard from each shard's normalized
    ``out`` (B, H, G, D) and its ``lse`` (B, H, G): with M the max of the
    lse over ``axes`` and w = exp(lse - M), the sum of w·out over the sum
    of w, in float32 (one max, one sum of out and w packed together),
    cast to ``out``'s dtype once. A shard with no valid row has lse =
    -1e30 and out = 0, so it adds nothing; some shard holds the new token,
    so M is finite."""
    M = runtime.all_reduce(lse.clone(), axes, op="max")
    w = torch.exp(lse - M)[..., None]
    packed = runtime.all_reduce(torch.cat([out.float() * w, w], -1), axes)
    return (packed[..., :-1] / packed[..., -1:]).to(out.dtype)


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
    reads cache_len on the device (a ``meta`` one, a dry run, its
    wrapper). A CPU tensor takes the reference's math verbatim: normalize
    p, cast it to v's dtype, then the PV product."""
    if q.device.type in ("cuda", "meta"):
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


def _write_cache(cache: torch.Tensor, new: torch.Tensor, cache_len,
                 seq: Optional[SeqShard] = None):
    """Write ``new`` (B,S,...) into ``cache`` (B,Smax,...) along dim 1 at
    cache_len, in place and on the device. The start is clamped so the
    update fits, as ``dynamic_update_slice`` clamps it.

    On a sequence shard (``seq``) ``cache`` holds the rank's rows and
    ``new`` one row (decode): it lands only on the rank that owns its
    global position (clamped into the whole cache, as above); every other
    rank writes its own row back unchanged. The owner is chosen on the
    device, so the step never reads cache_len on the host."""
    Smax, S = cache.shape[1], new.shape[1]
    if seq is None:
        start = torch.as_tensor(cache_len, device=cache.device).clamp(
            0, Smax - S)
        idx = start.long() + torch.arange(S, device=cache.device)
        return cache.index_copy_(1, idx, new.to(cache.dtype))
    if S != 1:
        raise ValueError(f"a sequence-sharded cache takes one new row, got {S}")
    local = torch.as_tensor(cache_len, device=cache.device).clamp(
        0, seq.smax - 1) - seq.r0
    owned = (local >= 0) & (local < seq.rows)
    idx = local.clamp(0, seq.rows - 1).long().reshape(1)
    row = torch.where(owned, new.to(cache.dtype), cache.index_select(1, idx))
    return cache.index_copy_(1, idx, row)


def _local_len(cache_len, seq: SeqShard) -> torch.Tensor:
    """The valid rows of the rank's shard after the step's write: the
    global length cache_len + 1 less the shard's start, within [0, rows],
    as one int32 on the device."""
    return (torch.as_tensor(cache_len) + 1 - seq.r0).clamp(
        0, seq.rows).to(torch.int32)


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


def _entered(p, hs: HeadSplit) -> tuple:
    """(the GQA block's weights, how its input enters them) where the
    rank attends for its heads only: every replicated leaf a rank uses in
    part (``wk`` / ``wv`` where they do not split, the norms' scales)
    passes ``runtime.enter`` over ``model``, so its gradient is summed
    there, and so does the input (column-parallel ``wq`` / ``wk`` /
    ``wv``)."""
    if not hs.q_split:
        return p, lambda x: x
    out = dict(p)
    names = ("q_norm", "k_norm") + (() if hs.kv_split else ("wk", "wv"))
    for name in names:
        if name in p:
            out[name] = (runtime.enter(p[name], "model")
                         if isinstance(p[name], torch.Tensor) else
                         {"scale": runtime.enter(p[name]["scale"], "model")})
    return out, lambda x: runtime.enter(x, "model")


def _gqa_qkv(p, x, positions, cfg, hs: Optional[HeadSplit] = None):
    """q (B,S,n,D) for the rank's n query heads, k and v (B,S,Hk,D) for
    the kv heads its ``wk`` / ``wv`` hold (all of them without a mesh)."""
    if hs is not None:
        p, enter = _entered(p, hs)
        x = enter(x)
    B, S, _ = x.shape
    D = cfg.d_head
    q = (x @ p["wq"]).reshape(B, S, -1, D)
    k = (x @ p["wk"]).reshape(B, S, -1, D)
    v = (x @ p["wv"]).reshape(B, S, -1, D)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"]["scale"], cfg.norm_eps)
    # RoPE on the last dim, per head (the reference rotates its grouped q
    # per (Hkv, G) head: the same rotation)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope_heads(k, positions, cfg.rope_theta)
    return q, k, v


def apply_rope_heads(x, positions, theta):
    return apply_rope(x, positions, theta)


def apply_rope_grouped(q, positions, theta):
    B, S, H, G, D = q.shape
    q = apply_rope(q.reshape(B, S, H * G, D), positions, theta)
    return q.reshape(B, S, H, G, D)


def _group_kv(k, v, hs: HeadSplit):
    """The kv heads of the rank's local groups: k / v as they are where
    they hold exactly those (split over ``model`` with the query heads, or
    no split at all), else the groups' heads taken from the whole."""
    if hs.kv_split or hs.kv_heads == tuple(range(k.shape[2])):
        return k, v
    idx = torch.tensor(hs.kv_heads, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _decode_on_shards(q, k, v, cache, cache_len, seq: SeqShard,
                      hs: HeadSplit):
    """One new token (q (B,1,n,D), k / v (B,1,Hk,D)) against the rank's
    rows of a sequence-sharded cache: every head gathered over ``model``
    where the heads split (B × H × D each), the new row written on its
    owner, B6 with ``return_lse`` over the rank's valid rows (possibly
    none), the shards combined over the sequence axes; → the rank's own
    heads (B,1,n,D)."""
    B, _, _, D = q.shape
    if hs.q_split:
        q = _gather_heads(q)
    if hs.kv_split:
        k, v = _gather_heads(k), _gather_heads(v)
    k_cache, v_cache = cache
    _write_cache(k_cache, k, cache_len, seq)
    _write_cache(v_cache, v, cache_len, seq)
    H, Hkv = q.shape[2], k.shape[2]
    out, lse = flash_decode(q[:, 0].reshape(B, Hkv, H // Hkv, D).contiguous(),
                            k_cache, v_cache, _local_len(cache_len, seq),
                            return_lse=True)
    o = combine_shards(out, lse, seq.axes).reshape(B, 1, H, D)
    return o[:, :, hs.h0:hs.h0 + hs.n]


def gqa_forward(p, x, positions, cfg, *, cache=None, cache_len=None,
                seq: Optional[SeqShard] = None, carry: bool = False):
    """cache=None: full causal self-attention (prefill). With cache: decode
    — x is (B,1,d); the new K/V are written into the cache in place at
    cache_len, and (out, (k_cache, v_cache)) is returned.

    On a mesh the rank attends for its heads (:func:`head_split`) and
    ``wo`` is row-parallel; ``seq`` (the cache's sequence shard) makes a
    prefill return its cache rows in ``kv_cache_specs``' layout and a
    decode combine the shards (:func:`_decode_on_shards`). ``carry``: the
    output as the rank's block of d_model over ``model`` (``wo``'s partial
    products reduce-scattered, ``layers.row_parallel``)."""
    B, S, _ = x.shape
    D = cfg.d_head
    hs = head_split(cfg)
    q, k, v = _gqa_qkv(p, x, positions, cfg, hs)
    if cache is None:
        kg, vg = _group_kv(k, v, hs)
        o = chunked_attention(q.reshape(B, S, hs.groups, hs.group, D), kg, vg,
                              causal=True, chunk=min(cfg.attn_chunk, S))
        new_kv = (k, v)
        if seq is not None:
            if hs.kv_split:
                k, v = _gather_heads(k), _gather_heads(v)
            new_kv = (_cache_rows(k, seq), _cache_rows(v, seq))
    elif seq is not None:
        o = _decode_on_shards(q, k, v, cache, cache_len, seq, hs)
        new_kv = cache
    else:
        k_cache, v_cache = cache
        _write_cache(k_cache, k, cache_len)
        _write_cache(v_cache, v, cache_len)
        o = decode_attention(q.reshape(B, S, hs.groups, hs.group, D),
                             k_cache, v_cache, cache_len + S)
        new_kv = (k_cache, v_cache)
    o = o.reshape(B, S, hs.n * D)
    return row_parallel(o, p["wo"], hs.q_split, carry), new_kv


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


def _mla_q(p, x, positions, cfg, enter=lambda t: t):
    """(q_nope, q_rope) (B,S,n,d_nope / d_rope) for the rank's n heads;
    ``enter`` takes the input of the per-head ``wq_b`` / ``wq``."""
    m = cfg.mla
    B, S, _ = x.shape
    dq = m.d_nope + m.d_rope
    if m.q_lora:
        ql = rmsnorm(x @ p["wq_a"], p["q_norm"]["scale"], cfg.norm_eps)
        q = (enter(ql) @ p["wq_b"]).reshape(B, S, -1, dq)
    else:
        q = (enter(x) @ p["wq"]).reshape(B, S, -1, dq)
    q_nope, q_rope = q[..., : m.d_nope], q[..., m.d_nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_decode_on_shards(p, q_nope, q_rope, c_kv, k_rope, cache, cache_len,
                          seq: SeqShard, hs: HeadSplit, cfg, scale):
    """The absorbed decode over the rank's rows of the latent cache
    (reference ``attention.py:273-288``): q_c for the rank's heads,
    gathered over ``model`` with q_rope; scores against the local latent
    rows at their global positions; the softmax's max and sum taken over
    the sequence axes; o_lat summed over them and cut to the rank's heads
    for ``wv_b`` → (B,1,n,v_dim)."""
    m = cfg.mla
    c_cache, r_cache = cache
    _write_cache(c_cache, c_kv, cache_len, seq)
    _write_cache(r_cache, k_rope, cache_len, seq)
    wkb = p["wk_b"].reshape(m.kv_lora, hs.n, m.d_nope)
    q_c = torch.einsum("bshd,lhd->bshl", q_nope, wkb)      # (B,1,n,kv_lora)
    if hs.q_split:
        q_c, q_rope = _gather_heads(q_c), _gather_heads(q_rope)
    s_l = torch.einsum("bshl,bSl->bhsS", q_c.float(), c_cache.float())
    s_r = torch.einsum("bshd,bSd->bhsS", q_rope.float(), r_cache.float())
    s = (s_l + s_r) * scale                                 # (B,H,1,rows)
    pos = seq.r0 + torch.arange(seq.rows, device=s.device)
    s = torch.where((pos < cache_len + 1)[None, None, None], s, NEG_INF)
    mx = runtime.all_reduce(s.amax(-1, keepdim=True), seq.axes, op="max")
    e = torch.exp(s - mx)
    pr = e / runtime.all_reduce(e.sum(-1, keepdim=True), seq.axes)
    o_lat = torch.einsum("bhsS,bSl->bshl", pr.to(c_cache.dtype).float(),
                         c_cache.float())
    o_lat = runtime.all_reduce(o_lat, seq.axes).to(c_cache.dtype)
    wvb = p["wv_b"].reshape(m.kv_lora, hs.n, m.v_dim)
    return torch.einsum("bshl,lhv->bshv", o_lat[:, :, hs.h0:hs.h0 + hs.n],
                        wvb)


def mla_forward(p, x, positions, cfg, *, cache=None, cache_len=None,
                seq: Optional[SeqShard] = None, carry: bool = False):
    """MLA attention. The cache holds the latent (c_kv, k_rope): kv_lora +
    d_rope per token. Decode uses the absorbed form (w_k_b folds into q,
    w_v_b applies after the latent-space attention); the latent caches are
    written in place at cache_len. On a mesh the rank computes its heads
    (the latent projections are replicated) and ``wo`` is row-parallel;
    ``seq`` and ``carry`` as in :func:`gqa_forward`."""
    m = cfg.mla
    B, S, _ = x.shape
    hs = head_split(cfg)
    H = hs.n
    scale = 1.0 / np.sqrt(m.d_nope + m.d_rope)

    kv = x @ p["wkv_a"]                                     # (B,S,kv_lora+d_rope)
    c_kv = rmsnorm(kv[..., : m.kv_lora], p["kv_norm"]["scale"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, m.kv_lora:], positions,
                        cfg.rope_theta)[:, :, 0]

    # the latents are replicated over ``model`` and feed the rank's heads
    # (the per-head weights split with them): they enter the split
    enter = ((lambda t: runtime.enter(t, "model")) if hs.q_split
             else (lambda t: t))
    q_nope, q_rope = _mla_q(p, x, positions, cfg, enter)  # (B,S,H,d_nope/d_rope)

    if cache is None:
        # prefill: expand per-head k, v from the latent
        c_in = enter(c_kv)
        k_nope = (c_in @ p["wk_b"]).reshape(B, S, H, m.d_nope)
        v = (c_in @ p["wv_b"]).reshape(B, S, H, m.v_dim)
        q = torch.cat([q_nope, q_rope], -1)[:, :, :, None]  # (B,S,H,1,dq)
        k = torch.cat([k_nope, enter(k_rope)[:, :, None].expand(
            B, S, H, m.d_rope)], -1)
        o = chunked_attention(q, k, v, causal=True,
                              chunk=min(cfg.attn_chunk, S), scale=scale)
        o = o[:, :, :, 0]                                   # (B,S,H,v_dim)
        new_cache = (c_kv, k_rope) if seq is None else \
            (_cache_rows(c_kv, seq), _cache_rows(k_rope, seq))
    elif seq is not None:
        o = _mla_decode_on_shards(p, q_nope, q_rope, c_kv, k_rope, cache,
                                  cache_len, seq, hs, cfg, scale)
        new_cache = cache
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
    return row_parallel(o, p["wo"], hs.q_split, carry), new_cache


def attn_init(generator, cfg, dtype, device=None):
    return (mla_init(generator, cfg, dtype, device) if cfg.mla
            else gqa_init(generator, cfg, dtype, device))


def attn_forward(p, x, positions, cfg, *, cache=None, cache_len=None,
                 seq: Optional[SeqShard] = None, carry: bool = False):
    fwd = mla_forward if cfg.mla else gqa_forward
    return fwd(p, x, positions, cfg, cache=cache, cache_len=cache_len,
               seq=seq, carry=carry)
