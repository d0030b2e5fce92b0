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

On a device mesh (``runtime.current_mesh()``) every rank runs these
functions on its part of the parameters (``launch/sharding.py::
lm_param_specs``: the embedding a ``RowShard`` of the vocab, attention
heads and FFN widths over ``model`` where they divide, the experts over
``model``), of the KV cache (``kv_cache_specs``: the sequence over
``model``, or over every axis where the batch does not split) and of the
batch (its block over the data axes, or the batch whole with
``batch_axes=()``). The logits of the vocab-split head are gathered over
``model``. Training on a mesh runs :func:`hidden_states` under autograd
and :func:`lm_loss` over the vocab-split head (:func:`chunked_xent`), the
gradients by ``runtime``'s rule. Where ``cfg.shard_carry`` (deepseek-v3)
the residual between a training forward's blocks is the rank's block of
d_model over ``model`` (:func:`_block`); serving keeps it whole. A ZeRO-3
parameter (``fsdp_params``: ``sharding.zero_specs(..., gathered=True)``)
is a ``runtime.DataShard``, gathered over ``data`` where it is used: a
layer's at the top of its block, inside the remat.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import default_device, runtime
from repro_torch import tree as tree_lib
from repro_torch.configs.base import LMConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (as_dtype, carry_block, carry_whole,
                                       mlp_apply, mlp_init, norm_apply,
                                       norm_init, randn_scaled)
from repro_torch.sparse.sharded import sharded_lookup


def _dtype(cfg: LMConfig) -> torch.dtype:
    return as_dtype(cfg.param_dtype)


def _ffn_width(cfg: LMConfig, moe_layer: bool) -> int:
    """d_ff of a block's dense FFN: the shared experts' in a MoE layer,
    else the dense layers'."""
    if moe_layer:
        return cfg.moe.n_shared * cfg.moe.d_ff_expert
    if cfg.moe is not None:
        return cfg.moe.dense_d_ff or cfg.d_ff
    return cfg.d_ff


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
                                   _ffn_width(cfg, True), cfg.d_model,
                                   cfg.glu, dt, device)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, _ffn_width(cfg, False),
                            cfg.d_model, cfg.glu, dt, device)
    return p


def _layer(stacked, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    if isinstance(stacked, runtime.DataShard):
        return stacked.layer(i)
    return stacked[i]


def _depth(stacked) -> int:
    """The layers of a stacked parameter tree."""
    return tree_lib.leaves(stacked)[0].shape[0]


def part_generator(seed: int, *path, device=None) -> torch.Generator:
    """A generator on ``device`` (the host's for ``meta``, which draws
    nothing) seeded from ``seed`` and a part's path (names and layer
    indices), the same in every process."""
    dev = default_device(device)
    h = hashlib.sha256(repr((int(seed),) + path).encode()).digest()
    return torch.Generator(device="cpu" if dev.type == "meta" else dev) \
        .manual_seed(int.from_bytes(h[:8], "little") >> 1)


def stack_layers(draw_layer, n: int):
    """The trees ``draw_layer(0..n-1)`` stacked leaf by leaf into tensors
    allocated once: one layer's tree is alive at a time beside the
    stack."""
    layer = draw_layer(0)
    out = tree_lib.tree_map(lambda t: t.new_empty((n, *t.shape)), layer)
    for i in range(n):
        if i:
            layer = draw_layer(i)
        tree_lib.tree_map(lambda o, t: o[i].copy_(t), out, layer)
        del layer
    return out


def init(generator: torch.Generator, cfg: LMConfig, device=None,
         mesh=None, specs=None) -> dict:
    """Random parameters in the reference's layout, drawn part by part:
    the embedding, the head, the MTP block and each layer of each stack
    from its own generator (:func:`part_generator`, seeded from
    ``generator``'s initial seed, the part's path and the layer). With
    ``mesh=None`` every part is kept whole; on a live ``mesh`` only the
    rank's part of each layer is kept (``specs``, by default
    ``lm_param_specs``; the embedding a ``runtime.RowShard``, a ZeRO-3
    leaf a ``runtime.DataShard``: ``sharding.held``), so no rank ever
    holds a whole stacked leaf, and every rank holds its part of the
    values drawn whole."""
    from repro_torch.launch.sharding import (P, held, local_part,
                                             lm_param_specs)
    dev = default_device(device)
    dt = _dtype(cfg)
    seed = generator.initial_seed()

    def gen(*path):
        return part_generator(seed, *path, device=dev)

    if mesh is None:
        specs = None
    elif specs is None:
        specs = lm_param_specs(init(generator, cfg, device=torch.device(
            "meta")), cfg, mesh)

    def part(t, sp):
        """The rank's part, copied out of the whole drawn part where it
        is smaller (a view would keep the whole alive)."""
        got = local_part(t, sp, mesh)
        return got.clone() if got.numel() < t.numel() else got

    def keep(tree, name):
        if specs is None:
            return tree
        return tree_lib.tree_map(
            lambda t, sp: held(part(t, sp), sp, mesh, t.shape), tree,
            specs[name])

    def stack(name, moe_layer, n):
        def draw(i):
            layer = _layer_init(gen(name, i), cfg, moe_layer, dev)
            if specs is None:
                return layer
            return tree_lib.tree_map(
                lambda t, sp: local_part(t, P(*sp[1:]), mesh), layer,
                specs[name])
        out = stack_layers(draw, n)
        if specs is None:
            return out
        return tree_lib.tree_map(
            lambda t, sp: held(t, sp, mesh, t.shape), out, specs[name])

    n_dense = cfg.moe.n_dense_layers if cfg.moe else 0
    params: dict = {
        "embed": keep({"table": randn_scaled(gen("embed"), (cfg.vocab,
                                                            cfg.d_model),
                                             0.02, dev).to(dt)}, "embed"),
        "final_norm": keep(norm_init(cfg.d_model, cfg.norm, dt, dev),
                           "final_norm"),
    }
    if n_dense:
        params["dense_layers"] = stack("dense_layers", False, n_dense)
    params["layers"] = stack("layers", cfg.moe is not None,
                             cfg.n_layers - n_dense)
    if not cfg.tie_embeddings:
        params["lm_head"] = keep({"w": randn_scaled(
            gen("lm_head"), (cfg.d_model, cfg.vocab),
            1.0 / np.sqrt(cfg.d_model), dev).to(dt)}, "lm_head")
    if cfg.mtp:
        g = gen("mtp")
        params["mtp"] = keep({
            "proj": randn_scaled(g, (2 * cfg.d_model, cfg.d_model),
                                 1.0 / np.sqrt(2 * cfg.d_model), dev).to(dt),
            "norm_h": norm_init(cfg.d_model, cfg.norm, dt, dev),
            "norm_e": norm_init(cfg.d_model, cfg.norm, dt, dev),
            "block": _layer_init(g, cfg, cfg.moe is not None, dev),
        }, "mtp")
    return params


# ----------------------------------------------------------------- blocks

def _ffn_aux(p, x, cfg: LMConfig, moe_layer: bool, batch_axes=None,
             carry: bool = False):
    """The block's feed-forward and its MoE load-balance aux (0 if dense).
    On a mesh the dense FFN and the shared experts are tensor-parallel
    over ``model`` where their d_ff divides it; ``batch_axes`` says the
    MoE how ``x``'s tokens lie (``moe.moe_apply``); ``carry``: the output
    as the rank's block of d_model over ``model``."""
    split = runtime.splits(_ffn_width(cfg, moe_layer), "model")
    if moe_layer:
        ff, aux = moe_lib.moe_apply(p["moe"], x, cfg.moe, cfg.act,
                                    batch_axes=batch_axes, carry=carry)
        if "shared" in p:
            ff = ff + mlp_apply(p["shared"], x, cfg.act, cfg.glu, split,
                                carry)
        return ff, aux
    return (mlp_apply(p["mlp"], x, cfg.act, cfg.glu, split, carry),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _ffn(p, x, cfg: LMConfig, moe_layer: bool, batch_axes=None):
    return _ffn_aux(p, x, cfg, moe_layer, batch_axes)[0]


def _split_carry(cfg: LMConfig) -> bool:
    """True where the residual between blocks is the rank's block of
    d_model over ``model``: ``cfg.shard_carry`` on a mesh whose ``model``
    axis splits d_model."""
    return cfg.shard_carry and runtime.splits(cfg.d_model, "model")


def _block(p, x, positions, cfg: LMConfig, moe_layer: bool):
    """Pre-norm transformer block. Returns (x, aux_loss). Its ZeRO-3
    leaves are gathered first (``runtime.gathered``): under remat they
    live for the block's forward and are gathered again in its
    recompute, as GSPMD re-gathers them.

    The reference pins the residual's layout here with ``runtime.shard``
    (``transformer.py:93-98,111-114``): whole over ``model``, or, where
    ``cfg.shard_carry`` (deepseek-v3), split over ``model`` on d_model,
    so that the layer inputs its remat saves take d/16 a device. The port
    holds the same layout (:func:`_split_carry`): the block takes and
    returns the rank's block of d_model (a whole input, the embedding's
    or the MTP projection's, is cut to its block); each norm reads the
    residual gathered over ``model`` (``layers.carry_whole``), and the
    row-parallel outputs of attention and of the FFN / MoE land on the
    rank's block by a reduce_scatter (an all_to_all for the MoE's rows)
    where the whole residual takes an all_reduce. The tensor a remat
    saves between layers is then (B_local, S, d / model). A sharding
    constraint changes a layout, never a value."""
    p = runtime.gathered(p)
    carry = _split_carry(cfg)
    whole = carry_whole if carry else (lambda t: t)
    x_in = x if x.shape[-1] == cfg.d_model else carry_whole(x)
    if carry and x is x_in:             # a whole input, cut to its block
        x = carry_block(x)
    h, _ = attn.attn_forward(
        p["attn"], norm_apply(x_in, p["ln1"], cfg.norm, cfg.norm_eps),
        positions, cfg, carry=carry)
    x = x + h
    ff, aux = _ffn_aux(p, norm_apply(whole(x), p["ln2"], cfg.norm,
                                     cfg.norm_eps), cfg, moe_layer,
                       carry=carry)
    return x + ff, aux


def _block_decode(p, x, positions, cfg: LMConfig, moe_layer: bool, cache,
                  cache_len, seq=None, batch_axes=None):
    h, new_cache = attn.attn_forward(
        p["attn"], norm_apply(x, p["ln1"], cfg.norm, cfg.norm_eps),
        positions, cfg, cache=cache, cache_len=cache_len, seq=seq)
    x = x + h
    ff_in = norm_apply(x, p["ln2"], cfg.norm, cfg.norm_eps)
    return x + _ffn(p, ff_in, cfg, moe_layer, batch_axes), new_cache


def _head_w(params, cfg: LMConfig):
    """The head (d, V); on a mesh the rank's vocab columns (a ZeRO-3
    head gathered over ``data``): the tied head reads the embedding's
    local rows transposed."""
    if cfg.tie_embeddings:
        table = runtime.gathered(params["embed"])["table"]
        return (table.local if isinstance(table, runtime.RowShard)
                else table).T
    return runtime.gathered(params["lm_head"])["w"]


def _logits(params, x, cfg: LMConfig):
    """Last-position logits (B, V) in float32. A vocab-split head (spec
    ``P(None, "model")``) gives the rank's columns, gathered over
    ``model`` into the reference's ``batched_spec(mesh, (B, V))``."""
    logits = (x[:, -1] @ _head_w(params, cfg)).float()
    if logits.shape[-1] != cfg.vocab:
        logits = runtime.all_gather(logits.T, "model").T.contiguous()
    return logits


def _seq_axes(batch_axes) -> tuple:
    """The mesh axes ``kv_cache_specs`` splits the cache's sequence over:
    ``model`` where the batch is split over the data axes, every axis
    where it is whole (``batch_axes=()``)."""
    whole = batch_axes is not None and not runtime.mesh_axes(batch_axes)
    return runtime.mesh_axes(("pod", "data", "model") if whole else "model")


def _seq_shard(rows: int, batch_axes) -> Optional[attn.SeqShard]:
    """The rank's shard of a cache of ``rows`` rows a rank (None without
    a mesh)."""
    if runtime.current_mesh() is None:
        return None
    axes = _seq_axes(batch_axes)
    return attn.SeqShard(axes, runtime.shard_index(axes) * rows, rows,
                         rows * runtime.axes_size(axes))


def hidden_states(params, tokens, cfg: LMConfig):
    """Embed + all blocks + final norm. tokens (B,S) → (B,S,d), aux."""
    B, S = tokens.shape
    x = sharded_lookup(runtime.gathered(params["embed"])["table"], tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if "dense_layers" in params:
        for i in range(_depth(params["dense_layers"])):
            x, _ = _block(_layer(params["dense_layers"], i), x, positions, cfg,
                          moe_layer=False)
    moe_layer = cfg.moe is not None

    def body(p, x):
        return _block(p, x, positions, cfg, moe_layer)

    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(_depth(params["layers"])):
        p = _layer(params["layers"], i)
        if remat:
            x, aux = checkpoint(body, p, x, use_reentrant=False)
        else:
            x, aux = body(p, x)
        aux_total = aux_total + aux
    if _split_carry(cfg):
        x = carry_whole(x)
    x = norm_apply(x, runtime.gathered(params["final_norm"]), cfg.norm,
                   cfg.norm_eps)
    return x, aux_total


def chunked_xent(x, head_w, labels, mask, chunk: int = 512, *,
                 vocab: Optional[int] = None):
    """Cross-entropy without materializing (B,S,V): a loop over S chunks,
    each chunk's logits in float32. Mean over the positions ``mask``
    keeps.

    On a mesh: ``head_w`` holding the rank's columns of a ``vocab``-wide
    head (split over ``model``) takes the reference's vocab-split form
    (``transformer.py:170-204``): a detached local max and its max over
    ``model``, the sum of exp(logits - max) and the gold logit (a masked
    sum over the rank's columns, not a gather over a split vocab) each
    summed over ``model``, and ``x`` entering the split. ``x`` is the
    rank's block of a batch split over the mesh's data axes: the sums of
    the loss and the count are summed over them, so every rank holds the
    global mean."""
    B, S, d = x.shape
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    split = (runtime.current_mesh() is not None and vocab is not None
             and head_w.shape[-1] != vocab)
    if split:
        x = runtime.enter(x, "model")
        v0 = runtime.axis_index("model") * head_w.shape[-1]
        cols = v0 + torch.arange(head_w.shape[-1], device=x.device)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        at = slice(i * chunk, (i + 1) * chunk)
        xi, li, mi = x[:, at], labels[:, at], mask[:, at]
        logits = (xi @ head_w).float()                       # (B,c,V)
        if split:
            m = runtime.all_reduce(logits.detach().amax(-1), "model",
                                   op="max")
            lse = m + torch.log(runtime.all_reduce(
                torch.exp(logits - m[..., None]).sum(-1), "model"))
            gold = runtime.all_reduce(torch.where(
                cols == li[..., None], logits, 0.0).sum(-1), "model")
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, li[..., None].long())[..., 0]
        nll = (lse - gold) * mi
        tot = tot + nll.sum()
        cnt = cnt + mi.sum()
    if runtime.current_mesh() is not None:
        tot, cnt = runtime.all_reduce(torch.stack([tot, cnt]),
                                      runtime.batch_axes())
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, tokens, cfg: LMConfig, aux_weight: float = 1e-3):
    """Next-token loss (+MTP loss for deepseek-v3, + aux_weight x the MoE
    load-balance aux). tokens (B,S). On a mesh ``tokens`` are the rank's
    block of the batch split over the mesh's data axes and the loss is
    the global batch's mean on every rank (:func:`chunked_xent`); the MoE
    aux is the mesh's (``moe.py``). A ZeRO-3 embedding is gathered once
    for both of its lookups; a ZeRO-3 weight that autograd saves is
    gathered again by the backward (``runtime.regathered``)."""
    with runtime.regathered():
        return _lm_loss(params, tokens, cfg, aux_weight)


def _lm_loss(params, tokens, cfg: LMConfig, aux_weight: float):
    params = {**params, "embed": runtime.gathered(params["embed"])}
    x, aux = hidden_states(params, tokens, cfg)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1] * 0], dim=1)
    ones = torch.ones(tokens[:, 1:].shape, dtype=torch.float32,
                      device=tokens.device)
    mask = F.pad(ones, (0, 1))
    head_w = _head_w(params, cfg)
    loss = chunked_xent(x, head_w, labels, mask, vocab=cfg.vocab)
    if cfg.mtp and "mtp" in params:
        # MTP depth 1: combine h_t with the embedding of token t+1, one
        # extra block, predict token t+2 (deepseek-v3 §2.2)
        mp = runtime.gathered(params["mtp"])
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
        if _split_carry(cfg):
            h = carry_whole(h)
        labels2 = torch.roll(tokens, -2, dims=1)
        mask2 = F.pad(ones[:, 1:], (0, 2))
        loss = loss + 0.3 * chunked_xent(h, head_w, labels2, mask2,
                                         vocab=cfg.vocab)
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


def decode_step(params, cache: KVCache, tokens, cfg: LMConfig, *,
                batch_axes=None):
    """One decode step: tokens (B,1) + cache → (logits (B,V) float32, cache
    with length + 1).

    Unlike the reference, which returns new cache arrays, the new K/V are
    written into ``cache.a`` / ``cache.b`` in place (no copy of the whole
    cache per step): the returned cache shares those tensors, and the one
    passed in sees the writes. The length stays on the device, so a step
    never waits on the host.

    On a mesh ``cache`` is the rank's (its rows of the sequence, its
    block of the batch) and ``tokens`` its block of the batch over the
    data axes, or the batch whole with ``batch_axes=()`` (then the
    sequence is split over every axis, ``kv_cache_specs``' batch-1 case);
    the length is the global one."""
    B = tokens.shape[0]
    x = sharded_lookup(params["embed"]["table"], tokens)
    positions = cache.length.expand(B, 1)
    seq = _seq_shard(cache.a.shape[2], batch_axes)
    (da, db), (sa, sb), n_dense = _split_cache(cache, cfg)
    for i in range(n_dense):
        x, _ = _block_decode(_layer(params["dense_layers"], i), x, positions,
                             cfg, False, (da[i], db[i]), cache.length, seq,
                             batch_axes)
    moe_layer = cfg.moe is not None
    for i in range(sa.shape[0]):
        x, _ = _block_decode(_layer(params["layers"], i), x, positions, cfg,
                             moe_layer, (sa[i], sb[i]), cache.length, seq,
                             batch_axes)
    x = norm_apply(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return _logits(params, x, cfg), cache._replace(length=cache.length + 1)


def prefill(params, tokens, cfg: LMConfig, smax: int, *, batch_axes=None):
    """Prefill: tokens (B,S) → (last-position logits (B,V) float32, KVCache
    padded to smax). On a mesh (``batch_axes`` as in :func:`decode_step`)
    the cache comes back as the rank's part: its rows of the smax
    positions, every kv head."""
    B, S = tokens.shape
    x = sharded_lookup(params["embed"]["table"], tokens)
    dev = x.device
    positions = torch.arange(S, device=dev).expand(B, S)
    n_dense = cfg.moe.n_dense_layers if cfg.moe else 0
    seq = None
    if runtime.current_mesh() is not None:
        n = runtime.axes_size(_seq_axes(batch_axes))
        if smax % n:
            raise ValueError(f"a cache of {smax} rows does not split over "
                             f"{n} sequence shards")
        seq = _seq_shard(smax // n, batch_axes)

    def pad_kv(t):
        if seq is not None:              # already the rank's rows
            return t
        return torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 2) + (0, smax - S))

    # the stacks are allocated at the first layer and filled layer by
    # layer (no second copy of the cache for a stack of per-layer pieces)
    cache_a = cache_b = None
    n_scan = _depth(params["layers"])
    for i in range(n_dense + n_scan):
        dense = i < n_dense
        p = _layer(params["dense_layers"] if dense else params["layers"],
                   i if dense else i - n_dense)
        h, kv = attn.attn_forward(
            p["attn"], norm_apply(x, p["ln1"], cfg.norm, cfg.norm_eps),
            positions, cfg, seq=seq)
        x = x + h
        ff_in = norm_apply(x, p["ln2"], cfg.norm, cfg.norm_eps)
        x = x + _ffn(p, ff_in, cfg, not dense and cfg.moe is not None,
                     batch_axes)
        ka, kb = pad_kv(kv[0]), pad_kv(kv[1])
        if cache_a is None:
            L = n_dense + n_scan
            cache_a = ka.new_empty((L, *ka.shape))
            cache_b = kb.new_empty((L, *kb.shape))
        cache_a[i].copy_(ka)
        cache_b[i].copy_(kb)
        del kv, ka, kb
    x = norm_apply(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return _logits(params, x, cfg), KVCache(
        a=cache_a, b=cache_b,
        length=torch.tensor(S, dtype=torch.int32, device=dev))


def teacher_forced(params, tokens, cfg: LMConfig, smax: int, n_prompt: int,
                   *, batch_axes=None):
    """A serving run as one call: prefill ``tokens[:, :n_prompt]`` into a
    cache of ``smax`` rows, then one :func:`decode_step` for each further
    token (teacher forced) → (the logits of the prefill and of every step
    (n_steps + 1, B, V) float32, a KVCache whose a / b hold the first
    ``tokens.shape[1]`` rows, the ones the run wrote, whole over the
    sequence). On a mesh (``batch_axes`` as in :func:`decode_step`) those
    rows are gathered from the ranks that own them (every other rank adds
    zeros), so the run's cache can be checked without gathering all of
    it."""
    T = tokens.shape[1]
    logits, cache = prefill(params, tokens[:, :n_prompt], cfg, smax,
                            batch_axes=batch_axes)
    out = [logits]
    for t in range(n_prompt, T):
        step, cache = decode_step(params, cache, tokens[:, t:t + 1], cfg,
                                  batch_axes=batch_axes)
        out.append(step)
    seq = _seq_shard(cache.a.shape[2], batch_axes)

    def written(t):
        if seq is None:
            return t[:, :, :T].clone()
        rows = t.new_zeros((t.shape[0], t.shape[1], T, *t.shape[3:]))
        hi = min(seq.r0 + seq.rows, T)
        if hi > seq.r0:
            rows[:, :, seq.r0:hi] = t[:, :, :hi - seq.r0]
        return runtime.all_reduce(rows, seq.axes)
    return torch.stack(out), cache._replace(a=written(cache.a),
                                            b=written(cache.b))
