"""Expert-parallel MoE (DeepSeek-style: shared + fine-grained routed
experts), in PyTorch.

Dispatch is sort-based, as in the reference: argsort by expert,
rank-in-expert capacity, a gather into (E, C, d) buffers, one batched
product per expert weight, and a combine through a zero sentinel row for
dropped pairs. Shared experts are a plain dense GLU handled by the caller.
Every shape is static, as in the reference's jitted code: counts are
scatter-adds (no ``bincount``) and every (token, expert) pair is written,
a dropped one to the sentinel slot, so one rank's step also runs on the
``meta`` device (a dry run, ``launch/dryrun.py``).

On a device mesh whose ``model`` axis is larger than 1 (read from
``runtime.current_mesh()``, as the reference reads it) each rank holds
its experts [e0, e0 + E_loc) over ``model`` and, where ``data`` divides
the expert d_ff, its slice of it over ``data`` (``moe_param_specs``); the
reference's ``shard_map`` body (``moe.py:120-219``) is written out by
rank, branch for branch:

  * token-sharded (the rank's tokens are its block of a batch split over
    the data axes): tokens, gates and expert ids all-gathered over
    ``data``, dispatched at the capacity of the gathered row, then either
    one reduce_scatter over (``data``, ``model``) and an all_gather over
    ``model`` (the row splits over both) or an all_reduce over ``model``
    and a reduce_scatter over ``data``; a row whose (tokens x d) passes
    ``CHUNK_ELEMS`` goes in chunks, each with its own capacity, and the
    chunks' outputs are put back in the (shard, chunk, pos) order;
  * replicated tokens (a batch every rank holds whole whose token count
    does not split over the data axes, e.g. batch-1 decode): one
    all_reduce over (``data``, ``model``) where d_ff is split, else over
    ``model``.

The top-k gates are renormalised to sum 1 unless ``norm_topk_prob`` is
off (DeepSeek-V2-Lite's published routing keeps the raw softmax
probabilities). ``capacity_factor=None`` serves dropless: each expert's
capacity is the call's whole row of tokens, which no expert can pass
(a token picks an expert at most once). Inside :func:`recording` every
dispatch also hands over its expert ids and which pairs it kept
(:class:`Routed`; nothing more is launched for it, and the count of
dropped pairs is taken only when read).

The load-balance aux is averaged over every mesh axis. That is each
data shard's ``E·Σ(me·ce)`` averaged, not the aux of the whole batch, so
a training loss on a mesh differs from the one-device loss by design, as
the reference's does (``moe.py:57-62,208``).

In training (autograd recording; ``runtime``'s rule for gradients) the
tokens and gates enter the expert split over ``model`` (over ``data``
too where the replicated branch splits d_ff), their gathers over
``data`` sum the ranks' partial cotangents, and the probabilities the
aux reads enter ``model``, so each model rank's copy of the aux counts
once.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import default_device, runtime
from repro_torch.launch.sharding import P
from repro_torch.models.layers import (activation, as_dtype, carry_block,
                                      randn_scaled)
from repro_torch.topk import ordered_topk

#: a gathered token row of more elements than this (tokens x d_model)
#: dispatches in chunks: the reference's threshold (``moe.py:151``)
CHUNK_ELEMS = 1 << 26


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


_recording = threading.local()


class Routed(NamedTuple):
    """One dispatch's routing: the expert ids (T, k), and over its pairs
    in expert order which went to the rank's experts (``mine``) and which
    of those kept a slot (``kept``)."""
    ids: torch.Tensor
    mine: torch.Tensor
    kept: torch.Tensor

    def dropped(self) -> int:
        """The rank's pairs dropped for capacity (read on the host)."""
        return int(self.mine.sum()) - int(self.kept.sum())


@contextlib.contextmanager
def recording():
    """Inside the block every MoE dispatch on this thread appends its
    :class:`Routed` to the list yielded (one a layer on one device; on a
    mesh, the rank's experts' part of each)."""
    calls: list = []
    outer = getattr(_recording, "calls", None)
    _recording.calls = calls
    try:
        yield calls
    finally:
        _recording.calls = outer


def _capacity(tokens: int, cfg) -> int:
    """Slots an expert holds for a row of ``tokens`` tokens: the row itself
    where ``capacity_factor`` is None (dropless), else the factor times
    the mean load, a multiple of 8."""
    if cfg.capacity_factor is None:
        return tokens
    c = int(np.ceil(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_routed))
    return max(8, -(-c // 8) * 8)


def _route(x, router_w, top_k: int, aux_probs=lambda probs: probs,
           norm: bool = True):
    """(gates, expert ids, load-balance aux); ``aux_probs`` takes the
    probabilities the aux reads; ``norm``: the top-k gates renormalised to
    sum 1, else the softmax probabilities themselves."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    gate, idx = ordered_topk(probs, top_k)                        # (T, k)
    if norm:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux (Switch-style), for a training loss
    T, E = logits.shape
    me = aux_probs(probs).mean(0)
    ce = _counts(idx.reshape(-1), E).float() / (T * top_k)
    aux = E * torch.sum(me * ce)
    return gate, idx, aux


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` for ids in [0, n), as a
    scatter-add of static shape (n,)."""
    return torch.zeros((n,), dtype=torch.long, device=ids.device) \
        .scatter_add_(0, ids, torch.ones_like(ids))


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
    counts = _counts(sorted_e, E_loc + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(N, device=dev) - starts[sorted_e]
    mine_sorted = sorted_e < E_loc
    keep = mine_sorted & (pos < C)
    calls = getattr(_recording, "calls", None)
    if calls is not None:
        calls.append(Routed(idx, mine_sorted, keep))
    sentinel = E_loc * C
    slot = torch.where(keep, sorted_e * C + pos, torch.full_like(pos, sentinel))
    src_tok = order // k

    # slot → source token; a slot no pair fills stays empty (zero row).
    # Every pair is written: the dropped and foreign ones all to the
    # sentinel slot, which is cut off
    idx_buf = torch.zeros((sentinel + 1,), dtype=torch.long, device=dev)
    idx_buf[slot] = src_tok
    occ = torch.zeros((sentinel + 1,), dtype=xg.dtype, device=dev) \
        .index_fill_(0, slot, 1)
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


def moe_apply(p: dict, x: torch.Tensor, cfg, act: str = "silu", *,
              batch_axes=None, carry: bool = False):
    """x (..., d) → (same, aux_loss). Token dims are flattened internally.

    On a mesh with a ``model`` axis the experts are split (module
    docstring). ``x`` holds the rank's block of tokens split over
    ``batch_axes`` (None: the mesh's data axes, ``runtime.batch_axes()``),
    or, with ``batch_axes=()``, tokens every rank holds whole; the output
    comes back in ``x``'s layout. Whole tokens whose count splits over the
    data axes take the token-sharded branch on the rank's block, as the
    reference's GSPMD reshards them, and are gathered back. ``carry``: the
    output as the rank's block of d over ``model`` (``layers.carry_block``;
    token-sharded rows trade their gather over ``model`` for one
    all_to_all there)."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    if not runtime.has_axis("model"):
        gate, idx, aux = _route(xt, p["router"], cfg.top_k,
                                norm=getattr(cfg, "norm_topk_prob", True))
        out = _dispatch_compute_combine(
            xt, gate, idx, p["w1"], p["w3"], p["w2"],
            e0=0, C=_capacity(xt.shape[0], cfg), act=act)
        return out.reshape(*lead, d), aux
    out, aux = _moe_on_mesh(p, xt, cfg, act, batch_axes, carry)
    return out.reshape(*lead, out.shape[-1]), aux


def _moe_on_mesh(p, xt, cfg, act, batch_axes, carry=False):
    n_model = runtime.axis_size("model")
    n_data = runtime.axis_size("data")
    nd = runtime.data_axis_size()
    if cfg.n_routed % n_model:
        raise ValueError(f"{cfg.n_routed} experts do not split over a model "
                         f"axis of {n_model}")
    E_loc = cfg.n_routed // n_model
    whole = batch_axes is not None and not runtime.mesh_axes(batch_axes)
    T = xt.shape[0] if whole else xt.shape[0] * nd          # global tokens
    # tokens shard over the data axes when they divide (train, bulk
    # serve); tiny-token decode keeps them replicated
    tok_sharded = T % nd == 0 and T >= nd
    if whole and tok_sharded:
        xt = runtime.shard(xt, runtime.batch_axes())
    T_row = (T // nd) * n_data if tok_sharded else T
    C = _capacity(T_row, cfg)
    f_sharded = cfg.d_ff_expert % n_data == 0 and n_data > 1
    d = xt.shape[-1]
    n_ch = 1
    while (T_row // n_ch) * d > CHUNK_ELEMS and T_row % (n_ch * 2) == 0 \
            and (T_row // (n_ch * 2)) % n_data == 0:
        n_ch *= 2
    # training: the aux is replicated over ``model`` and averaged over
    # every axis, so each model rank's copy counts once in the sum over
    # them: the probabilities it reads enter ``model``
    gate, idx, aux = _route(xt, p["router"], cfg.top_k,
                            lambda pr: runtime.enter(pr, "model"),
                            norm=getattr(cfg, "norm_topk_prob", True))
    e0 = runtime.axis_index("model") * E_loc
    w = (p["w1"], p["w3"], p["w2"])
    # the tokens and gates (replicated over ``model``) feed the rank's
    # experts only, and, gathered over ``data``, its f-slice only: their
    # gradients are summed over ``model`` (enter) and over ``data`` (the
    # gathers' partial backward)
    enter_axes = ("model",) if tok_sharded or not f_sharded \
        else ("data", "model")
    xt, gate = runtime.enter(xt, enter_axes), runtime.enter(gate, enter_axes)

    def gather(t):
        return runtime.all_gather(t, "data", partial=True)
    if tok_sharded and n_ch > 1:
        T_l = xt.shape[0] // n_ch
        outc = []
        for c in range(n_ch):
            at = slice(c * T_l, (c + 1) * T_l)
            outc.append(_dispatch_compute_combine(
                gather(xt[at]), gather(gate[at]),
                runtime.all_gather(idx[at], "data"), *w, e0=e0,
                C=_capacity(T_row // n_ch, cfg), act=act))
        # each chunk's gather is shard-major within the chunk: restore the
        # whole row's (shard, chunk, pos) order for the combine
        out_full = torch.stack(outc).reshape(n_ch, n_data, T_l, d) \
            .transpose(0, 1).reshape(T_row, d)
    elif tok_sharded:
        out_full = _dispatch_compute_combine(
            gather(xt), gather(gate), runtime.all_gather(idx, "data"), *w,
            e0=e0, C=C, act=act)
    else:
        out_full = _dispatch_compute_combine(xt, gate, idx, *w, e0=e0, C=C,
                                             act=act)
    split_rows = tok_sharded and T_row % (n_data * n_model) == 0
    if split_rows:
        # the expert (model) and f-slice (data) partials summed and the
        # rows scattered over both axes, then the data shard's rows
        # gathered over model: ~1.06x the buffer moved instead of ~2.9x
        out = runtime.reduce_scatter(out_full, ("data", "model"))
        if carry:
            # the rank's rows, every column → every row of the data
            # shard, the rank's columns: column block j to model rank j
            r = out.shape[0]
            out = out.reshape(r, n_model, d // n_model).transpose(0, 1)
            out = runtime.all_to_all(out.reshape(r * n_model, -1), "model")
        else:
            out = runtime.all_gather(out, "model")
    elif tok_sharded:
        out = runtime.reduce_scatter(runtime.all_reduce(out_full, "model"),
                                     "data")
    else:
        out = runtime.all_reduce(
            out_full, ("data", "model") if f_sharded else ("model",))
    if whole and tok_sharded:
        out = runtime.all_gather(out, runtime.batch_axes())
    if carry and not split_rows:
        out = carry_block(out)
    mesh = runtime.current_mesh()
    aux = runtime.all_reduce(aux.reshape(1), mesh.axis_names)[0] / mesh.size
    return out, aux


def moe_param_specs(cfg, f_sharded: bool) -> dict:
    """The specs of one (unstacked) MoE layer's params (reference
    ``moe.py:222-228``): experts over ``model``, expert d_ff over
    ``data`` where ``f_sharded``, the router replicated."""
    fs = "data" if f_sharded else None
    return {"router": P(None, None),
            "w1": P("model", None, fs),
            "w3": P("model", None, fs),
            "w2": P("model", fs, None)}
