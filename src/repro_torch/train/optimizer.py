"""Optimizers, self-contained (no ``torch.optim``): AdamW, Adafactor
(factored second moment), and row-wise Adagrad for embedding tables (one
accumulator scalar per row, not per element).

The reference's (init, update) pairs on trees of tensors: ``init(params)``
→ ``OptState``; ``update(grads, state, params)`` → (new params, new
state), out of place, with float32 state and the update computed in
float32 and cast back to each parameter's dtype, step for step as the
reference computes it (``torch.optim.AdamW`` follows another trajectory).

A combined optimizer routes params by path: table leaves (2-D, huge vocab
rows) → rowwise adagrad; everything else → adamw/adafactor.

On a device mesh each rank updates its part of every leaf (a
``RowShard``'s rows, a TP slice, a ZeRO shard) and ``update`` takes the
leaves' specs (``specs=``, ``launch/sharding.P`` trees like ``params``).
AdamW is elementwise and row-wise Adagrad row-local (a mean over the
unsplit embedding dim), so neither reads them; Adafactor's means over a
dim and its update-clipping RMS are global in the reference (GSPMD's
arrays), so on a shard each is a sum over the rank's part, summed over
the axes its spec splits that dim over, divided by the global count.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch import runtime
from repro_torch import tree as tree_lib
from repro_torch.tree import tree_map


def _dim_axes(spec, ndim: int) -> list:
    """Per dim of a leaf, the mesh axes its spec splits it over (all ()
    without a spec)."""
    from repro_torch.launch.sharding import entry_axes
    entries = list(spec or ()) + [None] * (ndim - len(spec or ()))
    return [entry_axes(e) for e in entries[:ndim]]


def _mean(x: torch.Tensor, dim: int, axes: tuple, keepdim=False):
    """The mean over ``dim`` of the whole leaf whose part ``x`` is, the
    dim split over ``axes``."""
    if not runtime.mesh_axes(axes):
        return x.mean(dim, keepdim=keepdim)
    n = x.shape[dim] * runtime.axes_size(axes)
    return runtime.all_reduce(x.sum(dim, keepdim=keepdim), axes) / n


def _global_numel(x: torch.Tensor, axes: list) -> int:
    return x.numel() * math.prod(runtime.axes_size(a) for a in axes)


class OptState(NamedTuple):
    step: torch.Tensor          # 0-d int32, on the parameters' device
    inner: Any


def _step0(params) -> torch.Tensor:
    leaves = tree_lib.leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _split_pairs(like, pairs):
    """A tree of (a, b) pairs at ``like``'s leaves → (tree of a, tree of
    b)."""
    return (tree_map(lambda _p, o: o[0], like, pairs),
            tree_map(lambda _p, o: o[1], like, pairs))


# ------------------------------------------------------------------ AdamW

def adamw(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.01):
    def init(params):
        return OptState(_step0(params), {"m": tree_map(_zeros32, params),
                                         "v": tree_map(_zeros32, params)})

    def update(grads, state, params, specs=None):
        t = state.step + 1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                     state.inner["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                     state.inner["v"], grads)
        bc1 = 1 - torch.pow(b1, t.float())
        bc2 = 1 - torch.pow(b2, t.float())

        def upd(p, m, v):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            return (p.float() - lr * (step + wd * p.float())).to(p.dtype)
        new_params = tree_map(upd, params, m, v)
        return new_params, OptState(t, {"m": m, "v": v})

    return init, update


# --------------------------------------------------------------- Adafactor

#: Adafactor updates a factored leaf of more elements than this, with a
#: leading (layer) dim above 1, one leading slice at a time (the
#: reference's ``lax.map``), so its fp32 temporaries shrink by that factor
#: and the RMS update clip applies per slice, as there
ADAFACTOR_CHUNK_ELEMS = 1 << 27


def adafactor(lr=1e-2, eps=1e-30, clip=1.0, decay=0.8):
    """Shazeer & Stern [arXiv:1804.04235], factored second moment."""
    def factored(p):
        return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1

    def init(params):
        def st(p):
            if factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32, device=p.device)}
            return {"v": _zeros32(p)}
        return OptState(_step0(params), tree_map(st, params))

    def update(grads, state, params, specs=None):
        t = state.step + 1
        beta = 1.0 - (t.float() + 1.0) ** (-decay)

        def upd_one(p, g, s, axes):
            g = g.float()
            g2 = torch.square(g) + eps
            if factored(p):
                vr = beta * s["vr"] + (1 - beta) * _mean(g2, -1, axes[-1])
                vc = beta * s["vc"] + (1 - beta) * _mean(g2, -2, axes[-2])
                denom = (vr[..., None] / torch.clamp(
                    _mean(vr, -1, axes[-2], keepdim=True), min=eps)[..., None]) \
                    * vc[..., None, :]
                u = g * torch.rsqrt(denom + eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                new_s = {"v": v}
            # update clipping (RMS)
            split = tuple(a for ax in axes for a in ax)
            if runtime.mesh_axes(split):
                sq = runtime.all_reduce(torch.square(u).sum(), split)
                rms = torch.sqrt(sq / _global_numel(u, axes) + eps)
            else:
                rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms / clip, min=1.0)
            return (p.float() - lr * u).to(p.dtype), new_s

        def upd(p, g, s, spec=None):
            axes = _dim_axes(spec, p.dim())
            if (factored(p) and p.dim() >= 3 and p.shape[0] > 1
                    and _global_numel(p, axes) > ADAFACTOR_CHUNK_ELEMS):
                outs = [upd_one(p[i], g[i], {k: x[i] for k, x in s.items()},
                                axes[1:])
                        for i in range(p.shape[0])]
                return (torch.stack([o[0] for o in outs]),
                        {k: torch.stack([o[1][k] for o in outs]) for k in s})
            return upd_one(p, g, s, axes)

        new_params, new_inner = _split_pairs(
            params, tree_map(upd, params, grads, state.inner)
            if specs is None else
            tree_map(upd, params, grads, state.inner, specs))
        return new_params, OptState(t, new_inner)

    return init, update


# -------------------------------------------------------- row-wise Adagrad

def rowwise_adagrad(lr=0.05, eps=1e-8):
    """One fp32 accumulator per embedding ROW (FBGEMM-style). A row whose
    gradient is zero keeps its value bit for bit (``a + 0``, ``p - 0``)."""
    def init(params):
        return OptState(_step0(params), tree_map(
            lambda p: torch.zeros(p.shape[:1], dtype=torch.float32,
                                  device=p.device), params))

    def update(grads, state, params, specs=None):
        def upd(p, g, a):
            g = g.float()
            a_new = a + torch.mean(torch.square(g), dim=-1)
            step = g * (lr * torch.rsqrt(a_new + eps))[:, None]
            return (p.float() - step).to(p.dtype), a_new
        new_params, new_inner = _split_pairs(
            params, tree_map(upd, params, grads, state.inner))
        return new_params, OptState(state.step + 1, new_inner)

    return init, update


# --------------------------------------------------------------- combined

def combined(dense_opt, table_opt):
    """Route 'tables' subtrees to table_opt, the rest to dense_opt."""
    d_init, d_update = dense_opt
    t_init, t_update = table_opt

    def split(params):
        tables = {}
        dense = {}
        for k, v in params.items():
            (tables if k == "tables" else dense)[k] = v
        return dense, tables

    def init(params):
        dense, tables = split(params)
        return OptState(_step0(params),
                        {"dense": d_init(dense), "tables": t_init(tables)})

    def update(grads, state, params, specs=None):
        dense, tables = split(params)
        gd, gt = split(grads)
        kw = {} if specs is None else {"specs": split(specs)[0]}
        nd, sd = d_update(gd, state.inner["dense"], dense, **kw)
        kw = {} if specs is None else {"specs": split(specs)[1]}
        nt, st = t_update(gt, state.inner["tables"], tables, **kw)
        new = dict(nd)
        new.update(nt)
        return new, OptState(state.step + 1, {"dense": sd, "tables": st})

    return init, update


def for_family(family: str, size_hint: int = 0):
    """Production defaults: adafactor for big LMs, adamw for small/gnn,
    rowwise-adagrad tables + adamw dense for recsys."""
    if family == "recsys":
        return combined(adamw(lr=1e-3), rowwise_adagrad())
    if family == "lm" and size_hint > 1_000_000_000:
        return adafactor()
    return adamw()
