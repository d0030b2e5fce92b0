"""A generic train step: value and gradient (``torch.autograd.grad``)
+ (optional) micro-batched gradient accumulation + optimizer update.

Gradients accumulate in the param dtype, as the reference accumulates
them (for deepseek-v3 that is bf16 by memory necessity), then are divided
by the micro-batch count.

On a device mesh (``runtime.current_mesh()``, with ``param_specs``) each
rank runs the loss on its parameters and its block of the batch; by
``runtime``'s rule for gradients a leaf's gradient is then partial over
the batch axes its spec does not name, and is summed over them. With
``grad_shardings`` (``sharding.zero_specs``: ZeRO-2) the sum over
``data`` of a leaf that spec splits further is a reduce_scatter into the
rank's ZeRO shard: the micro-batches accumulate in that shard, the
optimizer (its state in shard shapes, ``opt_init`` of the shards)
updates the shard, and the new parameters are all-gathered over
``data`` once a step — what GSPMD makes of the reference's sharding
constraint on the accumulator.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import runtime
from repro_torch import tree as tree_lib
from repro_torch.tree import tree_map


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads): ``loss_fn(params, batch)`` and its gradient w.r.t.
    every floating leaf of ``params``, in ``params``' structure and dtypes
    (zeros where the loss does not reach a leaf)."""
    flat = tree_lib.leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(p.is_floating_point()) for p in flat]
        loss = loss_fn(tree_lib.unflatten(params, live), batch)
        wrt = [p for p in live if p.requires_grad]
        found = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p in live:
        g = next(found) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return loss.detach(), tree_lib.unflatten(params, grads)


class _LeafPlan:
    """How one leaf's gradient meets the mesh: the batch axes it is
    summed over, and the dim its ZeRO shard splits over ``data`` (None:
    the shard is the rank's whole part)."""

    def __init__(self, pspec, zspec, batch_axes):
        from repro_torch.launch.sharding import entry_axes
        named = {a for e in (pspec or ()) for a in entry_axes(e)}
        self.sum_axes = tuple(a for a in batch_axes if a not in named)
        self.dim = None
        for i, e in enumerate(zspec or ()):
            if "data" in entry_axes(e) and "data" not in named:
                self.dim = i

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's ZeRO shard of its part ``t``."""
        if self.dim is None:
            return t
        start, per = runtime.block(t.shape[self.dim], "data")
        return t.narrow(self.dim, start, per)

    def reduce(self, g: torch.Tensor) -> torch.Tensor:
        """``g`` summed over the batch axes, into the ZeRO shard."""
        rest = self.sum_axes
        if self.dim is not None and "data" in rest:
            rest = tuple(a for a in rest if a != "data")
        if runtime.mesh_axes(rest):
            g = runtime.all_reduce(g, rest)
        if self.dim is None:
            return g
        if "data" not in self.sum_axes:
            return self.shard(g)
        return runtime.reduce_scatter(g.movedim(self.dim, 0),
                                      "data").movedim(0, self.dim)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's whole part from its ZeRO shard."""
        if self.dim is None:
            return t
        return runtime.all_gather(t.movedim(self.dim, 0).contiguous(),
                                  "data").movedim(0, self.dim).contiguous()


def build_train_step(loss_fn: Callable, opt, *, n_micro: int = 1,
                     split_batch: Callable = None, grad_shardings=None,
                     param_specs=None, batch_axes=None):
    """loss_fn(params, batch) → scalar. split_batch(batch, n_micro) → tree
    whose leaves have a leading n_micro dim (default: reshape dim 0).
    Returns (train_step, opt_init); ``train_step(params, opt_state,
    batch)`` → (new params, new opt state, float32 loss).

    On an installed mesh ``params`` are the rank's parts by
    ``param_specs`` (``sharding.param_specs``), ``batch`` its block over
    ``batch_axes`` (None: the mesh's data axes; ``()``: every rank holds
    the batch whole, as SchNet's graph) and ``grad_shardings`` (the
    reference's ZeRO-2 constraint, ``sharding.zero_specs``) shards the
    accumulator and the optimizer (module docstring); ``opt_init`` then
    draws the state of the rank's shards. Without a mesh the specs are
    not read: the one-device step."""
    opt_init, opt_update = opt
    if grad_shardings is not None and param_specs is None:
        param_specs = grad_shardings

    if split_batch is None:
        def split_batch(batch, n):
            return tree_map(
                lambda x: x.reshape(n, x.shape[0] // n, *x.shape[1:]), batch)

    def plans(params):
        """The leaves' plans on the installed mesh (None: no mesh)."""
        if runtime.current_mesh() is None or param_specs is None:
            return None
        axes = runtime.mesh_axes(runtime.batch_axes() if batch_axes is None
                                 else batch_axes)
        zspecs = grad_shardings if grad_shardings is not None else param_specs
        return tree_map(lambda _p, ps, zs: _LeafPlan(ps, zs, axes),
                        params, param_specs, zspecs)

    def init(params):
        plan = plans(params)
        if plan is None:
            return opt_init(params)
        return opt_init(tree_map(lambda p, pl: pl.shard(p), params, plan))

    def train_step(params, opt_state, batch):
        plan = plans(params)

        def reduced(g):
            return g if plan is None else tree_map(
                lambda x, pl: pl.reduce(x), g, plan)
        if n_micro == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
            grads = reduced(grads)
        else:
            mb = split_batch(batch, n_micro)
            like = params if plan is None else tree_map(
                lambda p, pl: pl.shard(p), params, plan)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                                   device=p.device), like)
            losses = []
            for i in range(n_micro):
                l, g = value_and_grad(loss_fn, params,
                                      tree_map(lambda x: x[i], mb))
                grads = tree_map(torch.add, grads, reduced(g))
                losses.append(l)
            grads = tree_map(lambda g: (g / n_micro).to(g.dtype), grads)
            loss = torch.stack(losses).mean()
        if plan is None:
            new_params, new_opt = opt_update(grads, opt_state, params)
        else:
            shards = tree_map(lambda p, pl: pl.shard(p), params, plan)
            zspecs = grad_shardings if grad_shardings is not None \
                else param_specs
            new_shards, new_opt = opt_update(grads, opt_state, shards,
                                             specs=zspecs)
            new_params = tree_map(lambda t, pl: pl.gather(t), new_shards, plan)
        return new_params, new_opt, loss.float()

    return train_step, init


def reduce_grads(grads, params, param_specs, batch_axes=None):
    """One step's local gradients (``value_and_grad`` on the rank's parts)
    summed over the batch axes each leaf's spec does not name: the whole
    gradient of every rank's part (no ZeRO shard)."""
    axes = runtime.mesh_axes(runtime.batch_axes() if batch_axes is None
                             else batch_axes)
    plan = tree_map(lambda _p, ps: _LeafPlan(ps, None, axes), params,
                    param_specs)
    return tree_map(lambda g, pl: pl.reduce(g), grads, plan)

