"""A generic train step: value and gradient (``torch.autograd.grad``)
+ (optional) micro-batched gradient accumulation + optimizer update.

Gradients accumulate in the param dtype, as the reference accumulates
them (for deepseek-v3 that is bf16 by memory necessity), then are divided
by the micro-batch count.
"""
from __future__ import annotations

from typing import Callable

import torch

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


def build_train_step(loss_fn: Callable, opt, *, n_micro: int = 1,
                     split_batch: Callable = None, grad_shardings=None):
    """loss_fn(params, batch) → scalar. split_batch(batch, n_micro) → tree
    whose leaves have a leading n_micro dim (default: reshape dim 0).
    ``grad_shardings`` (the reference's ZeRO-2 constraint on the gradient
    accumulator) needs a device mesh, which the port has not yet: it
    raises. Returns (train_step, opt_init); ``train_step(params,
    opt_state, batch)`` → (new params, new opt state, float32 loss)."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings need a device mesh, which is not ported yet "
            "(ROADMAP A8); the port trains on one device")
    opt_init, opt_update = opt

    if split_batch is None:
        def split_batch(batch, n):
            return tree_map(
                lambda x: x.reshape(n, x.shape[0] // n, *x.shape[1:]), batch)

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            mb = split_batch(batch, n_micro)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                                   device=p.device), params)
            losses = []
            for i in range(n_micro):
                l, g = value_and_grad(loss_fn, params,
                                      tree_map(lambda x: x[i], mb))
                grads = tree_map(torch.add, grads, g)
                losses.append(l)
            grads = tree_map(lambda g: (g / n_micro).to(g.dtype), grads)
            loss = torch.stack(losses).mean()
        new_params, new_opt = opt_update(grads, opt_state, params)
        return new_params, new_opt, loss.float()

    return train_step, opt_init
