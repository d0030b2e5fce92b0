"""Shared dense building blocks (activation, dense layer, MLP tower) as
plain functions on parameter dicts of tensors — the reference's pytree
layout, so weights carry across unchanged."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import default_device


def activation(x, kind: str):
    # jax.nn.gelu defaults to the tanh approximation; torch's default is
    # the exact erf form
    return F.gelu(x, approximate="tanh") if kind == "gelu" else F.silu(x)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, bias: bool = True, scale=None,
               device=None) -> dict:
    """{"w": (d_in, d_out) ~ N(0, scale²), "b": zeros}; ``scale`` defaults
    to 1/sqrt(d_in). ``generator`` must live on ``device``."""
    dev = default_device(device)
    s = scale if scale is not None else 1.0 / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, device=dev,
                    dtype=torch.float32) * s
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    return p


def dense_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def mlp_tower_init(generator: torch.Generator, d_in: int, widths,
                   dtype=torch.float32, out_bias=True, device=None) -> list:
    layers, d = [], d_in
    for w in widths:
        layers.append(dense_init(generator, d, w, dtype, bias=out_bias,
                                 device=device))
        d = w
    return layers


def mlp_tower_apply(layers: list, x: torch.Tensor, act: str = "silu",
                    final_act: bool = False) -> torch.Tensor:
    for i, p in enumerate(layers):
        x = dense_apply(p, x)
        if i < len(layers) - 1 or final_act:
            x = activation(x, act)
    return x
