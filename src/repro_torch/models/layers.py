"""Shared building blocks (activation, dense layer, MLP tower, norms, RoPE,
the transformer FFN) as plain functions on parameter dicts of tensors —
the reference's pytree layout, so weights carry across unchanged."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import default_device, runtime


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


# ------------------------------------------------- parameter draws, dtypes

def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a name ("float32", "bfloat16")."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


def randn_scaled(generator, shape, scale, device):
    """N(0, scale²) in float32, drawn from ``generator`` on ``device``."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device) * scale


# ---------------------------------------------------------------- norms

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """In float32, cast back to ``x``'s dtype (as the reference does)."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm_apply(x, p, kind: str, eps: float):
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"], eps)
    return rmsnorm(x, p["scale"], eps)


def norm_init(d: int, kind: str, dtype, device=None) -> dict:
    dev = default_device(device)
    dt = as_dtype(dtype)
    p = {"scale": torch.ones((d,), dtype=dt, device=dev)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dt, device=dev)
    return p


# ---------------------------------------------------------------- RoPE

def rope_freqs(d_rot: int, theta: float, device=None,
               scaling=None) -> torch.Tensor:
    """The (d_rot/2,) inverse frequencies: theta^(-2i/d_rot), or with a
    YaRN ``scaling`` (``configs.base.RopeScaling``) the published blend
    freq_inter (1 - mask) + freq_extra mask, freq_extra the plain ones,
    freq_inter those over ``factor``, mask 1 at the dims that turn more
    than ``beta_fast`` times over the original context and 0 at those
    that turn fewer than ``beta_slow`` times, linear between."""
    exps = torch.arange(0, d_rot, 2, dtype=torch.float32, device=device) / d_rot
    extra = 1.0 / (theta ** exps)
    if scaling is None:
        return extra
    lo, hi = yarn_correction_range(scaling, d_rot, theta)
    ramp = ((torch.arange(d_rot // 2, dtype=torch.float32, device=device)
             - lo) / max(hi - lo, 1e-3)).clamp(0, 1)
    mask = 1.0 - ramp
    return extra / scaling.factor * (1.0 - mask) + extra * mask


def yarn_correction_range(scaling, d_rot: int, theta: float):
    """The dims (floor of the fast one, ceil of the slow one, within
    [0, d_rot - 1]) whose frequencies turn ``beta_fast`` and ``beta_slow``
    times over the original context."""
    def dim(turns):
        return (d_rot * np.log(scaling.original_max_position_embeddings
                               / (turns * 2 * np.pi))) / (2 * np.log(theta))
    return (max(int(np.floor(dim(scaling.beta_fast))), 0),
            min(int(np.ceil(dim(scaling.beta_slow))), d_rot - 1))


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature: 0.1 mscale ln(factor) + 1 (1 for a
    factor of at most 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * float(np.log(factor)) + 1.0


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, scaling=None) -> torch.Tensor:
    """x (..., S, H, D) with positions (..., S): rotate the full D, in
    float32 on float positions. A YaRN ``scaling`` blends the frequencies
    (:func:`rope_freqs`) and scales cos and sin by mscale over
    mscale_all_dim's temperature."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device, scaling)              # (D/2,)
    angles = positions[..., None].float() * freqs                # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    if scaling is not None:
        m = (yarn_mscale(scaling.factor, scaling.mscale)
             / yarn_mscale(scaling.factor, scaling.mscale_all_dim))
        if m != 1.0:
            cos, sin = cos * m, sin * m
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- MLP

def mlp_init(generator: torch.Generator, d_in: int, d_ff: int, d_out: int,
             glu: bool, dtype, device=None) -> dict:
    """{"w1" (d_in, d_ff), "w2" (d_ff, d_out)[, "w3" (d_in, d_ff)]} drawn
    from ``generator`` (which must live on ``device``)."""
    dev = default_device(device)
    s_in, s_ff = 1.0 / np.sqrt(d_in), 1.0 / np.sqrt(d_ff)
    p = {"w1": randn_scaled(generator, (d_in, d_ff), s_in, dev),
         "w2": randn_scaled(generator, (d_ff, d_out), s_ff, dev)}
    if glu:
        p["w3"] = randn_scaled(generator, (d_in, d_ff), s_in, dev)
    dt = as_dtype(dtype)
    return {k: v.to(dt) for k, v in p.items()}


def mlp_apply(p: dict, x: torch.Tensor, act: str, glu: bool,
              split: bool = False, carry: bool = False) -> torch.Tensor:
    """The FFN. ``split``: on a mesh, ``w1`` / ``w3`` hold the rank's
    columns of d_ff and ``w2`` its rows (column- then row-parallel, the
    reference's ``launch/sharding.py:67-72``), so the output is summed over
    ``model`` (:func:`row_parallel`) and ``x`` enters the split
    (``runtime.enter``: its gradient is summed over ``model``).
    ``carry``: the output as the rank's block of its last dim over
    ``model`` (:func:`row_parallel`)."""
    if split:
        x = runtime.enter(x, "model")
    h = activation(x @ p["w1"], act)
    if glu:
        h = h * (x @ p["w3"])
    return row_parallel(h, p["w2"], split, carry)


def row_parallel(x: torch.Tensor, w: torch.Tensor, split: bool,
                 carry: bool = False) -> torch.Tensor:
    """x @ w. ``split``: ``w`` holds the rank's rows of the contraction
    (row-parallel over ``model``), so the rank's partial product is summed
    over ``model`` by one ``all_reduce`` in its own dtype — where and as
    GSPMD inserts it for the reference. ``carry``: the product as the
    rank's block of its last dim over ``model`` (the split residual of
    ``cfg.shard_carry``), a partial one reduce-scattered there
    (:func:`carry_block`)."""
    if carry:
        return carry_block(x @ w, partial=split)
    if not split:
        return x @ w
    return runtime.all_reduce(x @ w, "model")


# ---------------------------------------------- the residual over ``model``

def carry_block(y: torch.Tensor, partial: bool = False) -> torch.Tensor:
    """The rank's block over ``model`` of ``y``'s last dim (the residual
    stream split on d_model, ``cfg.shard_carry``). ``partial``: ``y`` is
    the rank's partial sum (a row-parallel product), reduce-scattered over
    ``model`` on that dim in place of the all_reduce. Else ``y`` is
    replicated over ``model``: the block is a slice, and ``y`` enters
    ``model`` (``runtime.enter``), so the ranks' blocks' cotangents,
    zero-padded by the slice's backward, are summed into the whole."""
    if partial:
        return runtime.reduce_scatter(y.movedim(-1, 0), "model").movedim(0, -1)
    start, per = runtime.block(y.shape[-1], "model")
    return runtime.enter(y, "model").narrow(-1, start, per)


def carry_whole(x: torch.Tensor) -> torch.Tensor:
    """The whole residual from the ranks' blocks of its last dim: one
    all_gather over ``model`` (its backward takes the rank's block of the
    cotangent, which is replicated over ``model``), contiguous as the
    whole residual is."""
    return runtime.all_gather(x.movedim(-1, 0), "model").movedim(
        0, -1).contiguous()
