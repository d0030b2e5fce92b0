"""Wrapper of the din_attention kernel (``csrc/din_attention.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import (is_dry, launch, on_cpu, recorded, require,
                                 with_plain_gradient)
from repro_torch.kernels.din_attention.ref import din_attention_ref

#: what :func:`cost` takes on ``meta``, where it cannot read the mask
BOUND = "the mask's non-zeros taken as B x T (every step active)"
#: history steps per chunk (``kChunk`` in the source), the widths of the
#: register tiles (``kMaxH1``, ``kMaxH2``) and the most blocks a row's
#: cluster has (``kMaxCluster``)
CHUNK, MAX_H1, MAX_H2, MAX_CLUSTER = 16, 80, 40, 8


@recorded("din_attention", din_attention_ref)
def din_attention(hist, mask, target, w1, b1, w2, b2, w3, b3):
    """Fused DIN local activation unit: hist (B,T,D), mask (B,T), target
    (B,D), attention MLP 4D→H1→H2→1 as (w, b) pairs. Returns (B, D).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 only), whose gradient is the plain version's (recomputed from
    the inputs in the backward). The batch rides the grid's x extent with
    the clusters, so B past 65,535 launches."""
    args = (hist, mask, target, w1, b1, w2, b2, w3, b3)
    if on_cpu(*args):
        return din_attention_ref(*args)
    return with_plain_gradient(_launch, din_attention_ref, *args)


def _launch(hist, mask, target, w1, b1, w2, b2, w3, b3):
    args = (hist, mask, target, w1, b1, w2, b2, w3, b3)
    B, T, D = hist.shape
    H1, H2 = w1.shape[1], w2.shape[1]
    shapes = {"mask": (B, T), "target": (B, D), "w1": (4 * D, H1),
              "b1": (H1,), "w2": (H1, H2), "b2": (H2,), "w3": (H2, 1),
              "b3": (1,)}
    for name, t in zip(("hist",) + tuple(shapes), args):
        require(t.dtype == torch.float32, f"{name} must be float32")
        require(t.is_contiguous(), f"{name} must be contiguous")
        require(name == "hist" or tuple(t.shape) == shapes[name],
                f"{name} shape {tuple(t.shape)}, expected {shapes.get(name)}")
    require(H1 <= MAX_H1 and H2 <= MAX_H2,
            f"attention MLP {H1}-{H2} exceeds the kernel's tiles "
            f"({MAX_H1}-{MAX_H2})")
    out = torch.empty((B, D), dtype=hist.dtype, device=hist.device)
    if B == 0 or D == 0:
        return out
    launch("din_attention_f32", "din_attention", hist.device,
           *(t.data_ptr() for t in args), out.data_ptr(), B, T, D, H1, H2,
           cost=lambda: cost(*args), bound=BOUND)
    return out


def cost(hist, mask, target, w1, b1, w2, b2, w3, b3) -> tuple[int, int]:
    """(flops, bytes) of one call, the work its roofline bound counts:
    the first layer's target half once per row (the decomposed layer),
    the rest of the unit and the pooling for each unmasked step (the
    mask's non-zeros, read on the host; on ``meta`` :data:`BOUND`);
    bytes: each input read once, the (B, D) output written once."""
    B, T, D = hist.shape
    H1, H2 = w1.shape[1], w2.shape[1]
    active = B * T if is_dry(mask) else int((mask != 0).sum())
    flops = (B * 2 * D * H1 + active * (4 * D * H1 + D + 2 * H1 * H2
                                        + 2 * H2 + 2 * D))
    nbytes = sum(t.numel() * t.element_size()
                 for t in (hist, mask, target, w1, b1, w2, b2, w3, b3))
    return flops, nbytes + B * D * hist.element_size()
