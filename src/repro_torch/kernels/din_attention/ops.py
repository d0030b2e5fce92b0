"""Wrapper of the din_attention kernel (``csrc/din_attention.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import launch, on_cpu, require
from repro_torch.kernels.din_attention.ref import din_attention_ref

#: history steps per block (``kChunk`` in the source); sizes the scratch
CHUNK = 32
_MAX_GRID_Y = 65535


def din_attention(hist, mask, target, w1, b1, w2, b2, w3, b3):
    """Fused DIN local activation unit: hist (B,T,D), mask (B,T), target
    (B,D), attention MLP 4D→H1→H2→1 as (w, b) pairs. Returns (B, D).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 only)."""
    args = (hist, mask, target, w1, b1, w2, b2, w3, b3)
    if on_cpu(*args):
        return din_attention_ref(*args)
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
    require(B <= _MAX_GRID_Y, f"B={B} exceeds the grid's y extent")
    out = torch.empty((B, D), dtype=hist.dtype, device=hist.device)
    if B == 0 or D == 0:
        return out
    # per (row, chunk) pooled partials, summed in chunk order by the kernel
    partial = torch.empty((B, -(-T // CHUNK), D), dtype=torch.float32,
                          device=hist.device)
    launch("din_attention_f32", "din_attention", hist.device,
           *(t.data_ptr() for t in args), partial.data_ptr(), out.data_ptr(),
           B, T, D, H1, H2)
    return out
