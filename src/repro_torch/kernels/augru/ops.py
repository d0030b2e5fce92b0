"""Wrapper of the fused AUGRU kernel (``csrc/augru.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import (launch, on_cpu, recorded, require,
                                 with_plain_gradient)
from repro_torch.kernels.augru.ref import augru_ref

#: the largest H a block holds U for in registers: 4 threads per hidden
#: unit, 28 rows of U each (``kMaxH`` in the source)
MAX_H = 112


def gx_cols(H: int) -> int:
    """Row stride of the projection scratch: 3H rounded up to whole
    float4s, for the recurrence's 16-byte copies."""
    return -(-3 * H // 4) * 4


@recorded("augru", augru_ref)
def augru(x, att, w, u, b):
    """x (B,T,Din), att (B,T), GRU weights w (Din,3H) u (H,3H) b (3H,) →
    final hidden (B,H), float32. CPU tensors take the plain version; CUDA
    tensors launch the kernel, whose gradient (w.r.t. x, att, w, u, b) is
    the plain version's, recomputed from the inputs in the backward."""
    if on_cpu(x, att, w, u, b):
        return augru_ref(x, att, w, u, b)
    return with_plain_gradient(_launch, augru_ref, x, att, w, u, b)


def _launch(x, att, w, u, b):
    require(x.dim() == 3, f"x (B, T, Din) expected, got {tuple(x.shape)}")
    (B, T, Din), H = x.shape, u.shape[0]
    shapes = [(B, T, Din), (B, T), (Din, 3 * H), (H, 3 * H), (3 * H,)]
    for i, (t, shape) in enumerate(zip((x, att, w, u, b), shapes)):
        require(tuple(t.shape) == shape,
                f"argument {i}: shape {tuple(t.shape)}, expected {shape}")
        require(t.dtype == torch.float32, f"argument {i} must be float32")
        require(t.is_contiguous(), f"argument {i} must be contiguous")
    require(1 <= H <= MAX_H,
            f"H={H}: the kernel holds U in registers for H <= {MAX_H}")
    out = torch.empty((B, H), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    # the input projection of every step, x @ W + b, written by the kernel
    gx = torch.empty((B * T, gx_cols(H)), dtype=torch.float32,
                     device=x.device)
    launch("augru_f32", "augru", x.device,
           x.data_ptr(), att.data_ptr(), w.data_ptr(), u.data_ptr(),
           b.data_ptr(), gx.data_ptr(), out.data_ptr(), B, T, Din, H,
           cost=lambda: cost(x, att, w, u, b))
    return out


def cost(x, att, w, u, b) -> tuple[int, int]:
    """(flops, bytes) of one call, the work its roofline bound counts: the
    input projection x @ W of every step, then each step's h @ U and its
    gates (12 H); bytes: each input read once, the (B, H) final state
    written once (the projection's scratch is the kernel's choice)."""
    (B, T, Din), H = x.shape, u.shape[0]
    flops = 2 * B * T * Din * 3 * H + B * T * (2 * H * 3 * H + 12 * H)
    nbytes = sum(t.numel() * t.element_size() for t in (x, att, w, u, b))
    return flops, nbytes + B * H * 4
