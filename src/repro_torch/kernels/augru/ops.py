"""Wrapper of the fused AUGRU kernel (``csrc/augru.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import launch, on_cpu, require
from repro_torch.kernels.augru.ref import augru_ref

#: a block holds U (H x 3H floats) plus h and two gate rows in shared
#: memory, and runs one thread per gate column
SMEM_BYTES, MAX_THREADS = 232448, 1024


def _smem_bytes(H: int) -> int:
    return 4 * ((3 * H * H + 3) // 4 * 4 + (H + 3) // 4 * 4 + 4 * H)


def augru(x, att, w, u, b):
    """x (B,T,Din), att (B,T), GRU weights w (Din,3H) u (H,3H) b (3H,) →
    final hidden (B,H), float32. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if on_cpu(x, att, w, u, b):
        return augru_ref(x, att, w, u, b)
    require(x.dim() == 3, f"x (B, T, Din) expected, got {tuple(x.shape)}")
    (B, T, Din), H = x.shape, u.shape[0]
    shapes = [(B, T, Din), (B, T), (Din, 3 * H), (H, 3 * H), (3 * H,)]
    for i, (t, shape) in enumerate(zip((x, att, w, u, b), shapes)):
        require(tuple(t.shape) == shape,
                f"argument {i}: shape {tuple(t.shape)}, expected {shape}")
        require(t.dtype == torch.float32, f"argument {i} must be float32")
        require(t.is_contiguous(), f"argument {i} must be contiguous")
    require(H >= 1 and 3 * H <= MAX_THREADS and _smem_bytes(H) <= SMEM_BYTES,
            f"H={H}: U does not fit one block's shared memory")
    out = torch.empty((B, H), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    # the input projection of every step, x @ W + b, written by the kernel
    gx = torch.empty((B * T, 3 * H), dtype=torch.float32, device=x.device)
    launch("augru_f32", "augru", x.device,
           x.data_ptr(), att.data_ptr(), w.data_ptr(), u.data_ptr(),
           b.data_ptr(), gx.data_ptr(), out.data_ptr(), B, T, Din, H)
    return out
