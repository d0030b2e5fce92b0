"""PyTorch + CUDA port of the JiZHI serving stack.

The package mirrors ``repro``'s module layout (``sparse/``, ``models/``,
``kernels/``, ``serve/``, ``core/`` ...) so every module has a
counterpart of the same name, and imports neither ``jax`` nor ``repro``.
The kernels on the serving path are hand-written CUDA C++ for Hopper
(``kernels/csrc``); every kernel keeps a plain PyTorch version beside it,
taken only for tensors that lie on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device and without ``device="cpu"`` they raise.

Float32 matrix products and convolutions run in full float32: TF32 is
switched off here, package-wide, because the parity tolerances (2e-5)
are tighter than TF32's three decimal digits.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``. Asking for
    ``cuda`` on a machine without a CUDA device raises instead of falling
    back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
