"""Wrapper of the split-K flash-decode kernel (``csrc/flash_decode.cu``).

The kernel splits the cache's sequence axis across blocks, one block per
(batch row, kv head, split); each block writes a partial (m, l, acc) to a
float32 workspace this wrapper allocates, and a second kernel combines the
splits in a fixed order. The valid length is read on the device, so a
decode loop never waits on the host, and the launch can be captured into a
CUDA graph.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import launch, on_cpu, require
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

#: cache rows per tile (``kTile`` in the source)
TILE = 32
#: the least cache rows a split covers, and the blocks the split aims for
MIN_CHUNK, TARGET_BLOCKS = 256, 1056
SMEM_BYTES = 232448
HEAD_DIMS = (16, 32, 64, 128)
_ENTRY = {torch.float32: "flash_decode_f32", torch.bfloat16: "flash_decode_bf16"}


def split_plan(B: int, H: int, S: int) -> tuple[int, int]:
    """(chunk, n_split): cache rows per split (a multiple of TILE) and the
    number of splits, fixed by the shapes alone. Each split covers at least
    MIN_CHUNK rows; B·H·n_split aims at TARGET_BLOCKS blocks."""
    n = max(1, min(-(-S // MIN_CHUNK), -(-TARGET_BLOCKS // max(1, B * H))))
    rows = -(-S // n)
    chunk = -(-rows // TILE) * TILE
    return chunk, -(-S // chunk)


def smem_bytes(G: int, D: int) -> int:
    """K and V tiles, q, the tile's scores, the accumulator and (m, l,
    alpha), all float32."""
    return 4 * (2 * TILE * D + 2 * G * D + G * TILE + 3 * G)


def flash_decode(q, k_cache, v_cache, cache_len, scale=None):
    """q (B,H,G,D) one new token per sequence, caches (B,S,H,D), cache_len
    the valid prefix (one int32 on q's device; an int too on the CPU) →
    (B,H,G,D) in q's dtype. Scores are scaled by ``scale`` (1/√D by
    default), accumulated in float32, positions at or past cache_len
    masked. CPU tensors take the plain version; CUDA tensors launch the
    kernel, which reads cache_len on the device (no host sync).

    cache_len = 0 lies outside the references' agreement (the Pallas
    kernel gives 0, its jnp oracle the mean of V); the kernel gives 0. The
    model never asks for it: decode passes the cache length plus one."""
    if on_cpu(q, k_cache, v_cache):
        return flash_decode_ref(q, k_cache, v_cache, cache_len, scale)
    require(q.dim() == 4 and k_cache.dim() == 4,
            f"q (B,H,G,D) and caches (B,S,H,D) expected, got "
            f"{tuple(q.shape)} / {tuple(k_cache.shape)}")
    B, H, G, D = q.shape
    S = k_cache.shape[1]
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        require(tuple(t.shape) == (B, S, H, D),
                f"{name} {tuple(t.shape)}, expected {(B, S, H, D)}")
        require(t.dtype == q.dtype, f"{name} {t.dtype} differs from q {q.dtype}")
    require(q.dtype in _ENTRY, f"dtype {q.dtype} unsupported")
    require(D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                f"{name} must be contiguous and 16-byte aligned")
    require(smem_bytes(G, D) <= SMEM_BYTES, f"G={G} D={D}: too large a group")
    require(hasattr(cache_len, "data_ptr") and cache_len.numel() == 1
            and cache_len.dtype == torch.int32 and cache_len.device == q.device,
            "cache_len must be one int32 tensor on q's device")
    out = torch.empty((B, H, G, D), dtype=q.dtype, device=q.device)
    if B == 0 or H == 0 or G == 0:
        return out
    chunk, n_split = split_plan(B, H, S)
    # per (b, h, split): m and l per query head, then acc (G, D)
    work = torch.empty((B * H * n_split * G * (D + 2),), dtype=torch.float32,
                       device=q.device)
    launch(_ENTRY[q.dtype], "flash_decode", q.device,
           q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           cache_len.data_ptr(), work.data_ptr(), out.data_ptr(),
           B, H, G, D, S, chunk, n_split,
           float(scale if scale is not None else 1.0 / np.sqrt(D)))
    return out
