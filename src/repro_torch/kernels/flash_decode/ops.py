"""Wrapper of the split-K flash-decode kernel (``csrc/flash_decode.cu``).

The kernel splits the cache's sequence axis across blocks, one block per
(batch row, kv head, split). :func:`split_plan` sizes the splits from the
shapes and the card alone (its SM count and the kernel's resident blocks
per SM, read once per device), so that the blocks fill whole waves. With
one split the block writes the output itself; otherwise each block writes
a partial (m, l, acc) to a float32 workspace this wrapper allocates and a
second kernel combines the splits in a fixed order. The valid length is
read on the device, so a decode loop never waits on the host, and the
launch can be captured into a CUDA graph. With ``return_lse`` the kernel
also writes each row's float32 log-sum-exp, by which the sequence shards
of a device mesh combine their partial results
(``models/attention.py``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.kernels import (is_dry, launch, on_cpu, recorded,
                                 refuse_grad, require)
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

#: cache rows of a split granule (``kTile`` in the source): each of a
#: block's four warps takes 16-row tiles; chunks are multiples of TILE
TILE = 64
#: the least cache rows a split covers
MIN_CHUNK = 256
#: a block's cost beyond its tiles (q, the ring's fill, the warps' merge,
#: the partial it writes), in tiles: keeps the plan off many tiny splits
SPLIT_OVERHEAD = 2
SMEM_BYTES = 232448
HEAD_DIMS = (16, 32, 64, 128)
#: query heads per kv head the bf16 path takes (two 8-wide mma N tiles)
MAX_GROUP_BF16 = 16
_ENTRY = {torch.float32: "flash_decode_f32", torch.bfloat16: "flash_decode_bf16"}
#: what the cost takes on ``meta``, where it cannot read cache_len
BOUND = "the valid length taken as the cache's S rows (every row valid)"
_slots: dict = {}


@functools.lru_cache(maxsize=4096)
def split_plan(B: int, H: int, S: int, slots: int) -> tuple[int, int]:
    """(chunk, n_split): cache rows per split (a multiple of TILE) and the
    number of splits, from the shapes and ``slots`` (the blocks the card
    holds at once: SM count x resident blocks per SM) alone. Of the
    splittings into chunks of at least MIN_CHUNK rows, the one whose
    waves x (tiles per chunk + SPLIT_OVERHEAD) is least: B·H·n_split
    blocks fill whole waves as far as the shapes allow. Ties go to fewer
    splits (less to combine)."""
    bh, slots = max(1, B * H), max(1, slots)
    best = None
    for n in range(1, max(1, -(-S // MIN_CHUNK)) + 1):
        chunk = -(-(-(-S // n)) // TILE) * TILE
        n_split = -(-S // chunk)
        cost = (-(-bh * n_split // slots) * (chunk // TILE + SPLIT_OVERHEAD),
                n_split)
        if best is None or cost < best[0]:
            best = (cost, chunk, n_split)
    return best[1], best[2]


def smem_bytes(G: int, D: int) -> int:
    """Shared memory of a float32 split block: K and V tiles of 32 rows, q,
    the tile's scores, the accumulator and (m, l, alpha). (A bf16 block
    holds at most 96 KB: four warps' rings of 16-row tiles.)"""
    return 4 * (2 * 32 * D + 2 * G * D + G * 32 + 3 * G)


def device_slots(device: torch.device, dtype, G: int, D: int) -> int:
    """SM count x resident split blocks per SM for (dtype, G, D) on
    ``device``, from the CUDA occupancy calculator; read once per device
    and configuration."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    key = (idx, dtype, G, D)
    if key not in _slots:
        res = (ctypes.c_int * 2)()
        fn = K.kernel("flash_decode_residency", device)
        with torch.cuda.device(device):
            err = fn(int(dtype == torch.bfloat16), G, D, ctypes.addressof(res),
                     None)
        if err != 0 or res[0] < 1:
            raise RuntimeError(f"flash_decode: no resident block for G={G} "
                               f"D={D} {dtype} (CUDA error {err})")
        _slots[key] = res[0] * res[1]
    return _slots[key]


@recorded("flash_decode", flash_decode_ref)
def flash_decode(q, k_cache, v_cache, cache_len, scale=None,
                 return_lse=False):
    """q (B,H,G,D) one new token per sequence, caches (B,S,H,D), cache_len
    the valid prefix (one int32 on q's device; an int too on the CPU) →
    (B,H,G,D) in q's dtype; with ``return_lse`` the pair (out, lse), lse
    the float32 (B,H,G) ``m + log(l)`` of each row's scaled scores over
    the valid prefix. Scores are scaled by ``scale`` (1/√D by default),
    accumulated in float32, positions at or past cache_len masked. CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    reads cache_len on the device (no host sync) and has no backward (it
    raises where autograd would record the call). In bf16 the kernel
    rounds p to bf16 for the PV product, as the TPU kernel does.

    cache_len = 0 (a sequence shard of a mesh that holds no valid row
    yet) gives out = 0 and lse = ``EMPTY_LSE`` (-1e30) in the kernel and
    its plain version alike. The reference's Pallas kernel also gives 0
    there; its jnp oracle, which the single-device model never asks for
    length 0, the mean of V."""
    if on_cpu(q, k_cache, v_cache):
        return flash_decode_ref(q, k_cache, v_cache, cache_len, scale,
                                return_lse)
    refuse_grad("flash_decode", q, k_cache, v_cache)
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
    if q.dtype == torch.bfloat16:
        require(G <= MAX_GROUP_BF16,
                f"G={G}: the bf16 kernel takes at most {MAX_GROUP_BF16} "
                f"query heads per kv head")
    else:
        require(smem_bytes(G, D) <= SMEM_BYTES,
                f"G={G} D={D}: too large a group")
    require(hasattr(cache_len, "data_ptr") and cache_len.numel() == 1
            and cache_len.dtype == torch.int32 and cache_len.device == q.device,
            "cache_len must be one int32 tensor on q's device")
    out = torch.empty((B, H, G, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, G), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B == 0 or H == 0 or G == 0:
        return (out, lse) if return_lse else out
    if is_dry(q):
        # no card to size the splits by: one split, no workspace (the
        # plan changes where the kernel works, not its cost)
        launch(_ENTRY[q.dtype], "flash_decode", q.device,
               cost=lambda: cost(q, k_cache, v_cache, S), bound=BOUND)
        return (out, lse) if return_lse else out
    chunk, n_split = split_plan(B, H, S, device_slots(q.device, q.dtype, G, D))
    # per (b, h, split): m and l per query head, then acc (G, D)
    work = (torch.empty((B * H * n_split * G * (D + 2),), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    launch(_ENTRY[q.dtype], "flash_decode", q.device,
           q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           cache_len.data_ptr(), None if work is None else work.data_ptr(),
           out.data_ptr(), B, H, G, D, S, chunk, n_split,
           float(scale if scale is not None else 1.0 / np.sqrt(D)),
           None if lse is None else lse.data_ptr(),
           cost=lambda: cost(q, k_cache, v_cache, int(cache_len)))
    return (out, lse) if return_lse else out


def cost(q, k_cache, v_cache, L: int) -> tuple[int, int]:
    """(flops, bytes) of one call over a valid prefix of L rows (on a
    mesh, the rank's own shard's), the work its roofline bound counts: q·K
    and p·V over the prefix (4·B·H·G·L·D); bytes: the prefix of K and V
    and q read once, the output written once (the split partials and the
    lse, 4·B·H·G bytes where asked, are left out)."""
    B, H, G, D = q.shape
    item = k_cache.element_size()
    return (4 * B * H * G * L * D,
            2 * B * L * H * D * item + 2 * B * H * G * D * q.element_size())
