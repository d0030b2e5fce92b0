"""Wrapper of the MLA latent-decode kernel (``csrc/mla_decode.cu``).

Absorbed MLA decode of one new token a sequence: 16 query heads score
against one latent row shared by every head (the 512-wide ``c`` with the
64-wide rope key ``r``) and sum the same 512-wide ``c`` rows as their
values. The kernel's persistent blocks, one wave of them (:func:`blocks`,
read once a device), split the sequences' valid rows, laid end to end,
into equal ranges, so the work a block does does not depend on how the
lengths are spread; a second kernel merges each sequence's partial
results in a fixed order. The lengths are read on the device, so a
decode loop never waits on the host and the launches can be captured
into a CUDA graph. :func:`rows_read` reads the kernel's rows counter.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels import (is_dry, launch, on_cpu, recorded,
                                 refuse_grad, require)
from repro_torch.kernels.mla_decode.ref import mla_decode_ref

#: query heads, latent width and rope width the kernel is built for
#: (``kHeads``, ``kLat``, ``kRope`` in the source): DeepSeek-V2-Lite's
HEADS, LATENT, ROPE = 16, 512, 64
#: cache rows a block tile holds (``kTile``) and its warps (``kWarps``)
TILE, WARPS = 64, 4
#: floats of one partial result: m per head, l per warp and head, acc
PART = HEADS * (1 + WARPS + LATENT)
#: what the cost takes on ``meta``, where it cannot read the lengths
BOUND = "every row's length taken as the cache's S rows (every row valid)"
_blocks: dict = {}


def takes(q_c, c_cache) -> bool:
    """True where the kernel's geometry is the call's: HEADS query heads
    over a LATENT + ROPE latent cache, in bf16."""
    return (q_c.dim() == 3 and q_c.shape[1:] == (HEADS, LATENT)
            and c_cache.shape[-1] == LATENT
            and q_c.dtype == c_cache.dtype == torch.bfloat16)


def blocks(device: torch.device) -> int:
    """Blocks of the kernel the card holds at once (SM count x resident
    blocks an SM), from the CUDA occupancy calculator; read once a
    device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _blocks:
        res = (ctypes.c_int * 2)()
        with torch.cuda.device(device):
            err = K.kernel("mla_decode_residency", device)(
                ctypes.addressof(res), None)
        if err != 0 or res[0] < 1:
            raise RuntimeError(f"mla_decode: no resident block (CUDA error "
                               f"{err})")
        _blocks[idx] = res[0] * res[1]
    return _blocks[idx]


@recorded("mla_decode", mla_decode_ref)
def mla_decode(q_c, q_rope, c_cache, r_cache, lengths, scale):
    """q_c (B,16,512) the new token's queries absorbed through ``wk_b``,
    q_rope (B,16,64), latent caches c (B,S,512) and r (B,S,64), lengths
    (B,) int32 valid rows on q_c's device → o_lat (B,16,512), in bf16:
    softmax_j((q_c·c_j + q_rope·r_j) · scale) over j < lengths[b], times
    c_j. Scores, softmax and sums in float32 (bf16 products on the tensor
    cores); p is rounded to bf16 for the product with c. Each valid row is
    read once, rows past a length never. CPU tensors take the plain
    version; CUDA tensors launch the kernel, which has no backward (it
    raises where autograd would record the call). A row of length 0 gives
    0."""
    if on_cpu(q_c, q_rope, c_cache, r_cache, lengths):
        return mla_decode_ref(q_c, q_rope, c_cache, r_cache, lengths, scale)
    refuse_grad("mla_decode", q_c, q_rope, c_cache, r_cache)
    return _launch(q_c, q_rope, c_cache, r_cache, lengths, scale)


def rows_read(q_c, q_rope, c_cache, r_cache, lengths, scale) -> int:
    """Cache rows the kernel loads on these CUDA inputs, from one launch
    with its rows counter on (every valid row once, no padding: over the
    lengths' sum it reads 1). No serving path turns the counter on."""
    rows = torch.zeros(1, dtype=torch.int64, device=q_c.device)
    _launch(q_c, q_rope, c_cache, r_cache, lengths, scale, rows)
    return int(rows.item())


def _launch(q_c, q_rope, c_cache, r_cache, lengths, scale, rows=None):
    B = q_c.shape[0]
    require(c_cache.dim() == 3, f"c_cache (B,S,{LATENT}) expected, got "
                                f"{tuple(c_cache.shape)}")
    S = c_cache.shape[1]
    shapes = {"q_c": (B, HEADS, LATENT), "q_rope": (B, HEADS, ROPE),
              "c_cache": (B, S, LATENT), "r_cache": (B, S, ROPE)}
    for name, t in (("q_c", q_c), ("q_rope", q_rope), ("c_cache", c_cache),
                    ("r_cache", r_cache)):
        require(tuple(t.shape) == shapes[name],
                f"{name} {tuple(t.shape)}, expected {shapes[name]}")
        require(t.dtype == torch.bfloat16, f"{name} must be bfloat16")
        require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                f"{name} must be contiguous and 16-byte aligned")
    require(tuple(lengths.shape) == (B,) and lengths.dtype == torch.int32
            and lengths.is_contiguous() and lengths.device == q_c.device,
            "lengths must be (B,) int32 on q_c's device")
    out = torch.empty((B, HEADS, LATENT), dtype=q_c.dtype, device=q_c.device)
    if B == 0:
        return out
    if is_dry(q_c):
        launch("mla_decode_bf16", "mla_decode", q_c.device,
               cost=lambda: cost(B, S * B), bound=BOUND)
        return out
    nb = blocks(q_c.device)
    work = torch.empty(((nb + B) * PART,), dtype=torch.float32,
                       device=q_c.device)
    launch("mla_decode_bf16", "mla_decode", q_c.device,
           q_c.data_ptr(), q_rope.data_ptr(), c_cache.data_ptr(),
           r_cache.data_ptr(), lengths.data_ptr(), work.data_ptr(),
           out.data_ptr(), None if rows is None else rows.data_ptr(),
           B, S, nb, float(scale),
           cost=lambda: cost(B, int(lengths.clamp(0, S).sum())))
    return out


def cost(B: int, rows: int) -> tuple[int, int]:
    """(flops, bytes) of one call over ``rows`` valid cache rows in all:
    the scores (HEADS x (LATENT + ROPE) multiply-adds a row) and p·c
    (HEADS x LATENT); bytes: each valid row's c and r once, q read once
    and o written once, in bf16 (the partials and lengths left out)."""
    flops = rows * HEADS * (2 * LATENT + ROPE) * 2
    nbytes = (rows * (LATENT + ROPE) + B * HEADS * (2 * LATENT + ROPE)) * 2
    return flops, nbytes
