"""Wrapper of the din_attention kernel (``csrc/din_attention.cu``).

One launch a call, on one of two paths that the C entry chooses from the
shape alone: with chunks = ceil(T / CHUNK) and R the cluster path's
blocks the card holds at once (528 on an H100 at D = 18: B <= 75 at
T = 100), B * chunks <= R takes the cluster path, a cluster of up to
MAX_CLUSTER blocks over each row's chunks (serving latency, B = 16), as
do chunks > BULK_THREADS and D past 55 (the bulk path's shared memory).
A larger batch takes the bulk path: one wave of persistent blocks that
stage the weights once, compute only the chunks whose mask holds a
non-zero, BULK_TILES of them packed into a product of BULK_TILES * CHUNK
steps, each thread owning REG_STEPS steps x REG_UNITS units of each layer
(a column of units takes UNIT_PAD floats of a weight row). Both kernels
are named ``din_attention_fused``. :func:`computed_steps` reads the
kernel's steps counter: how often the bulk path's skip engages."""
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
#: the bulk path: threads a block (``kBulkThreads``, also the most chunks
#: it takes), chunks packed into a group (``kBulkTiles``), entries of a
#: block's ring of (row, tile) (``kBulkList``), a thread's steps and units
#: in both layers (``kRegSteps``, ``kRegUnits``) and the floats a column of
#: units takes in a weight row (``kUnitPad``)
BULK_THREADS, BULK_TILES, BULK_LIST = 256, 8, 512
REG_STEPS, REG_UNITS, UNIT_PAD = 4, 10, 12


@recorded("din_attention", din_attention_ref)
def din_attention(hist, mask, target, w1, b1, w2, b2, w3, b3):
    """Fused DIN local activation unit: hist (B,T,D), mask (B,T), target
    (B,D), attention MLP 4D→H1→H2→1 as (w, b) pairs. Returns (B, D).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 only), whose gradient is the plain version's (recomputed from
    the inputs in the backward). Past what the card holds as clusters the
    kernel skips the history chunks whose mask is all zero: exact, since
    their steps' weights are multiplied by zero. The batch rides the
    grid's x extent, so B past 65,535 launches."""
    args = (hist, mask, target, w1, b1, w2, b2, w3, b3)
    if on_cpu(*args):
        return din_attention_ref(*args)
    return with_plain_gradient(_launch, din_attention_ref, *args)


def computed_steps(hist, mask, target, w1, b1, w2, b2, w3, b3) -> int:
    """History steps the kernel computes on these CUDA inputs, CHUNK a
    computed chunk (padding past T included), from one launch with the
    kernel's steps counter on: B * chunks * CHUNK on the cluster path, the
    chunks with a non-zero mask entry on the bulk path. Over the mask's
    non-zeros it reads steps computed a valid step. No serving or training
    path turns the counter on."""
    steps = torch.zeros(1, dtype=torch.int64, device=hist.device)
    _launch(hist, mask, target, w1, b1, w2, b2, w3, b3, steps=steps)
    return int(steps.item())


def _launch(hist, mask, target, w1, b1, w2, b2, w3, b3, steps=None):
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
           None if steps is None else steps.data_ptr(),
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
