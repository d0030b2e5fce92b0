"""Wrapper of the candidate scorer (``csrc/candidate_scorer.cu``): the
kernel scores blocks of candidates and keeps each block's top-k; the
small cross-block merge is a top-k in ``lax.top_k``'s order here, as the
reference merges outside its kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels import (launch, on_cpu, recorded, refuse_grad,
                                 require)
from repro_torch.kernels.candidate_scorer.ref import candidate_scorer_ref

#: candidates per block at most (``kBlockC`` in the source)
BLOCK_C = 1024
#: k up to which each block selects by k rounds of argmax, by a bitonic
#: sort above (``kArgmaxMaxK`` in the source, which states the crossover
#: measured on the card); the kernel sizes its block from C
ARGMAX_MAX_K = 16
_ENTRY = {torch.float32: "candidate_scorer_f32",
          torch.bfloat16: "candidate_scorer_bf16"}


@recorded("candidate_scorer", candidate_scorer_ref)
def candidate_scorer(cands, query, k: int = 8):
    """cands (C, D) float32 or bfloat16, query (D,) of the same dtype →
    the exact global top-k: values (k,) float32, best first, and their
    indices (k,) int64. Scores accumulate in float32. The order is
    ``lax.top_k``'s: the floats' total order (-inf and NaN scores rank
    like any other), and on equal scores the lower index first; the
    kernel orders each block so, and the merge orders the blocks' winners
    by the same rank. Every index is a real row (k <= C).
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which has no backward: it raises where autograd would record the
    call."""
    if on_cpu(cands, query):
        return candidate_scorer_ref(cands, query, k)
    refuse_grad("candidate_scorer", cands, query)
    require(cands.dim() == 2, f"cands (C, D) expected, got {tuple(cands.shape)}")
    C, D = cands.shape
    require(tuple(query.shape) == (D,),
            f"query {tuple(query.shape)}, expected {(D,)}")
    require(cands.dtype in _ENTRY and query.dtype == cands.dtype,
            f"cands {cands.dtype} / query {query.dtype} unsupported")
    require(cands.is_contiguous() and query.is_contiguous(),
            "cands and query must be contiguous")
    require(0 < k <= C, f"k={k} must lie in [1, C={C}]")
    blocks = -(-C // BLOCK_C)
    vals = torch.empty((blocks * k,), dtype=torch.float32, device=cands.device)
    idx = torch.empty((blocks * k,), dtype=torch.int64, device=cands.device)
    # the winners' ranks, for the merge: one block's output is the answer
    ranks = (None if blocks == 1 else
             torch.empty((blocks * k,), dtype=torch.int64, device=cands.device))
    per = 16 // cands.element_size()              # values per 16-byte load
    vec = int(D % per == 0 and cands.data_ptr() % 16 == 0
              and query.data_ptr() % 16 == 0)
    launch(_ENTRY[cands.dtype], "candidate_scorer", cands.device,
           cands.data_ptr(), query.data_ptr(), vals.data_ptr(), idx.data_ptr(),
           C, D, k, vec, None if ranks is None else ranks.data_ptr(),
           cost=lambda: cost(cands, query, k))
    if blocks == 1:                   # one block: already the sorted top-k
        return vals, idx
    return merge_blocks(ranks, vals, idx, k)


def cost(cands, query, k: int) -> tuple[int, int]:
    """(flops, bytes) of one call, the work its roofline bound counts: the
    C dot products; bytes: the candidates and the query read once, the k
    float32 values and int64 indices written once."""
    C, D = cands.shape
    nbytes = (cands.numel() * cands.element_size()
              + query.numel() * query.element_size())
    return 2 * C * D, nbytes + 12 * k


def merge_blocks(ranks, vals, idx, k: int):
    """The global top-k from the blocks' winners as the kernel writes them:
    for each winner its score, its index and its rank, the int64 that
    orders (score, index) as ``lax.top_k`` does (``rank_of`` in the
    source: the score's total-order key in the high 32 bits, the index's
    complement in the low 32); a slot without a row (a block of fewer than
    k rows) has the least int64, below every row. Every rank is distinct,
    so a top-k of the ranks has one answer and gives the global order. No
    host sync: a CUDA graph can hold it."""
    _, pos = torch.topk(ranks, k)
    return vals[pos], idx[pos]
