"""Plain PyTorch version of the candidate scorer (its CPU path and the
oracle it is held against on the card)."""
from repro_torch.topk import ordered_topk


def candidate_scorer_ref(cands, query, k: int):
    """cands (C, D), query (D,) → (top-k values desc, top-k indices), the
    lower index first among equal values."""
    return ordered_topk(cands.float() @ query.float(), k)
