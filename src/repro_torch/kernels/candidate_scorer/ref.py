"""Plain PyTorch version of the candidate scorer (its CPU path and the
oracle it is held against on the card)."""
import torch


def candidate_scorer_ref(cands, query, k: int):
    """cands (C, D), query (D,) → (top-k values desc, top-k indices)."""
    return torch.topk(cands.float() @ query.float(), k)
