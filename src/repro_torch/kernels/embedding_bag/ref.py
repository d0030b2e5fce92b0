"""Plain PyTorch version of the embedding_bag kernel (its CPU path and the
oracle it is held against on the card)."""
import torch


def embedding_bag_ref(table, ids, weights=None, combiner: str = "sum"):
    """table (V, D); ids (B, K) padded multi-hot, clipped to [0, V-1];
    weights (B, K) doubles as the validity mask. → (B, D) in the table's
    dtype."""
    V = table.shape[0]
    vecs = table[ids.long().clamp(0, V - 1)]                    # (B, K, D)
    if weights is None:
        weights = torch.ones(ids.shape, dtype=vecs.dtype, device=vecs.device)
    out = torch.einsum("bk,bkd->bd", weights.to(vecs.dtype), vecs)
    if combiner == "mean":
        out = out / weights.sum(-1, keepdim=True).clamp_min(1e-9).to(out.dtype)
    return out
