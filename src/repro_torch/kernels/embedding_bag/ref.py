"""Plain PyTorch version of the embedding_bag kernel (its CPU path and the
oracle it is held against on the card)."""
import torch


def embedding_bag_ref(table, ids, weights=None, combiner: str = "sum"):
    """table (V, D); ids (B, K) padded multi-hot, clipped to [0, V-1];
    weights (B, K) doubles as the validity mask. → (B, D) in the table's
    dtype. Its gradient w.r.t. the table is a dense scatter-add of each
    bag's output gradient x its weight (/ sum w for ``mean``) at the
    clipped ids, as ``jnp.take``'s transpose is."""
    V = table.shape[0]
    # index_select, whose gradient is an index_add_ into the table's: a
    # scatter-add of every row read (advanced indexing's gradient sorts
    # the ids and sums each id's run serially, ~1 s at DIN's training
    # batch on the H100, where the hot ids of a Zipf draw repeat 1e5 times)
    flat = ids.long().clamp(0, V - 1).reshape(-1)
    vecs = table.index_select(0, flat).reshape(*ids.shape, table.shape[1])
    if weights is None:
        weights = torch.ones(ids.shape, dtype=vecs.dtype, device=vecs.device)
    out = torch.einsum("bk,bkd->bd", weights.to(vecs.dtype), vecs)
    if combiner == "mean":
        out = out / weights.sum(-1, keepdim=True).clamp_min(1e-9).to(out.dtype)
    return out


def embedding_bag_group_ref(lookups, blocks=None):
    """The grouped call's plain version: one :func:`embedding_bag_ref` per
    (table, ids, weights, combiner) group, the groups of each block of
    ``blocks`` (consecutive group counts; default one a group)
    concatenated along columns."""
    outs = [embedding_bag_ref(*g) for g in lookups]
    blocks = (1,) * len(outs) if blocks is None else blocks
    res, at = [], 0
    for n in blocks:
        res.append(outs[at] if n == 1 else torch.cat(outs[at:at + n], dim=-1))
        at += n
    return res
