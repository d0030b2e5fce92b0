"""Plain PyTorch version of the fused re-rank scorer — the broadcast-
everything math of the pre-fusion serving path (din.attention_pool +
score MLP). It is the kernel's CPU path and the oracle the kernel is held
against on the card."""
import torch
import torch.nn.functional as F


def rerank_score_ref(hist, mask, target, user_other, item_other,
                     a1, ab1, a2, ab2, a3, ab3,
                     m1, mb1, m2, mb2, m3, mb3):
    """hist (T,D), mask (T,), target (C,D), user_other (d_u,),
    item_other (C,d_i) → scores (C,). Materializes the (C,T,4D) feature
    block exactly like the serving path it replaces."""
    C = target.shape[0]
    T, D = hist.shape
    h = hist[None].expand(C, T, D)
    t = target[:, None].expand(C, T, D)
    feat = torch.cat([h, t, h - t, h * t], dim=-1)              # (C,T,4D)
    x = F.silu(feat.reshape(C * T, 4 * D) @ a1 + ab1)
    x = F.silu(x @ a2 + ab2)
    w = (x @ a3 + ab3).reshape(C, T) * mask[None]
    pooled = torch.einsum("ct,td->cd", w, hist)                 # (C,D)
    xx = torch.cat([pooled, target,
                    user_other[None].expand(C, user_other.shape[0]),
                    item_other], dim=-1)
    s = F.silu(xx @ m1 + mb1)
    s = F.silu(s @ m2 + mb2)
    return (s @ m3 + mb3)[:, 0]
