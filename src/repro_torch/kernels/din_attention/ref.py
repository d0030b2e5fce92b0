"""Plain PyTorch version of the din_attention kernel (its CPU path and the
oracle it is held against on the card)."""
import torch
import torch.nn.functional as F


def din_attention_ref(hist, mask, target, w1, b1, w2, b2, w3, b3):
    """hist (B,T,D), mask (B,T), target (B,D);
    attention MLP: 4D → H1 → H2 → 1 (silu), weights (4D,H1),(H1,H2),(H2,1).
    Returns (B, D): activation-weighted sum over history (no softmax —
    DIN paper §4.3 keeps raw weights)."""
    t = target[:, None].expand(hist.shape)
    feat = torch.cat([hist, t, hist - t, hist * t], -1)          # (B,T,4D)
    h = F.silu(feat @ w1 + b1)
    h = F.silu(h @ w2 + b2)
    w = (h @ w3 + b3)[..., 0] * mask                             # (B,T)
    return torch.einsum("bt,btd->bd", w, hist)
