"""Plain PyTorch version of the flash-decode kernel (its CPU path and the
oracle it is held against on the card); matches
``models.attention.decode_attention``."""
import numpy as np
import torch


def flash_decode_ref(q, k_cache, v_cache, cache_len, scale=None):
    """q (B,H,G,D); caches (B,S,H,D); cache_len scalar → (B,H,G,D), in
    float32 and cast to q's dtype."""
    B, H, G, D = q.shape
    S = k_cache.shape[1]
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k_cache.float()) * scale
    mask = torch.arange(S, device=q.device) < cache_len
    s = torch.where(mask[None, None, None, :], s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhgs,bshd->bhgd", p, v_cache.float()).to(q.dtype)
