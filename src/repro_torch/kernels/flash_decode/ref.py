"""Plain PyTorch version of the flash-decode kernel (its CPU path and the
oracle it is held against on the card); matches
``models.attention.decode_attention`` wherever the valid prefix is not
empty."""
import numpy as np
import torch

#: the log-sum-exp of a row with no valid position (and the mask value)
EMPTY_LSE = -1e30


def flash_decode_ref(q, k_cache, v_cache, cache_len, scale=None,
                     return_lse=False):
    """q (B,H,G,D); caches (B,S,H,D); cache_len scalar → (B,H,G,D), in
    float32 and cast to q's dtype; with ``return_lse`` also the float32
    (B,H,G) log-sum-exp ``m + log(l)`` of each row's scaled scores over
    the valid prefix. A prefix of length 0 (a sequence shard that holds
    no valid row yet) gives 0 and ``EMPTY_LSE``, as the kernel does."""
    B, H, G, D = q.shape
    S = k_cache.shape[1]
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k_cache.float()) * scale
    mask = torch.arange(S, device=q.device) < cache_len
    s = torch.where(mask[None, None, None, :], s, EMPTY_LSE)
    m = s.amax(-1, keepdim=True)
    # masked positions weigh 0 (exp(-1e30 - m) is 0 already wherever a
    # row is valid; on an empty prefix it would be 1)
    p = torch.where(mask[None, None, None, :], torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p / torch.clamp(l, min=1e-30),
                       v_cache.float()).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), EMPTY_LSE)[..., 0]
    return out, lse
