"""Plain PyTorch version of the MLA latent-decode kernel (its CPU path
and the oracle it is held against on the card): the absorbed decode in
float32 over each row's valid latents."""
import torch

#: the score of a row past a sequence's length
EMPTY = -1e30


def mla_decode_ref(q_c, q_rope, c_cache, r_cache, lengths, scale):
    """q_c (B,H,L) (the query absorbed through ``wk_b``), q_rope (B,H,R),
    latent caches c (B,S,L) and r (B,S,R), lengths (B,) valid rows → o_lat
    (B,H,L) in q_c's dtype: softmax_j((q_c·c_j + q_rope·r_j) · scale) over
    j < lengths[b], times c_j, every sum in float32. A row of length 0
    gives 0, as the kernel does."""
    S = c_cache.shape[1]
    s = (torch.einsum("bhl,bsl->bhs", q_c.float(), c_cache.float())
         + torch.einsum("bhr,bsr->bhs", q_rope.float(), r_cache.float()))
    valid = (torch.arange(S, device=q_c.device)
             < lengths.to(q_c.device).reshape(-1, 1))[:, None]   # (B,1,S)
    s = torch.where(valid, s * scale, EMPTY)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return torch.einsum("bhs,bsl->bhl", p, c_cache.float()).to(q_c.dtype)
