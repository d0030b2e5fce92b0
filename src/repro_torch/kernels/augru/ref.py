"""Plain PyTorch version of the AUGRU kernel (its CPU path and the oracle
it is held against on the card)."""
import torch


def augru_ref(x, att, w, u, b):
    """x (B,T,Din), att (B,T), w (Din,3H), u (H,3H), b (3H,) → final h (B,H).
    Gate order [r | z | n]; AUGRU scales the update gate by attention."""
    B, T, _ = x.shape
    H = u.shape[0]
    h = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    for t in range(T):
        gx = x[:, t] @ w + b
        gh = h @ u
        r = torch.sigmoid(gx[:, :H] + gh[:, :H])
        z = torch.sigmoid(gx[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gx[:, 2 * H:] + r * gh[:, 2 * H:])
        z = z * att[:, t, None]
        h = (1 - z) * h + z * n
    return h
