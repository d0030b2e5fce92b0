"""The traffic generator: ids and history lengths drawn from ``--seed``,
the ids on the device in a few large calls.

Frozen from the port's ``data/synthetic.py`` (``zipf_ids``,
``recsys_ids``, ``recsys_batch``): the same Zipf law (Devroye's rejection
method, as numpy's ``Generator.zipf`` draws it, folded into the table by
``(z - 1) % vocab``), the same bags and the same -1 padding after each
history's valid length. The sizes are not drawn: every seed gets the same
multiset of lengths (quantiles of the mix's law),
in an order of its own, so that a seed changes which ids are served and
not how much work there is.
"""
from __future__ import annotations

import numpy as np
import torch

def seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 63-bit seeds derived from ``seed``."""
    state = np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)
    return [int(s) >> 1 for s in state]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def zipf(gen: torch.Generator, n: int, vocab: int, a: float) -> torch.Tensor:
    """(n,) int64 ids in [0, vocab): Zipf(a) draws z folded as
    ``(z - 1) % vocab``, drawn on ``gen``'s device in float64."""
    dev = gen.device
    am1 = a - 1.0
    b = 2.0 ** am1
    out = torch.empty(n, dtype=torch.int64, device=dev)
    filled = 0
    while filled < n:
        m = int((n - filled) * 1.3) + 1024
        u = 1.0 - torch.rand(m, generator=gen, device=dev, dtype=torch.float64)
        v = torch.rand(m, generator=gen, device=dev, dtype=torch.float64)
        x = torch.floor(u.pow(-1.0 / am1))
        t = (1.0 + 1.0 / x).pow(am1)
        ok = (x >= 1.0) & (x < 2.0 ** 63) & (v * x * (t - 1.0) / (b - 1.0)
                                             <= t / b)
        z = x[ok]
        k = min(z.numel(), n - filled)
        out[filled:filled + k] = z[:k].to(torch.int64)
        filled += k
    return (out - 1) % vocab


def quantile_ints(n: int, lo: int, hi: int) -> np.ndarray:
    """(n,) integers spread uniformly over [lo, hi]: the (i + 0.5) / n
    quantiles of the uniform law on those integers."""
    q = (np.arange(n) + 0.5) / n
    return lo + np.floor(q * (hi - lo + 1)).astype(np.int64)


def permutation(gen: torch.Generator, n: int) -> np.ndarray:
    return torch.randperm(n, generator=gen, device=gen.device).cpu().numpy()


def field_ids(gen: torch.Generator, field: dict, rows: int,
              a: float) -> torch.Tensor:
    """A field's ids for ``rows`` rows: (rows,), or (rows, bag)."""
    ids = zipf(gen, rows * field["bag"], field["vocab"], a)
    return ids if field["bag"] == 1 else ids.view(rows, field["bag"])


def history(gen: torch.Generator, lengths: np.ndarray, T: int, vocab: int,
            a: float) -> torch.Tensor:
    """(len(lengths), T) item ids, -1 after each row's valid length."""
    rows = len(lengths)
    ids = zipf(gen, rows * T, vocab, a).view(rows, T)
    lens = torch.as_tensor(lengths, device=gen.device)
    valid = torch.arange(T, device=gen.device)[None, :] < lens[:, None]
    return torch.where(valid, ids, torch.full_like(ids, -1))


def pairs_batch(gen: torch.Generator, cfg: dict, traffic: dict) -> dict:
    """One batch of independent (user, item) pairs in the layout of the
    program's ``serve_scores``: {"user": {"fields", "hist"}, "item"}."""
    B, a, T = traffic["batch"], traffic["zipf_a"], cfg["seq_len"]
    lo, hi = traffic["hist_len"]
    lengths = quantile_ints(B, lo, hi)[permutation(gen, B)]
    user = {f["name"]: field_ids(gen, f, B, a) for f in cfg["user_fields"]}
    item = {f["name"]: field_ids(gen, f, B, a) for f in cfg["item_fields"]}
    return {"user": {"fields": user,
                     "hist": history(gen, lengths, T, item_vocab(cfg), a)},
            "item": item}


def item_vocab(cfg: dict) -> int:
    return next(f["vocab"] for f in cfg["item_fields"]
                if f["name"] == "item_id")

