"""Top-k in ``jax.lax.top_k``'s order: values descending, and among equal
values the lower index first.

``torch.topk`` leaves the order of equal values open: on the same input it
may return other indices than the reference, and where equal values
straddle the k-th place even another set of them. Equal scores occur on
the serving paths (one item twice among a request's candidates, two ids
hashed to one table row), so every ranking of the port goes through
:func:`ordered_topk`.
"""
from __future__ import annotations

import torch


def ordered_topk(x: torch.Tensor, k: int):
    """The ``k`` largest entries of ``x`` along its last axis, best first,
    as (values, int64 indices); on equal values the lower index comes
    first, as ``jax.lax.top_k`` orders them: a stable sort, cut to ``k``.
    Raises ``ValueError`` unless ``0 <= k <= x.shape[-1]``, as
    ``torch.topk`` and ``lax.top_k`` refuse such a ``k``."""
    n = x.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"top-k: k={k} must lie in [0, {n}]")
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]
