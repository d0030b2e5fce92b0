"""Top-k in ``jax.lax.top_k``'s order: values descending in the float's
total order, and among equal values the lower index first.

``torch.topk`` leaves the order of equal values open: on the same input it
may return other indices than the reference, and where equal values
straddle the k-th place even another set of them. Equal scores occur on
the serving paths (one item twice among a request's candidates, two ids
hashed to one table row), so every ranking of the port goes through
:func:`ordered_topk`.

``lax.top_k`` orders floats totally, as their sign-magnitude bits do:
+NaN above +inf, +0 above -0, -NaN below -inf. A float comparison (and so
``torch.sort`` on the values) ties +0 with -0 and puts every NaN first, so
the sort runs on :func:`total_order_key` instead.
"""
from __future__ import annotations

import torch

#: the signed integer type of each float type's width
_BITS_AS = {torch.float16: torch.int16, torch.bfloat16: torch.int16,
            torch.float32: torch.int32, torch.float64: torch.int64}


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """Signed integers that order as ``lax.top_k`` orders the floats ``x``:
    the bits as a signed integer, with the magnitude bits flipped where the
    sign bit is set (so a larger negative magnitude gives a smaller key).
    Integer inputs are their own key."""
    as_int = _BITS_AS.get(x.dtype)
    if as_int is None:
        return x
    bits = x.contiguous().view(as_int)
    width = torch.iinfo(as_int).bits
    return bits ^ ((bits >> (width - 1)) & torch.iinfo(as_int).max)


def ordered_topk(x: torch.Tensor, k: int):
    """The ``k`` largest entries of ``x`` along its last axis, best first,
    as (values, int64 indices), in ``lax.top_k``'s order: a stable
    descending sort of :func:`total_order_key`, cut to ``k``. Raises
    ``ValueError`` unless ``0 <= k <= x.shape[-1]``, as ``torch.topk`` and
    ``lax.top_k`` refuse such a ``k``."""
    n = x.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"top-k: k={k} must lie in [0, {n}]")
    i = torch.sort(total_order_key(x), dim=-1, descending=True,
                   stable=True).indices[..., :k]
    return torch.gather(x, -1, i), i


def merge_topk(values: torch.Tensor, indices: torch.Tensor, k: int):
    """The ``k`` best of candidate lists gathered from several ranks, in
    ``lax.top_k``'s order over the global ``indices``: key descending,
    the lower index first among equal keys; entries with index -1 (a
    rank's padding) come last."""
    order = torch.sort(indices, stable=True).indices
    order = order[torch.sort(total_order_key(values[order]), descending=True,
                             stable=True).indices]
    valid = (indices[order] >= 0).to(torch.int8)
    order = order[torch.sort(valid, descending=True, stable=True).indices][:k]
    return values[order], indices[order]


def merge_over_mesh(values: torch.Tensor, indices: torch.Tensor, start: int,
                    k: int, axes=("data", "model")):
    """A rank's top-k (values, indices local to its block of a vector split
    over ``axes``, which starts at global index ``start``) merged with
    every other rank's into the global top ``k`` (:func:`merge_topk`), the
    same on every rank. No mesh: the lists as they are."""
    from repro_torch import runtime
    if runtime.current_mesh() is None or runtime.axes_size(axes) == 1:
        return values, indices
    pad = k - values.shape[-1]
    values = torch.nn.functional.pad(values, (0, pad))
    indices = torch.nn.functional.pad(indices + start, (0, pad), value=-1)
    return merge_topk(runtime.all_gather(values, axes),
                      runtime.all_gather(indices, axes), k)


def sharded_topk(x: torch.Tensor, k: int, n: int, axes=("data", "model")):
    """:func:`ordered_topk` of a length-``n`` vector of which each rank
    holds its block over ``axes`` (``runtime.block``; padding past ``n``
    ignored): each rank's top-k, merged (:func:`merge_over_mesh`)."""
    from repro_torch import runtime
    if not 0 <= k <= n:
        raise ValueError(f"top-k: k={k} must lie in [0, {n}]")
    start, per = runtime.block(n, axes)
    valid = max(0, min(per, n - start))
    v, i = ordered_topk(x[:valid], min(k, valid))
    return merge_over_mesh(v, i, start, k, axes)
