"""Shape bucketing for the serving model calls.

The SEDP micro-batcher hands the DNN stage whatever batch it collected and
the shedder hands the re-rank path whatever candidate set survived pruning —
so B, C and the user's history length all vary request to request. Padding
each dimension up to a small fixed set of buckets bounds the number of
distinct shapes the model ever sees (TF-Serving / JiZHI practice): the
reference bounds its jit trace count with it, and the port keeps the same
bound, the shape set a per-bucket CUDA graph would capture.

Three pieces:

  * ``ShapeBucketer`` — maps a runtime size to the smallest covering bucket
    (sizes above the top bucket round up to a multiple of it, so the shape
    set stays bounded even under pathological inputs).
  * ``compact_history`` — the history-side twin: gathers the VALID (id >= 0)
    rows of a padded history to the front and re-pads to a bucket, so the
    fused re-rank scores only ``bucket(T_valid)`` rows instead of the full
    padded T. Exact: masked rows contribute zero attention weight.
  * ``TracedJit`` — an eager call plus a distinct-shape-signature counter;
    tests assert the count stays at the bucket-set size.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import default_device


def pow2_buckets(max_size: int, min_size: int = 4) -> tuple[int, ...]:
    """Powers of two from ``min_size`` up to and including ``max_size``
    (``max_size`` itself is always a bucket, power of two or not)."""
    sizes = []
    b = min_size
    while b < max_size:
        sizes.append(b)
        b *= 2
    sizes.append(max_size)
    return tuple(sizes)


def step_buckets(max_size: int, step: int = 8) -> tuple[int, ...]:
    """Multiples of ``step`` up to and including ``max_size``: more shapes
    than pow2 (max_size/step of them) but ≤ step−1 rows of padding per
    call. Worth it for the fused re-rank's history dimension, where padded
    rows still pay the full attention MLP."""
    sizes = list(range(step, max_size, step))
    sizes.append(max_size)
    return tuple(sizes)


@dataclass(frozen=True)
class ShapeBucketer:
    """Pads a varying dimension to a fixed menu of sizes."""
    sizes: tuple[int, ...]

    def __post_init__(self):
        if not self.sizes or any(s <= 0 for s in self.sizes):
            raise ValueError(f"bad bucket sizes {self.sizes}")
        object.__setattr__(self, "sizes", tuple(sorted(set(self.sizes))))

    def fit(self, n: int) -> int:
        """Smallest bucket >= n; beyond the top bucket, the next multiple of
        it (bounded cache: overflow shapes reuse one arithmetic family)."""
        for s in self.sizes:
            if n <= s:
                return s
        top = self.sizes[-1]
        return ((n + top - 1) // top) * top

    def pad_rows(self, xs: list, n: Optional[int] = None) -> list:
        """Pad a list of payload rows to the covering bucket by repeating the
        last row. Callers must slice stage outputs back to ``len(xs)`` so the
        filler rows never leak (per-row ops make them pure dead weight)."""
        n = len(xs) if n is None else n
        target = self.fit(n)
        return list(xs) + [xs[-1]] * (target - len(xs))


def compact_history(hist_ids: np.ndarray,
                    bucketer: Optional[ShapeBucketer] = None) -> np.ndarray:
    """(T,) int ids, -1 = padding → valid ids gathered to the front, padded
    with -1 to ``bucket(n_valid)`` (or to a multiple of 8 without a
    bucketer). Attention pooling is order-agnostic and masked rows carry
    zero weight, so scoring the compacted history is exact — the fused
    re-rank pays O(bucket(T_valid)) instead of O(T_padded)."""
    hist_ids = np.asarray(hist_ids)
    valid = hist_ids[hist_ids >= 0]
    n = max(1, len(valid))
    target = bucketer.fit(n) if bucketer is not None else ((n + 7) // 8) * 8
    out = np.full(target, -1, dtype=hist_ids.dtype)
    out[:len(valid)] = valid
    return out


def bucketed_candidate_rerank(score_fn, params, hist_ids, user_fields,
                              cands, cand_buckets: ShapeBucketer,
                              hist_buckets: ShapeBucketer,
                              item_fields=(), keep: int = 12,
                              device=None) -> list:
    """One request's candidate set through a fused shared-history scorer,
    every varying dimension padded to a bucket, inputs built on ``device``.

    ``cands``: list of (item_id, recall_score). ``score_fn(params,
    user_batch, cand_ids)`` must return a FULL ranking of the padded set
    (top_k == padded C) as (values, indices) sorted best-first — the
    bucket filler repeats candidate 0's id and is dropped here by index,
    so top_k < padded C would let filler crowd out real candidates.
    ``item_fields``: (name, bag) pairs for the non-item_id candidate
    fields (zero-filled — recall output carries ids only).
    ``hist_ids=None`` serves history-free scorers: the user batch carries
    fields only.
    Returns the top ``keep`` real candidates as [(item_id, score)], scores
    on the probability scale (sigmoid of the ranking logits — the same
    scale ``serve_scores`` puts in ``payload["score"]``).
    """
    dev = default_device(device)

    def to_dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)

    C = len(cands)
    Cp = cand_buckets.fit(C)
    ids = np.fromiter((c[0] for c in cands), np.int64, C)
    ids_p = np.concatenate([ids, np.full(Cp - C, ids[0])])
    user = {"fields": {k: to_dev(v)[None] for k, v in user_fields.items()}}
    if hist_ids is not None:
        hist = compact_history(np.asarray(hist_ids), hist_buckets)
        user["hist"] = to_dev(hist)[None]
    cand_ids = {"item_id": to_dev(ids_p)}
    for name, bag in item_fields:
        shape = (Cp,) if bag == 1 else (Cp, bag)
        cand_ids[name] = torch.zeros(shape, dtype=torch.int64, device=dev)
    v, i = score_fn(params, user, cand_ids)
    v = v.cpu().numpy().astype(np.float64)
    i = i.cpu().numpy()
    probs = 1.0 / (1.0 + np.exp(-v))            # monotone: ranking unchanged
    return [(int(ids_p[j]), float(s))
            for s, j in zip(probs, i) if j < C][:keep]


def _leaves(tree) -> list:
    """Leaves of nested dicts (sorted keys), lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@dataclass
class TracedJit:
    """An eager call plus a distinct-shape-signature counter.

    PyTorch runs eagerly, so there is no trace to cache; ``n_traces``
    counts the distinct (shape, dtype) signatures the function has been
    called with — the reference's jit-cache size for shape-only retrace
    triggers, which is all the serving path has."""
    fn: Callable
    signatures: set = field(default_factory=set)

    def __call__(self, *args, **kwargs):
        sig = tuple(
            (tuple(leaf.shape), str(leaf.dtype)) if hasattr(leaf, "shape")
            else repr(leaf)
            for leaf in _leaves((args, kwargs)))
        self.signatures.add(sig)
        return self.fn(*args, **kwargs)

    @property
    def n_traces(self) -> int:
        return len(self.signatures)
