"""Feature signatures via universal hashing (paper §5.1).

The cube keys every sparse parameter by a *compact feature signature*: a
universally-unique identifier derived from (feature-group, raw id) via a
universal hash family (Carter & Wegman). The same signature function is
used host-side (ParameterCube) and device-side (hashed embedding lookup),
so cube contents and device tables agree.
"""
from __future__ import annotations

import numpy as np
import torch

# 64-bit universal multiply-shift family with fixed, documented constants.
_MUL = np.uint64(0x9E3779B97F4A7C15)  # golden-ratio odd multiplier
_XOR = np.uint64(0xBF58476D1CE4E5B9)

_M32 = 0xFFFFFFFF


def signature_np(group: np.ndarray | int, raw_id: np.ndarray | int) -> np.ndarray:
    """uint64 feature signature, numpy (host / cube side)."""
    g = np.asarray(group, dtype=np.uint64)
    r = np.asarray(raw_id, dtype=np.uint64)
    h = (g * np.uint64(0xD1B54A32D192ED03) + r) & np.uint64(0xFFFFFFFFFFFFFFFF)
    h ^= h >> np.uint64(33)
    h = (h * _MUL) & np.uint64(0xFFFFFFFFFFFFFFFF)
    h ^= h >> np.uint64(29)
    h = (h ^ _XOR) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return h


def hash_bucket_np(group, raw_id, vocab: int) -> np.ndarray:
    """Row index into a hashed embedding table (host side)."""
    return (signature_np(group, raw_id) % np.uint64(vocab)).astype(np.int64)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 tensors holding uint32 values. The
    product is split at 16 bits of ``b`` so no intermediate leaves int64
    (a full 32x32-bit product would)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_bucket(group: int, raw_ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """Row index into a hashed embedding table (device side, uint32 math).

    The reference's 2x32-bit mix, carried out in int64 with every multiply
    and shift reduced mod 2**32 (torch's uint32 arithmetic is incomplete),
    so the result equals the uint32 computation bit for bit. Returns int32.
    """
    x = raw_ids.to(torch.int64) & _M32
    g = (group * 0x9E3779B9 + 0x85EBCA6B) & _M32
    h = _mul32(x ^ g, 0xCC9E2D51)
    h = ((h << 13) & _M32) | (h >> 19)
    h = (_mul32(h, 0x1B873593) + 0xE6546B64) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    return (h % vocab).to(torch.int32)
