"""Carry parameters across from the reference package.

The reference draws its weights from ``jax.random``, whose stream torch
cannot reproduce, so parity runs build parameters with the reference's
``init``, turn them into numpy (``jax.tree.map(np.asarray, params)``) and
hand the same values to the port through :func:`params_from_numpy`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.models.transformer import KVCache


def params_from_numpy(tree, device=None):
    """Nested dicts / lists / tuples of numpy arrays → the same structure
    of tensors on ``device`` (copies; dtypes kept). Covers a model's
    params (``mlp_tower_init`` lists of {"w","b"}, the dict of tables) and
    the pruning DNN's params, ``x_mean`` and ``x_std``."""
    dev = default_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev) for v in tree)
    return tensor_from_numpy(tree, dev)


def tensor_from_numpy(x, device=None) -> torch.Tensor:
    """One array → a tensor on ``device`` (a copy, dtype kept). numpy has
    no bfloat16 of its own: an ``ml_dtypes`` bfloat16 array (what
    ``np.asarray`` makes of a JAX bfloat16 array) is carried bit for bit
    through a uint16 view."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.uint16).copy())
        return bits.view(torch.bfloat16).to(default_device(device))
    return torch.tensor(arr, device=default_device(device))


def kv_cache_from_numpy(cache, device=None):
    """A reference ``KVCache`` (its arrays turned into numpy, or left as
    arrays numpy can read) → the port's ``KVCache`` on ``device``."""
    dev = default_device(device)
    return KVCache(a=tensor_from_numpy(cache.a, dev),
                   b=tensor_from_numpy(cache.b, dev),
                   length=tensor_from_numpy(cache.length, dev).to(torch.int32))
