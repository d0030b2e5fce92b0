"""Carry parameters across from the reference package.

The reference draws its weights from ``jax.random``, whose stream torch
cannot reproduce, so parity runs build parameters with the reference's
``init``, turn them into numpy (``jax.tree.map(np.asarray, params)``) and
hand the same values to the port through :func:`params_from_numpy`;
:func:`params_to_numpy` carries the port's trees back, so gradients and
updated parameters compare leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.models.transformer import KVCache
from repro_torch.tree import tree_map


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


def params_to_numpy(tree):
    """The port's tree of tensors (dicts, lists, tuples, an optimizer's
    ``OptState``) → the same structure of numpy arrays on the host, for
    comparing leaf by leaf with the reference's. numpy has no bfloat16 of
    its own: a bfloat16 tensor comes back as its uint16 bits."""
    return tree_map(tensor_to_numpy, tree)


def tensor_to_numpy(t) -> np.ndarray:
    """One tensor → a numpy copy on the host (bfloat16 as uint16 bits)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def kv_cache_from_numpy(cache, device=None):
    """A reference ``KVCache`` (its arrays turned into numpy, or left as
    arrays numpy can read) → the port's ``KVCache`` on ``device``."""
    dev = default_device(device)
    return KVCache(a=tensor_from_numpy(cache.a, dev),
                   b=tensor_from_numpy(cache.b, dev),
                   length=tensor_from_numpy(cache.length, dev).to(torch.int32))
