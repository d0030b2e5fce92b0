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
    return torch.tensor(np.asarray(tree), device=dev)
