"""PartitionSpec rules: params, optimizer state, inputs, KV caches — the
counterpart of ``repro/launch/sharding.py``, rule for rule.

Encodes the distribution design of DESIGN.md §5:
  * LM dense: batch → ("pod","data"); TP on ``model`` for d_ff / attention
    heads (replicated where head counts don't divide 16 — smollm fully,
    qwen3/starcoder2 kv projections); vocab (embed + head) on ``model``.
  * MLA: q_b/k_b/v_b shard the head dim (16 | H for both deepseeks); the
    latent projections (wkv_a, wq_a) replicate (tiny).
  * MoE: experts on ``model``, expert d_ff on ``data`` (2-D expert weights);
    router replicated.
  * RecSys tables: rows on flat ("data","model"); dense parts replicated.
  * KV caches: sequence dim on ``model`` (batch on data axes), or on
    ("data","model") for batch-1 long-context — distributed-softmax decode.

The rules read only ``mesh.shape`` (an abstract mesh will do) and return
the port's own :class:`P`. The reference's ``to_named`` has two
counterparts on a live mesh: :func:`local_part` takes the rank's part of a
whole tensor by its spec, :func:`gather_full` puts the whole back
together; :func:`shard_params` makes the lookup tables' row-split
parameters (:class:`Table` specs) ``runtime.RowShard``s, which carry
their global row count, and ZeRO-3 parameters (:class:`Gathered` specs)
``runtime.DataShard``s, which the model gathers over ``data`` on use.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import runtime
from repro_torch import tree as tree_lib
from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig


class P(tuple):
    """A PartitionSpec: one entry per dim — None (replicated), a mesh axis
    name, or a tuple of names (split over their flat index)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):          # pickled as its entries
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class Table(P):
    """The spec of a lookup table whose rows split (a recsys table, the
    LM's embedding): :func:`shard_params` makes its leaf a
    ``runtime.RowShard``, the form the sparse lookups read."""


class Gathered(P):
    """The spec of a ZeRO-3 parameter (``zero_specs(..., gathered=True)``):
    split over ``data`` on a dim its compute spec leaves whole.
    :func:`shard_params` makes its leaf a ``runtime.DataShard``, which the
    model gathers whole over ``data`` where it uses the leaf."""

    @property
    def data_dim(self) -> int:
        return tuple(self).index("data")


class GatheredTable(Table, Gathered):
    """A ZeRO-3 lookup table: a ``RowShard`` whose rows are a
    ``DataShard``."""


def _names(path) -> list[str]:
    """A leaf's path as the reference's names: dict keys, NamedTuple
    fields (without the port path's leading dot), sequence indices."""
    return [k[1:] if isinstance(k, str) and k.startswith(".") else str(k)
            for k in path]


def _map_with_names(fn, tree):
    """``fn(names, leaf)`` over ``tree``'s leaves, in its structure."""
    paths = iter(path for path, _ in tree_lib.flatten_with_paths(tree))
    return tree_lib.tree_map(lambda leaf: fn(_names(next(paths)), leaf), tree)


def _divides(n: int, mesh, axis: str) -> bool:
    return n % mesh.shape.get(axis, 1) == 0


# ------------------------------------------------------------------ LM

def _lm_leaf_spec(names: list[str], leaf, cfg: LMConfig, mesh) -> P:
    stacked = ("layers" in names or "dense_layers" in names) and "mtp" not in names
    pre = (None,) if stacked else ()
    name = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    nm = mesh.shape.get("model", 1)
    H, Hkv = cfg.n_heads, cfg.n_kv

    def spec(*s):
        return P(*(pre + s))

    if "embed" in names:
        return Table("model", None) if _divides(cfg.vocab, mesh, "model") else P(None, None)
    if "lm_head" in names:
        return P(None, "model") if _divides(cfg.vocab, mesh, "model") else P(None, None)
    if name in ("scale", "bias"):          # norms (incl. q_norm/k_norm/kv_norm)
        return spec(*(None,) * (leaf.ndim - len(pre)))
    if parent == "moe":
        f_ok = _divides(cfg.moe.d_ff_expert, mesh, "data")
        fs = "data" if f_ok else None
        return {"router": spec(None, None),
                "w1": spec("model", None, fs), "w3": spec("model", None, fs),
                "w2": spec("model", fs, None)}[name]
    if parent in ("mlp", "shared"):        # dense FFN / shared experts: TP on f
        d_ff = leaf.shape[-1] if name in ("w1", "w3") else leaf.shape[-2]
        ok = d_ff % nm == 0
        if name in ("w1", "w3"):
            return spec(None, "model") if ok else spec(None, None)
        return spec("model", None) if ok else spec(None, None)
    if parent == "attn" or name in ("wq", "wk", "wv", "wo", "wq_a", "wq_b",
                                    "wkv_a", "wk_b", "wv_b"):
        if cfg.mla:
            hs = "model" if H % nm == 0 else None
            return {"wq": spec(None, hs), "wq_a": spec(None, None),
                    "wq_b": spec(None, hs), "wkv_a": spec(None, None),
                    "wk_b": spec(None, hs), "wv_b": spec(None, hs),
                    "wo": spec(hs, None)}.get(name, spec(*(None,) * (leaf.ndim - len(pre))))
        q_ok = H % nm == 0
        kv_ok = Hkv % nm == 0
        return {"wq": spec(None, "model" if q_ok else None),
                "wk": spec(None, "model" if kv_ok else None),
                "wv": spec(None, "model" if kv_ok else None),
                "wo": spec("model" if q_ok else None, None)}.get(
                    name, spec(*(None,) * (leaf.ndim - len(pre))))
    if name == "proj":                     # mtp projection
        return P(None, None)
    return spec(*(None,) * (leaf.ndim - len(pre)))


def lm_param_specs(params_shape: Any, cfg: LMConfig, mesh):
    return _map_with_names(
        lambda names, leaf: _lm_leaf_spec(names, leaf, cfg, mesh), params_shape)


# ------------------------------------------------------------- recsys/gnn

def table_axes(rows: int, mesh):
    """("data", "model") when a table of ``rows`` rows splits over the
    mesh's flat ("data", "model") shards, else None (replicated)."""
    n_shards = mesh.shape.get("data", 1) * mesh.shape.get("model", 1)
    return ("data", "model") if rows % n_shards == 0 else None


def recsys_param_specs(params_shape: Any, cfg: RecsysConfig, mesh):
    def leaf_spec(names, leaf):
        if "tables" in names and leaf.ndim == 2 and table_axes(leaf.shape[0], mesh):
            return Table(("data", "model"), None)
        return P(*(None,) * leaf.ndim)
    return _map_with_names(leaf_spec, params_shape)


def gnn_param_specs(params_shape: Any, cfg: GNNConfig, mesh):
    return tree_lib.tree_map(lambda leaf: P(*(None,) * leaf.ndim), params_shape)


def param_specs(params_shape, cfg, mesh):
    if isinstance(cfg, LMConfig):
        return lm_param_specs(params_shape, cfg, mesh)
    if isinstance(cfg, RecsysConfig):
        return recsys_param_specs(params_shape, cfg, mesh)
    return gnn_param_specs(params_shape, cfg, mesh)


# ------------------------------------------------------------- ZeRO grads

def zero_specs(params_shape: Any, pspecs: Any, mesh,
               min_size: int = 1 << 20, gathered: bool = False) -> Any:
    """ZeRO-2 sharding for gradient accumulators + optimizer state: add the
    ``data`` axis to the largest unsharded, divisible dim of every big leaf
    whose spec doesn't already use it. A :class:`Table` stays one, as a
    rank's state of a split table is a ``RowShard`` too. ``gathered``:
    the same specs as ZeRO-3 parameter specs (``fsdp_params``; the
    reference's ``pspecs = zspecs``), each leaf that gained ``data``
    marked :class:`Gathered` (:class:`GatheredTable`)."""
    nd = mesh.shape.get("data", 1)
    if nd <= 1:
        return pspecs

    def one(leaf, spec: P) -> P:
        if int(np.prod(leaf.shape)) < min_size:
            return spec
        used = set()
        for s in spec:
            if s is None:
                continue
            for a in (s if isinstance(s, tuple) else (s,)):
                used.add(a)
        if "data" in used:
            return spec
        entries = list(spec) + [None] * (leaf.ndim - len(tuple(spec)))
        cands = [i for i in range(leaf.ndim)
                 if entries[i] is None and leaf.shape[i] % nd == 0]
        if not cands:
            return spec
        dim = max(cands, key=lambda i: leaf.shape[i])
        entries[dim] = "data"
        if gathered:
            return (GatheredTable if isinstance(spec, Table)
                    else Gathered)(*entries)
        return type(spec)(*entries)

    return tree_lib.tree_map(one, params_shape, pspecs)


# -------------------------------------------------------- optimizer state

def opt_state_specs(opt_state_shape: Any, params_shape: Any, pspecs: Any):
    """Infer optimizer-state specs structurally: any state leaf whose shape
    matches a param's shape/prefix inherits the param spec (adamw m/v,
    adafactor vr/vc, rowwise accumulators); scalars replicate."""
    pairs: list = []
    tree_lib.tree_map(lambda leaf, spec: pairs.append((leaf, spec)),
                      params_shape, pspecs)
    by_shape: dict[tuple, P] = {}
    for leaf, spec in pairs:
        by_shape.setdefault(tuple(leaf.shape), spec)
        # factored / rowwise variants
        if leaf.ndim >= 2:
            sp = tuple(spec) + (None,) * (leaf.ndim - len(tuple(spec)))
            by_shape.setdefault(tuple(leaf.shape[:-1]), P(*sp[:-1]))
            by_shape.setdefault(tuple(leaf.shape[:-2] + leaf.shape[-1:]),
                                P(*(sp[:-2] + sp[-1:])))
            by_shape.setdefault(tuple(leaf.shape[:1]), P(sp[0]))

    def leaf_spec(leaf):
        if leaf.ndim == 0:
            return P()
        return by_shape.get(tuple(leaf.shape), P(*(None,) * leaf.ndim))

    return tree_lib.tree_map(leaf_spec, opt_state_shape)


# ----------------------------------------------------------------- inputs

def batch_axes_of(mesh) -> tuple:
    axes = tuple(a for a in ("pod", "data") if mesh.shape.get(a, 1) > 1)
    return axes or ("data",)


def data_size(mesh) -> int:
    return mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)


def batched_spec(mesh, shape: tuple, extra_axes: int | None = None) -> P:
    """Shard dim0 over the data axes when divisible, else replicate."""
    nd = len(shape) if extra_axes is None else extra_axes + 1
    if shape and shape[0] % data_size(mesh) == 0 and shape[0] >= data_size(mesh):
        return P(batch_axes_of(mesh), *(None,) * (nd - 1))
    return P(*(None,) * nd)


def edge_spec(mesh, ndim: int) -> P:
    return P(("data", "model"), *(None,) * (ndim - 1))


def kv_cache_specs(cfg: LMConfig, batch: int, mesh):
    """(a, b, length) specs — sequence-sharded decode caches."""
    if batch % data_size(mesh) == 0 and batch >= data_size(mesh):
        b_ax, s_ax = batch_axes_of(mesh), ("model",)
    else:
        b_ax, s_ax = (), tuple(a for a in ("pod", "data", "model")
                               if mesh.shape.get(a, 1) > 1)
    bspec = b_ax if b_ax else None
    if cfg.mla:
        a = P(None, bspec, s_ax, None)
        b = P(None, bspec, s_ax, None)
    else:
        a = P(None, bspec, s_ax, None, None)
        b = P(None, bspec, s_ax, None, None)
    return a, b, P()


# ------------------------------------------------------- rank-local parts

def entry_axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def flat_index(mesh, axes) -> tuple[int, int]:
    """(index, size) of the rank over ``axes``, row-major in the order
    given (the reference's tiled layout of a spec entry)."""
    idx, size = 0, 1
    for a in axes:
        n = mesh.shape.get(a, 1)
        idx, size = idx * n + mesh.coords.get(a, 0), size * n
    return idx, size


def local_part(tensor: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The rank's part of a whole ``tensor`` by ``spec``: along each split
    dim its equal block (the dim must divide, as a NamedSharding
    requires). A view where it can be one."""
    for dim, entry in enumerate(spec):
        idx, size = flat_index(mesh, entry_axes(entry))
        if size == 1:
            continue
        n = tensor.shape[dim]
        if n % size:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"split over {size} ranks ({spec})")
        tensor = tensor.narrow(dim, idx * (n // size), n // size)
    return tensor


def gather_full(tensor, spec: P, mesh) -> torch.Tensor:
    """The whole tensor from each rank's ``local_part`` (a shard's local
    rows or block too): an all_gather along every split dim."""
    tensor = tree_lib.strip_shards(tensor)
    with runtime.use_mesh(mesh):
        for dim, entry in enumerate(spec):
            axes = entry_axes(entry)
            if flat_index(mesh, axes)[1] == 1:
                continue
            moved = tensor.movedim(dim, 0)
            tensor = runtime.all_gather(moved, axes).movedim(0, dim)
    return tensor.contiguous()


def held(part: torch.Tensor, spec: P, mesh, shape: tuple):
    """What a rank holds of a leaf of ``shape`` whose :func:`local_part`
    is ``part``: a :class:`Gathered` leaf's part as a
    ``runtime.DataShard`` (its block over ``data``), a :class:`Table`
    whose rows split over more than one rank as a ``runtime.RowShard``
    (its local rows, the global row count, the axes) around that; else
    ``part``."""
    if isinstance(spec, Gathered) and flat_index(mesh, ("data",))[1] > 1:
        part = runtime.DataShard(part, spec.data_dim)
    if isinstance(spec, Table):
        axes = entry_axes(spec[0])
        if flat_index(mesh, axes)[1] > 1:
            return runtime.RowShard(part, shape[0], axes)
    return part


def shard_params(params, pspecs, mesh):
    """The rank's parameters: each leaf's :func:`local_part`, held as
    :func:`held` says."""
    if params is None:
        return None

    def one(leaf, spec):
        if not isinstance(spec, P):
            return leaf
        return held(local_part(leaf, spec, mesh), spec, mesh, leaf.shape)
    return tree_lib.tree_map(one, params, pspecs)


def local_tree(tree, specs, mesh):
    """:func:`local_part` of every tensor leaf of ``tree`` whose spec (at
    the same place of ``specs``) is a :class:`P`; None specs leave a
    subtree whole."""
    if specs is None:
        return tree
    return tree_lib.tree_map(
        lambda leaf, spec: local_part(leaf, spec, mesh)
        if isinstance(spec, P) and isinstance(leaf, torch.Tensor) else leaf,
        tree, specs)


def gather_tree(tree, specs, mesh):
    """:func:`gather_full` of every leaf of ``tree`` by ``specs`` (a
    ``RowShard``'s rows gathered into the whole table)."""
    tree = tree_lib.strip_shards(tree)
    return tree_lib.tree_map(
        lambda leaf, spec: gather_full(leaf, spec, mesh)
        if isinstance(spec, P) else leaf, tree, specs)
