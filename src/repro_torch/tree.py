"""Parameter trees (nested dicts, lists, tuples and NamedTuples of tensors)
walked in JAX's order.

JAX flattens a dict in sorted key order, a list or tuple by index and a
NamedTuple by field, and treats ``None`` as a node without leaves; it
names a leaf by its path, ``"a/b/0/w"`` (a NamedTuple field as
``".name"``). The port's checkpoints pair leaves by position and by these
names with the reference's, so every walk here keeps that order, whatever
order the dicts were built in (``torch.utils._pytree`` keeps insertion
order instead).

A ``runtime.RowShard`` (a rank's rows of a split table) is a node with
one tensor child, its ``local`` rows, and its global row count and axes
as static data: the walks reach the local rows as a leaf, and a map
rebuilds the shard around what it returns there, so gradients,
optimizer states and checkpoints of a split table keep their shape. The
shard adds nothing to a leaf's path (its name is the whole table's).
A ``runtime.DataShard`` (a rank's block of a ZeRO-3 parameter) is a node
of the same kind, with its split dim as static data; a RowShard
may hold one as its rows.
"""
from __future__ import annotations

import dataclasses

from repro_torch.runtime import DataShard, RowShard

#: the key of a shard's one child: it extends no path
_SAME = object()
_SHARDS = (RowShard, DataShard)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(keys, children) of an inner node in JAX's order; None for a leaf."""
    if isinstance(node, _SHARDS):
        return [_SAME], [node.local]
    if isinstance(node, dict):
        keys = sorted(node)
        return keys, [node[k] for k in keys]
    if _is_namedtuple(node):
        return [f".{f}" for f in node._fields], list(node)
    if isinstance(node, (list, tuple)):
        return list(range(len(node))), list(node)
    return None


def _rebuild(node, children):
    """``node``'s kind of container holding ``children`` (in JAX's order);
    a dict keeps ``node``'s own key order."""
    if isinstance(node, _SHARDS):
        return dataclasses.replace(node, local=children[0])
    if isinstance(node, dict):
        by_key = dict(zip(sorted(node), children))
        return {k: by_key[k] for k in node}
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def flatten_with_paths(tree, prefix: tuple = ()) -> list:
    """[(path keys, leaf)] in JAX's order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in zip(*kids):
        out.extend(flatten_with_paths(
            child, prefix if key is _SAME else prefix + (key,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def path_name(path) -> str:
    """A leaf's name as the reference's ``tree_paths`` writes it."""
    return "/".join(str(k) for k in path)


def unflatten(like, new_leaves):
    """``like``'s structure holding ``new_leaves`` (in JAX's order)."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(c) for c in kids[1]])
    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the nodes of ``rest`` at the
    same places (a node of ``rest`` there may be a subtree, as JAX's
    ``flatten_up_to`` hands it), in ``tree``'s structure."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    # a node of ``rest`` at a shard's place that is no shard itself (a
    # spec) goes to the shard's rows whole
    others = [[r] if isinstance(tree, _SHARDS) and not isinstance(
        r, _SHARDS) else _children(r)[1] for r in rest]
    return _rebuild(tree, [tree_map(fn, child, *(o[i] for o in others))
                           for i, child in enumerate(kids[1])])


def strip_shards(tree):
    """``tree`` with every shard replaced by its local rows or block."""
    if isinstance(tree, _SHARDS):
        return strip_shards(tree.local)
    kids = _children(tree) if tree is not None else None
    if kids is None:
        return tree
    return _rebuild(tree, [strip_shards(c) for c in kids[1]])
