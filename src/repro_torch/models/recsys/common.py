"""Shared recsys substrate: hashed feature fields → embedding tables, and
the losses.

On a mesh a loss is the global batch's mean on every rank: each rank's
batch is its block over the data axes (``runtime.batch_axes()``), and
:func:`batch_mean` / :func:`batch_sum` sum over them (``runtime``'s rule
for gradients); the in-batch softmax scores each rank's users against
every rank's items.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import default_device, runtime
from repro_torch.runtime import RowShard
from repro_torch.configs.base import FeatureField, RecsysConfig
from repro_torch.sparse.sharded import sharded_embedding_bag_group


#: rows drawn from one seed by :func:`tables_init` (a rank's part of a
#: table is drawn chunk by chunk, so it equals the whole table's rows)
TABLE_CHUNK_ROWS = 1 << 16


def _table_rows(seed: int, vocab: int, dim: int, start: int, stop: int,
                dev) -> torch.Tensor:
    """Rows [start, stop) of a (vocab, dim) table ~ N(0, 0.01²) whose
    chunk c (rows [c * TABLE_CHUNK_ROWS, ...)) is drawn from seed + c."""
    out = torch.empty((stop - start, dim), dtype=torch.float32, device=dev)
    if dev.type == "meta":                  # shapes only (launch/specs.py)
        return out
    for c in range(start // TABLE_CHUNK_ROWS,
                   -(-stop // TABLE_CHUNK_ROWS)):
        lo = c * TABLE_CHUNK_ROWS
        hi = min(lo + TABLE_CHUNK_ROWS, vocab)
        gen = torch.Generator(device=dev).manual_seed(seed + c)
        chunk = torch.randn((hi - lo, dim), generator=gen, device=dev,
                            dtype=torch.float32).mul_(0.01)
        a, b = max(lo, start), min(hi, stop)
        out[a - start:b - start] = chunk[a - lo:b - lo]
    return out


def tables_init(generator: torch.Generator, cfg: RecsysConfig,
                device=None, mesh=None) -> dict:
    """One (vocab, embed_dim) table per feature field, ~ N(0, 0.01²), keyed
    by field name. Each table takes one seed from ``generator`` and draws
    its rows chunk by chunk from it, never existing twice. On a live
    ``mesh`` a table whose rows split over ("data", "model")
    (``sharding.recsys_param_specs``) is drawn as this rank's
    ``RowShard`` only: the same rows as the whole table's."""
    from repro_torch.launch import sharding
    dev = default_device(device)
    out = {}
    for f in cfg.user_fields + cfg.item_fields:
        seed = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                                 device=generator.device))
        axes = None if mesh is None else sharding.table_axes(f.vocab, mesh)
        idx, n = (0, 1) if axes is None else sharding.flat_index(mesh, axes)
        rows = f.vocab // n
        part = _table_rows(seed, f.vocab, cfg.embed_dim, idx * rows,
                           (idx + 1) * rows, dev)
        out[f.name] = part if n == 1 else RowShard(part, f.vocab, axes)
    return out


def field_lookups(tables: dict, fields: tuple[FeatureField, ...],
                  ids: dict) -> list:
    """The embedding-bag groups of ``fields``: (table, ids, None,
    combiner) each, for ``sharded_embedding_bag_group``."""
    return [(tables[f.name], ids[f.name], None, f.combiner) for f in fields]


def hist_lookup(tables: dict, hist_ids: torch.Tensor):
    """The history's embedding-bag group: one item_id a bag, (B*T, 1), with
    the padding (-1) read as row 0; :func:`masked_hist` masks it after."""
    return (tables["item_id"], hist_ids.clamp_min(0).reshape(-1, 1), None,
            "sum")


def masked_hist(emb: torch.Tensor, hist_ids: torch.Tensor, dim: int):
    """The history lookup's (B*T, D) rows as (B, T, D), zero where
    ``hist_ids`` is padding (-1), and the (B, T) float32 mask."""
    mask = (hist_ids >= 0).to(torch.float32)
    return emb.reshape(*hist_ids.shape, dim) * mask[..., None], mask


def embed_fields(tables: dict, fields: tuple[FeatureField, ...],
                 ids: dict) -> torch.Tensor:
    """ids[name]: (B,) or (B, bag) int → concat (B, n_fields * D), from one
    grouped lookup that writes the concatenation in place (on a mesh, ids
    in the batch layout of ``sharded_embedding_bag_group``)."""
    return sharded_embedding_bag_group(field_lookups(tables, fields, ids),
                                       blocks=(len(fields),))[0]


def _split() -> bool:
    """True on a mesh whose batch is split (its data axes > 1 rank)."""
    return (runtime.current_mesh() is not None
            and runtime.axes_size(runtime.batch_axes()) > 1)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the global batch (on a mesh, over the data
    axes' blocks too)."""
    s = x.sum()
    return runtime.all_reduce(s, runtime.batch_axes()) if _split() else s


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch (equal blocks a rank)."""
    if not _split():
        return torch.mean(x)
    return batch_sum(x) / (x.numel() * runtime.axes_size(runtime.batch_axes()))


def batch_roll(x: torch.Tensor) -> torch.Tensor:
    """``torch.roll(x, 1, dims=0)`` over the global batch: on a mesh the
    first row comes from the previous block's last row (one all_gather
    of a row; its gradient reaches that block's rank)."""
    if not _split():
        return torch.roll(x, 1, dims=0)
    axes = runtime.batch_axes()
    last = runtime.all_gather(x[-1:], axes, partial=True)
    prev = (runtime.shard_index(axes) - 1) % runtime.axes_size(axes)
    return torch.cat([last[prev:prev + 1], x[:-1]])


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``log(sigmoid(x))`` as the reference's ``jax.nn.log_sigmoid``
    computes it, ``-softplus(-x)``. ``F.logsigmoid`` also writes a buffer
    output on the CPU (and on ``meta``) but not on CUDA, so a step's
    counted bytes would depend on the device it is counted on."""
    return -F.softplus(-x)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    ls = log_sigmoid(logits)
    return -batch_mean(labels * ls + (1 - labels) * (ls - logits))


def sampled_softmax_loss(user_vecs: torch.Tensor, item_vecs: torch.Tensor,
                         log_q: torch.Tensor | None = None,
                         temperature: float = 0.05) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction [Yi et al., RecSys'19].
    user/item (B, D) row-aligned positives. On a mesh each rank's users
    meet the whole batch's items (gathered over the data axes; their
    gradients summed back to each item's rank)."""
    offset = 0
    if _split():
        axes = runtime.batch_axes()
        offset = runtime.shard_index(axes) * user_vecs.shape[0]
        item_vecs = runtime.all_gather(item_vecs, axes, partial=True)
        if log_q is not None:
            log_q = runtime.all_gather(log_q, axes)
    logits = (user_vecs @ item_vecs.T) / temperature       # (B, B)
    if log_q is not None:
        logits = logits - log_q[None, :]
    labels = offset + torch.arange(user_vecs.shape[0], device=logits.device)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return batch_mean(lse - gold)


def l2_normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(x * x, -1, keepdim=True) + eps)
