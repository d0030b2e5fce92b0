"""B3, the grouped embedding bag: one launch for every lookup of a model
call. flops: a multiply-add per looked-up element; bytes: each distinct
row of each table once, the ids (int64, as handed) of the valid lookups,
and the pooled rows written once."""
from __future__ import annotations

from portbench.costs.common import F32, distinct, valid

ID = 8


def _fields(cfg: dict, ids: dict, names) -> tuple[int, int, int]:
    """(distinct rows, ids, bags) of each named field's lookup."""
    rows = n_ids = bags = 0
    for f in cfg["user_fields"] + cfg["item_fields"]:
        if f["name"] in names and f["name"] in ids:
            x = ids[f["name"]]
            rows += distinct(x)
            n_ids += x.numel()
            bags += x.shape[0]
    return rows, n_ids, bags


def _count(cfg, rows, n_ids, bags):
    D = cfg["embed_dim"]
    return 2 * n_ids * D, rows * D * F32 + n_ids * ID + bags * D * F32


def pairs(cfg: dict, batch: dict, weights: dict) -> tuple[int, int]:
    """The history, the target and every side field of B pairs."""
    hist = batch["user"]["hist"]
    n_hist = valid(hist)
    item_rows = distinct(hist, batch["item"]["item_id"])
    user = {f["name"] for f in cfg["user_fields"]}
    side = {f["name"] for f in cfg["item_fields"]} - {"item_id"}
    r_u, i_u, b_u = _fields(cfg, batch["user"]["fields"], user)
    r_i, i_i, b_i = _fields(cfg, batch["item"], side)
    B = batch["item"]["item_id"].shape[0]
    return _count(cfg, item_rows + r_u + r_i, n_hist + B + i_u + i_i,
                  n_hist + B + b_u + b_i)

