"""Roofline report on the H100: reads the cell records
(``launch/dryrun.py``) → per-(arch × shape) three-term analysis (compute /
memory / collective seconds on the card), the dominant term, the share of
the card's floor that the measured step reaches, and a markdown table.

  compute_s    = counted FLOPs / the peak of the cell's dtype
  memory_s     = counted bytes / HBM
  collective_s = 0 for a run on one card; for a production record
                 (``--mesh 16x16`` or ``2x16x16``: the dry run's
                 ``*@meta.json``) each group's ring-model traffic over the
                 link it crosses: NVLink where the group's ranks lie in
                 one node of NODE_GPUS consecutive ranks, InfiniBand where
                 it spans nodes, summed over the groups

The counted terms come from ``launch/op_analysis.py`` (one step, every
dispatched op plus the hand-written kernels' costs). Two fractions:

  roofline_frac  = max(MODEL_FLOPS / n_devices / peak, MODEL_BYTES / HBM)
                   over the MEASURED step time: how close the step came
                   to the card's floor for the model's own work
  modelled_frac  = the same floor over max(compute_s, memory_s,
                   collective_s): the reference's modelled ratio

A production record has no measured step: its rows give the dominant
term and ``modelled_frac`` only, labelled modelled (counted on the meta
device, not timed).

  PYTHONPATH=src python -m repro_torch.launch.roofline [--dir artifacts/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.roofline --mesh 16x16
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os

from repro_torch.configs import registry

#: NVIDIA H100 SXM5 data sheet (dense, without sparsity, at the full 700 W
#: power limit): HBM3 bandwidth, float32 outside the tensor cores (TF32
#: stays off in the port), bf16 on the tensor cores, device memory
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
HBM_BYTES = 80e9
#: links between the cards of a production mesh: NVLink 4 within a node
#: of 8 H100 SXM5 (900 GB/s a GPU, the H100 SXM5 data sheet) and one
#: 400 Gb/s NDR InfiniBand port a GPU between nodes (50 GB/s; the
#: ConnectX-7 a GPU of NVIDIA's DGX H100 data sheet)
NVLINK_BYTES_PER_S = 900e9
IB_BYTES_PER_S = 50e9
NODE_GPUS = 8

MESH = "1xH100"
#: the production meshes' records (``launch/dryrun.py::dry_run_cell``)
PRODUCTION = {"16x16": "16x16@meta", "2x16x16": "2x16x16@meta"}

HINTS = {
    ("compute", "lm"): "fp32 SIMT GEMMs: bf16 weights on the tensor cores "
                       "(989 vs 67 TFLOP/s), or TF32 where the tolerance "
                       "allows",
    ("memory", "lm"): "elementwise passes over score blocks / the KV "
                      "cache: fuse them into the attention kernel (B6 "
                      "reads the cache once), bf16 K/V",
    ("compute", "recsys"): "batch the MLP into fewer larger GEMMs; bf16 "
                           "tensor cores",
    ("memory", "recsys"): "one grouped embedding_bag a call (B3) and the "
                          "fused attention unit (B2); a scatter-add table "
                          "gradient, not a dense one",
    ("compute", "gnn"): "the RBF filter MLP per edge (E × n_rbf × h): bf16 "
                        "tensor cores, or the filter shared per distance",
    ("memory", "gnn"): "fuse gather × filter × scatter per edge block in "
                       "one kernel; the (E, n_rbf) RBF never in HBM",
    ("collective", "lm"): "a model axis of 16 spans two nodes: TP within "
                          "one node's NVLink (8), the rest over data",
    ("collective", "recsys"): "the table exchange crosses InfiniBand: "
                              "dedup ids before the gather, bf16 rows",
    ("collective", "gnn"): "the node sums cross InfiniBand every "
                           "interaction: partition edges by destination",
}


def peak_flops(param_dtype: str) -> float:
    """The card's peak for a cell's dtype."""
    return BF16_FLOPS_PER_S if param_dtype == "bfloat16" else FP32_FLOPS_PER_S


def bound_s(flops, nbytes, flops_per_s=FP32_FLOPS_PER_S) -> tuple:
    """(seconds, what bounds it): the least time for ``flops`` at
    ``flops_per_s`` and ``nbytes`` at the HBM rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def load(dirpath: str, mesh: str = MESH) -> list[dict]:
    rows = []
    for fn in sorted(glob.glob(os.path.join(dirpath, f"*__{mesh}.json"))):
        with open(fn) as f:
            rows.append(json.load(f))
    return rows


def crosses_nodes(dims, axis_names, axes) -> bool:
    """True where a group over mesh ``axes`` spans more than one node of
    NODE_GPUS consecutive ranks (rank = the row-major flat index over
    the mesh's dims): rank 0's group, which every group repeats."""
    strides = [math.prod(dims[i + 1:]) for i in range(len(dims))]
    members = [0]
    for name, n, stride in zip(axis_names, dims, strides):
        if name in axes:
            members = [m + k * stride for m in members for k in range(n)]
    return len({m // NODE_GPUS for m in members}) > 1


def collective_s(rec: dict) -> float:
    """A production record's collective seconds: each group's traffic
    over NVLink or, where the group spans nodes, InfiniBand."""
    dims = [int(d) for d in rec["mesh"].split("x")]
    total = 0.0
    for row in rec.get("ops", {}).get("collectives_by_group", []):
        rate = (IB_BYTES_PER_S if crosses_nodes(dims, rec["axes"], row["axes"])
                else NVLINK_BYTES_PER_S)
        total += row["traffic_bytes"] / rate
    return total


def analyze_row(rec: dict) -> dict:
    ops = rec.get("ops", {})
    meta = rec.get("meta", {})
    peak = peak_flops(meta.get("param_dtype", "float32"))
    f = ops.get("flops_per_device", 0.0)
    b = ops.get("bytes_per_device", 0.0)
    dry = rec.get("device") == "meta"
    # one device: no collective traffic to time (ROADMAP A8)
    terms = {"compute": f / peak, "memory": b / HBM_BYTES_PER_S,
             "collective": collective_s(rec) if dry else 0.0}
    dominant = max(terms, key=terms.get) if f or b else "n/a"
    model_flops = meta.get("model_flops", 0.0)
    model_bytes = meta.get("model_bytes_per_device", 0.0)
    # MODEL_FLOPS is the whole step's; the counts and MODEL_BYTES are a
    # device's (the reference's ``model_flops / n_dev``)
    n_dev = rec.get("n_devices", 1)
    floor_s = max(model_flops / n_dev / peak, model_bytes / HBM_BYTES_PER_S)
    modelled_s = max(terms.values())
    step_s = rec.get("step_ms", 0.0) / 1e3 if rec.get("step_ms") else None
    family = registry.get(rec["arch"]).family
    mem = rec.get("memory", {})
    return {
        "arch": rec["arch"], "shape": rec["shape"], "ok": rec.get("ok"),
        "device": rec.get("device"), "fits_h100": mem.get("fits_h100"),
        "compute_s": terms["compute"], "memory_s": terms["memory"],
        "collective_s": terms["collective"], "dominant": dominant,
        "model_flops": model_flops,
        "flops_ratio": model_flops / (f * n_dev) if f else 0.0,
        "step_s": step_s, "floor_s": floor_s,
        "roofline_frac": floor_s / step_s if step_s else None,
        "modelled_frac": floor_s / modelled_s if modelled_s else 0.0,
        "peak_gib": mem.get("peak_bytes_per_device" if dry else
                            "max_allocated_bytes", 0) / 2**30,
        "estimate_gib": mem.get("estimate_bytes", 0) / 2**30,
        "hint": HINTS.get((dominant, family), ""),
        "mesh": rec.get("mesh"), "modelled": dry,
        "peak_gb": mem.get("peak_bytes_per_device", 0) / 1e9,
        "flops": f, "collectives_by_kind": ops.get("collectives_by_kind", {}),
        "error": rec.get("error"),
    }


def _num(x, fmt=".3g"):
    return "—" if x is None else format(x, fmt)


def markdown_table(rows: list[dict]) -> str:
    out = ["| arch | shape | ok | step ms | compute s | memory s | coll s | "
           "dominant | MODEL/counted flops | roofline frac (measured) | "
           "modelled frac | peak GiB (estimate GiB) | what moves it |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        step_ms = None if r["step_s"] is None else r["step_s"] * 1e3
        ok = ("yes" if r["ok"] else
              "no: does not fit" if r["fits_h100"] is False else "no")
        out.append(
            f"| {r['arch']} | {r['shape']} | {ok} | "
            f"{_num(step_ms)} | {r['compute_s']:.3g} | {r['memory_s']:.3g} | "
            f"{r['collective_s']:.3g} | {r['dominant']} | "
            f"{r['flops_ratio']:.2f} | {_num(r['roofline_frac'], '.4f')} | "
            f"{r['modelled_frac']:.3f} | "
            f"{r['peak_gib']:.2f} ({r['estimate_gib']:.1f}) | {r['hint']} |")
    return "\n".join(out)


#: the collectives' short names in the production table
_SHORT = {"all_gather": "ag", "reduce_scatter": "rs", "all_reduce": "ar",
          "all_to_all": "a2a"}


def _coll(by_kind: dict) -> str:
    """Collective traffic a device in GB by kind (``/bwd`` as ``'``)."""
    parts = []
    for kind, v in sorted(by_kind.items()):
        base, _, phase = kind.partition("/")
        name = _SHORT.get(base, base) + ("'" if phase == "bwd" else
                                         "r" if phase else "")
        parts.append(f"{name} {v['traffic_bytes'] / 1e9:.3g}")
    return " ".join(parts) or "none"


def _cell(r: dict) -> str:
    if not r["ok"]:
        return f"no: {(r['error'] or '')[:80]}"
    return (f"{r['peak_gb']:.3g}{'' if r['fits_h100'] else ' NO'} | "
            f"{r['flops']:.3g} | {_coll(r['collectives_by_kind'])} | "
            f"{r['dominant']} {r['modelled_frac']:.2g}")


def production_table(*meshes: list[dict]) -> str:
    """The production records of one mesh or of several side by side
    (rows paired by arch and shape): per device the peak GB ("NO" where
    it does not fit 80 GB), flops, the collective traffic in GB by kind
    (ag all_gather, rs reduce_scatter, ar all_reduce, a2a all_to_all;
    ' a backward's, r a recompute's) and the modelled dominant term with
    ``modelled_frac``. Counted on the meta device, not timed."""
    names = [rows[0]["mesh"] if rows else "?" for rows in meshes]
    head = " | ".join(f"{n} GB | flops | collective GB | dominant"
                      for n in names)
    out = [f"| arch | shape | {head} |",
           "|---|---|" + "---|---|---|---|" * len(meshes)]
    keyed = [{(r["arch"], r["shape"]): r for r in rows} for rows in meshes]
    for key in sorted(set().union(*keyed)):
        cells = " | ".join(_cell(k[key]) if key in k else "— | — | — | —"
                           for k in keyed)
        out.append(f"| {key[0]} | {key[1]} | {cells} |")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--mesh", choices=sorted(PRODUCTION) + ["all"],
                    help="the production meshes' dry-run records (counted "
                    "on the meta device, not timed); all: both side by "
                    "side")
    args = ap.parse_args()
    if args.mesh:
        meshes = sorted(PRODUCTION, key=len) if args.mesh == "all" \
            else [args.mesh]
        tables = [sorted((analyze_row(r) for r in load(args.dir,
                                                      PRODUCTION[m])),
                         key=lambda r: (r["arch"], r["shape"]))
                  for m in meshes]
        json_out = args.json_out or f"artifacts/roofline_{args.mesh}.json"
        os.makedirs(os.path.dirname(json_out) or ".", exist_ok=True)
        with open(json_out, "w") as f:
            json.dump(dict(zip(meshes, tables)), f, indent=1)
        print(f"{', '.join(meshes)} (modelled: counted on the meta device, "
              f"not timed)")
        print(production_table(*tables))
        return
    rows = [analyze_row(r) for r in load(args.dir)]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    json_out = args.json_out or "artifacts/roofline_h100.json"
    os.makedirs(os.path.dirname(json_out) or ".", exist_ok=True)
    with open(json_out, "w") as f:
        json.dump(rows, f, indent=1)
    print(markdown_table(rows))
    measured = sorted((r for r in rows if r["roofline_frac"] is not None),
                      key=lambda r: r["roofline_frac"])[:5]
    print("\nworst roofline fractions (measured):",
          [(r["arch"], r["shape"], round(r["roofline_frac"], 4))
           for r in measured])


if __name__ == "__main__":
    main()
