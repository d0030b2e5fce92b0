"""Roofline report on one H100: reads the cell runs' records
(``launch/dryrun.py``) → per-(arch × shape) three-term analysis (compute /
memory / collective seconds on the card), the dominant term, the share of
the card's floor that the measured step reaches, and a markdown table.

  compute_s    = counted FLOPs / the peak of the cell's dtype
  memory_s     = counted bytes / HBM
  collective_s = 0 (one device; ROADMAP A8)

The counted terms come from ``launch/op_analysis.py`` (one step, every
dispatched op plus the hand-written kernels' costs). Two fractions:

  roofline_frac  = max(MODEL_FLOPS / peak, MODEL_BYTES / HBM) over the
                   MEASURED step time: how close the step came to the
                   card's floor for the model's own work
  modelled_frac  = the same floor over max(compute_s, memory_s,
                   collective_s): the reference's modelled ratio

  PYTHONPATH=src python -m repro_torch.launch.roofline [--dir artifacts/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import registry

#: NVIDIA H100 SXM5 data sheet (dense, without sparsity, at the full 700 W
#: power limit): HBM3 bandwidth, float32 outside the tensor cores (TF32
#: stays off in the port), bf16 on the tensor cores, device memory
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
HBM_BYTES = 80e9

MESH = "1xH100"

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


def analyze_row(rec: dict) -> dict:
    ops = rec.get("ops", {})
    meta = rec.get("meta", {})
    peak = peak_flops(meta.get("param_dtype", "float32"))
    f = ops.get("flops_per_device", 0.0)
    b = ops.get("bytes_per_device", 0.0)
    # one device: no collective traffic to time (ROADMAP A8)
    terms = {"compute": f / peak, "memory": b / HBM_BYTES_PER_S,
             "collective": 0.0}
    dominant = max(terms, key=terms.get) if f or b else "n/a"
    model_flops = meta.get("model_flops", 0.0)
    model_bytes = meta.get("model_bytes_per_device", 0.0)
    floor_s = max(model_flops / peak, model_bytes / HBM_BYTES_PER_S)
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
        "flops_ratio": model_flops / f if f else 0.0,
        "step_s": step_s, "floor_s": floor_s,
        "roofline_frac": floor_s / step_s if step_s else None,
        "modelled_frac": floor_s / modelled_s if modelled_s else 0.0,
        "idle_share": rec.get("profile", {}).get("idle_share"),
        "peak_gib": mem.get("max_allocated_bytes", 0) / 2**30,
        "estimate_gib": mem.get("estimate_bytes", 0) / 2**30,
        "hint": HINTS.get((dominant, family), ""),
    }


def _num(x, fmt=".3g"):
    return "—" if x is None else format(x, fmt)


def markdown_table(rows: list[dict]) -> str:
    out = ["| arch | shape | ok | step ms | compute s | memory s | coll s | "
           "dominant | MODEL/counted flops | roofline frac (measured) | "
           "modelled frac | idle share | peak GiB (estimate GiB) | "
           "what moves it |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        step_ms = None if r["step_s"] is None else r["step_s"] * 1e3
        ok = ("yes" if r["ok"] else
              "no: does not fit" if r["fits_h100"] is False else "no")
        out.append(
            f"| {r['arch']} | {r['shape']} | {ok} | "
            f"{_num(step_ms)} | {r['compute_s']:.3g} | {r['memory_s']:.3g} | "
            f"{r['collective_s']:.3g} | {r['dominant']} | "
            f"{r['flops_ratio']:.2f} | {_num(r['roofline_frac'], '.4f')} | "
            f"{r['modelled_frac']:.3f} | {_num(r['idle_share'], '.3f')} | "
            f"{r['peak_gib']:.2f} ({r['estimate_gib']:.1f}) | {r['hint']} |")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--json-out", default="artifacts/roofline_h100.json")
    args = ap.parse_args()
    rows = [analyze_row(r) for r in load(args.dir)]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump(rows, f, indent=1)
    print(markdown_table(rows))
    measured = sorted((r for r in rows if r["roofline_frac"] is not None),
                      key=lambda r: r["roofline_frac"])[:5]
    print("\nworst roofline fractions (measured):",
          [(r["arch"], r["shape"], round(r["roofline_frac"], 4))
           for r in measured])


if __name__ == "__main__":
    main()
