"""Cell run on one H100: build every (arch × shape) cell on the card, run
it, and record its time, memory and counted work.

The counterpart of the reference's dry-run, which lowers and compiles each
cell for a TPU mesh without running it. Eager PyTorch has no compile step
to stop at, so a cell that fits the card is run:

  * before anything is allocated, the cell's argument bytes plus its
    ``meta["model_bytes_per_device"]`` are set against the card's memory
    (``fits_h100``); a cell that cannot fit is recorded ``ok: false`` with
    its estimate and not launched (a mesh of more cards is its place);
  * otherwise its arguments are drawn on the card (``Cell.materialize``),
    then come warm-up steps, N steps timed with CUDA events, one step
    counted by ``launch/op_analysis.py`` (flops, bytes, the kernels'
    launches); ``max_memory_allocated`` is recorded.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch schnet --shape molecule
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all      # subprocesses
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch din --shape serve_p99 --mesh 2x2

With ``mesh`` (any cell: the serving cells, the training cells with
``carry=2``, each call the next ZeRO-2 step, and the GNN cells, the
graph whole on every rank and its edges split) the cell runs as one rank
per mesh device (``launch/mesh.py::run_jobs``): the fit check is per
rank (its part of the arguments against its share of the card), each
rank draws its part of the arguments and records its ms per step (CUDA
events), its ``max_memory_allocated``, its kernels' launches and its
collectives by kind with their bytes (a training step's backward
collectives as ``kind/bwd``, a checkpointed block's recomputed ones as
``kind/recompute``); the record keeps every rank's and the slowest
rank's step. The roofline stays a one-device reading. Ranks that share one card (NCCL refuses two ranks on one
device) run over gloo: their times are several processes on one card,
not a multi-card figure, and the record's name says so.

Records: ``<out>/<arch>__<shape>__1xH100.json`` (``1xcpu`` for a CPU run,
whose times are the host's and are not written as the card's); on a mesh
``<arch>__<shape>__2x2@1xH100.json`` (ranks on one card) or
``...__2x2@cpu.json``. The CLI runs on ``cuda`` only; :func:`run_cell`
also takes ``device="cpu"``.

The production-mesh dry run (:func:`dry_run_cell`), the counterpart of
the reference's compile of every cell on (16, 16) and (2, 16, 16):
one rank's step runs on torch's ``meta`` device, through the code a live
rank runs, on that rank's dry mesh (``launch/mesh.py::dry_mesh``: its
coordinates, no process group). Its arguments are the rank's parts by
the cell's specs (``Cell.local_args``), nothing is allocated or drawn,
every collective returns the output a live group would give and is
counted as one, and every kernel wrapper runs its checks and hands its
cost to the op counter without a launch. Rank 0 and the last rank (the
one holding the padded blocks) are counted; the record keeps both and
heads with the larger (by peak bytes, then flops):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch din --shape serve_p99 --production
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --production [--multi-pod]

Records ``<arch>__<shape>__16x16@meta.json`` (``2x16x16@meta``): per
device the argument bytes, the peak of the step's own storages plus the
arguments and ``fits_h100`` against ``roofline.HBM_BYTES``, the counted
flops, bytes and collective traffic by kind, the kernels by launches and
cost, and which kernel costs are bounds (``bounded_kernel_counts``).
Counted, not timed: no device runs, so the dry run goes on any host; the
paths that run on a device keep ``default_device()``'s guard.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch import default_device, runtime
from repro_torch import kernels as K
from repro_torch.configs import registry
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_analysis, roofline
from repro_torch.launch.specs import build_cell, tree_bytes

DEFAULT_OUT = "artifacts/dryrun"
CELL_TIMEOUT_S = 1800
#: a production cell's dry count: deepseek-v3-671b × train_4k dispatches
#: the most ops (16 micro-batches of 61 layers: ~2,000 s on one Xeon core)
DRY_CELL_TIMEOUT_S = 3600
DRY = "meta"


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_ms(run, dev, n: int) -> float:
    """Mean ms per step of ``run()`` called n times: CUDA events on the
    card, the host clock elsewhere."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        return (time.perf_counter() - t0) * 1e3 / n
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(n):
        run()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / n


def run_cell(arch_id: str, shape_name: str, out_dir: str = DEFAULT_OUT,
             device=None, steps: int = 5, warmup: int = 2,
             reduced: bool = False, mesh=None,
             check_kernels: bool = False) -> dict:
    """Build, fit-check, run, time and count one cell on ``device``
    (``cuda`` if None), on one device or, given ``mesh`` ("2x2" or a
    shape tuple; axes as the reference's ``--mesh`` names them), one rank
    per mesh device; write and return its record. On a mesh,
    ``check_kernels`` also replays every kernel call of each rank's
    counted step through the wrapper and its plain version (the record's
    ``kernel_checks``, per rank, not written). An exception inside the
    cell is recorded (``ok: false``, ``error``) and not raised, so a sweep
    goes on; a cell that does not run on a mesh yet raises
    ``NotImplementedError``."""
    dev = default_device(device)
    if mesh is not None:
        return _run_mesh_cell(arch_id, shape_name, out_dir, dev, steps,
                              warmup, reduced, mesh, check_kernels)
    mesh = "1xH100" if dev.type == "cuda" else f"1x{dev.type}"
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh,
           "n_devices": 1, "reduced": reduced, "ok": False,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else dev.type)}
    t0 = time.monotonic()
    try:
        cell = build_cell(arch_id, shape_name, device=dev, reduced=reduced)
        rec["meta"] = {k: (float(v) if isinstance(v, (int, float)) else v)
                       for k, v in cell.meta.items()}
        capacity = (torch.cuda.get_device_properties(dev).total_memory
                    if dev.type == "cuda" else roofline.HBM_BYTES)
        arg_bytes = cell.arg_bytes()
        estimate = arg_bytes + cell.meta["model_bytes_per_device"]
        rec["memory"] = {"argument_bytes": arg_bytes,
                         "estimate_bytes": estimate,
                         "device_bytes": capacity,
                         "fits_h100": bool(estimate <= capacity)}
        if not rec["memory"]["fits_h100"]:
            rec["error"] = (f"does not fit one card: {estimate / 1e9:.1f} GB "
                            f"estimated against {capacity / 1e9:.1f} GB "
                            f"(a mesh of more cards is its place)")
        else:
            _run(cell, rec, dev, steps, warmup)
            rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    rec["t_total_s"] = round(time.monotonic() - t0, 2)

    _write(rec, out_dir, f"{arch_id}__{shape_name}__{mesh}.json")
    return rec


#: a record's arrays, returned to the caller and not written
_ARRAYS = ("output", "kernel_checks")


def _write(rec, out_dir, name):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump({k: v for k, v in rec.items() if k not in _ARRAYS}, f,
                  indent=1, default=str)


def _abstract(mesh):
    """``mesh`` ("2x2" or a shape tuple; axes as the reference's
    ``--mesh`` names them) as an abstract mesh."""
    dims, axes = (mesh_lib.parse_mesh(mesh) if isinstance(mesh, str) else
                  (tuple(mesh), ("pod", "data", "model")[-len(mesh):]))
    return mesh_lib.abstract_mesh(dims, axes)


def _run_mesh_cell(arch_id, shape_name, out_dir, dev, steps, warmup,
                   reduced, mesh, check_kernels) -> dict:
    cell = build_cell(arch_id, shape_name, device=dev, reduced=reduced,
                      mesh=_abstract(mesh))
    dims, axes = cell.mesh.dims, cell.mesh.axis_names
    n = cell.mesh.size
    shared = dev.type == "cuda" and n > torch.cuda.device_count()
    where = (f"{1 if shared else n}xH100" if dev.type == "cuda"
             else dev.type)
    name = f"{arch_id}__{shape_name}__{cell.mesh.name}@{where}.json"
    rec = {"arch": arch_id, "shape": shape_name, "mesh": cell.mesh.name,
           "axes": list(axes), "n_devices": n, "reduced": reduced,
           "ok": False, "backend": mesh_lib.backend_for(dev, n),
           "ranks_share_one_card": shared,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else dev.type)}
    rec["meta"] = {k: (float(v) if isinstance(v, (int, float)) else v)
                   for k, v in cell.meta.items()}
    capacity = (torch.cuda.get_device_properties(dev).total_memory
                if dev.type == "cuda" else roofline.HBM_BYTES)
    per_rank = capacity // n if shared else capacity
    arg_bytes = cell.arg_bytes_per_device()
    estimate = arg_bytes + cell.meta["model_bytes_per_device"]
    rec["memory"] = {"argument_bytes_per_rank": arg_bytes,
                     "estimate_bytes_per_rank": estimate,
                     "device_bytes_per_rank": per_rank,
                     "fits_per_rank": bool(estimate <= per_rank)}
    t0 = time.monotonic()
    if not rec["memory"]["fits_per_rank"]:
        rec["error"] = (f"does not fit a rank's share: {estimate / 1e9:.1f} "
                        f"GB estimated against {per_rank / 1e9:.1f} GB")
    else:
        try:
            job = mesh_lib.Job(
                params=mesh_lib.CellDraw(arch_id, shape_name, reduced),
                warmup=warmup - 1, repeat=steps, count_ops=True,
                check_kernels=check_kernels)
            rows = [r[0] for r in mesh_lib.run_jobs([job], dims, axes,
                                                    device=dev)]
            key = "step_ms" if dev.type == "cuda" else "host_step_ms"
            rec["output"] = rows[0]["out"]
            rec["ranks"] = [_rank_record(r, row, key)
                            for r, row in enumerate(rows)]
            if check_kernels:
                rec["kernel_checks"] = [row["kernel_checks"] for row in rows]
            rec[key] = max(r[key] for r in rec["ranks"])
            rec["steps"] = steps
            rec["ok"] = True
        except Exception as e:  # noqa: BLE001 — record and continue the sweep
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-3000:]
    rec["t_total_s"] = round(time.monotonic() - t0, 2)
    _write(rec, out_dir, name)
    return rec


def _rank_record(rank: int, row: dict, key: str) -> dict:
    """A rank's part of a mesh cell's record from its ``run_jobs`` row:
    its ms per step (``key``), the launches and collectives of one step,
    the op count and, on the card, its peak memory."""
    rec = {"rank": rank, key: row["ms"],
           "t_materialize_s": row["t_prepare_s"],
           "launches_per_step": row["launches"],
           "collectives_per_step": op_analysis.collectives_by_kind(
               row["collectives"]),
           "ops": row["ops"]}
    if "max_allocated_bytes" in row:
        rec["max_allocated_bytes"] = row["max_allocated_bytes"]
    return rec


def _run(cell, rec, dev, steps, warmup):
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.monotonic()
    gen = torch.Generator(device=dev).manual_seed(0)
    args = cell.materialize(dev, gen)
    _sync(dev)
    rec["t_materialize_s"] = round(time.monotonic() - t1, 2)
    state = {"args": args}

    def step():
        # a train step turns autograd on for its own loss (value_and_grad)
        with torch.no_grad():
            out = cell.fn(*state["args"])
        state["args"] = cell.next_args(state["args"], out)
        return out

    t1 = time.monotonic()
    for _ in range(warmup):
        step()
    _sync(dev)
    rec["t_warmup_s"] = round(time.monotonic() - t1, 2)
    before = K.launch_counts()
    ms = _timed_ms(step, dev, steps)
    rec["launches_per_step"] = {k: (v - before[k]) / steps for k, v in
                                K.launch_counts().items() if v > before[k]}
    rec["steps"] = steps
    if dev.type == "cuda":
        rec["step_ms"] = ms
    else:
        rec["host_step_ms"] = ms       # the CPU's time, not the card's
    _, rec["ops"] = op_analysis.count_ops(step)
    if dev.type == "cuda":
        rec["memory"]["max_allocated_bytes"] = \
            torch.cuda.max_memory_allocated(dev)
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def dry_count(cell, mesh) -> dict:
    """One rank's call of ``cell`` (built on ``mesh``'s shape) on the dry
    ``mesh``, on ``meta``: the op counter's summary of the call, with
    ``argument_bytes`` (the rank's parts of the arguments) and
    ``peak_bytes_per_device`` (those plus the call's own peak), its
    collectives by kind and ``t_count_s``. The call is the one a live
    rank makes (``launch/mesh.py::cell_call``)."""
    args = cell.local_args(mesh)
    arg_bytes = tree_bytes(args)
    call, _ = mesh_lib.cell_call(cell, args)
    del args
    t0 = time.monotonic()
    with runtime.use_mesh(mesh), torch.no_grad():
        out, ops = op_analysis.count_ops(call)
    del out
    ops["argument_bytes"] = arg_bytes
    ops["peak_bytes_per_device"] = arg_bytes + ops["peak_bytes"]
    ops["t_count_s"] = round(time.monotonic() - t0, 2)
    return ops


def dry_run_cell(arch_id: str, shape_name: str, multi_pod: bool = False,
                 out_dir: str = DEFAULT_OUT, mesh=None, ranks=None,
                 reduced: bool = False) -> dict:
    """Count one rank's step of ``arch_id`` × ``shape_name`` on the
    production mesh ((16, 16), or (2, 16, 16) with ``multi_pod``), or on
    ``mesh`` ("2x2" or a shape tuple), on the ``meta`` device; write and
    return the record. ``ranks`` are the ranks counted (default: rank 0
    and the last). A failing cell is recorded (``ok: false``, ``error``)
    and not raised, so a sweep goes on."""
    shape = (mesh_lib.make_production_mesh(multi_pod=multi_pod)
             if mesh is None else _abstract(mesh))
    rec = {"arch": arch_id, "shape": shape_name, "mesh": shape.name,
           "axes": list(shape.axis_names), "n_devices": shape.size,
           "reduced": reduced, "device": DRY, "ok": False}
    ranks = [0, shape.size - 1] if ranks is None else list(ranks)
    t0 = time.monotonic()
    try:
        cell = build_cell(arch_id, shape_name, device=DRY, reduced=reduced,
                          mesh=shape)
        rec["meta"] = {k: (float(v) if isinstance(v, (int, float)) else v)
                       for k, v in cell.meta.items()}
        rec["arg_bytes_per_device"] = cell.arg_bytes_per_device()
        rec["ranks"] = []
        for r in ranks:
            dry = mesh_lib.dry_mesh(shape.dims, shape.axis_names, r)
            row = dry_count(cell, dry)
            row.update(rank=r, coords=dict(dry.coords))
            rec["ranks"].append(row)
        head = max(rec["ranks"], key=lambda r: (r["peak_bytes_per_device"],
                                                r["flops_per_device"]))
        rec["headline_rank"] = head["rank"]
        rec["memory"] = {
            "argument_bytes_per_device": head["argument_bytes"],
            "peak_bytes_per_device": head["peak_bytes_per_device"],
            "device_bytes": roofline.HBM_BYTES,
            "fits_h100": bool(head["peak_bytes_per_device"]
                              <= roofline.HBM_BYTES)}
        rec["ops"] = {k: head[k] for k in (
            "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "collectives_by_kind",
            "collectives_by_group", "kernels", "top_ops")}
        rec["bounded_kernel_counts"] = {
            k: v for r in rec["ranks"] for k, v in r["bounded_kernels"].items()}
        rec["t_count_s"] = round(sum(r["t_count_s"] for r in rec["ranks"]), 2)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    rec["t_total_s"] = round(time.monotonic() - t0, 2)
    _write(rec, out_dir, f"{arch_id}__{shape_name}__{shape.name}@{DRY}.json")
    return rec


def run_all(out_dir: str, production: bool = False, multi_pod: bool = False):
    """One subprocess per cell (a cell's memory goes with its process; one
    bad cell, or one past CELL_TIMEOUT_S, does not stop the sweep)."""
    from repro_torch.configs import registry
    results = []
    extra = (["--production"] if production else []) + \
        (["--multi-pod"] if multi_pod else [])
    for arch in registry.ARCHS.values():
        for shape in arch.shapes:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch.arch_id, "--shape", shape.name,
                   "--out", out_dir, *extra]
            t0 = time.monotonic()
            try:
                p = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=DRY_CELL_TIMEOUT_S if production
                                   else CELL_TIMEOUT_S)
                ok = p.returncode == 0
                tail = (p.stdout + p.stderr)[-400:] if not ok else ""
            except subprocess.TimeoutExpired:
                ok, tail = False, "TIMEOUT"
            results.append((arch.arch_id, shape.name, ok,
                            round(time.monotonic() - t0, 1)))
            print(f"[{'OK' if ok else 'FAIL'}] {arch.arch_id} × {shape.name} "
                  f"({results[-1][3]}s) {tail}", flush=True)
    n_ok = sum(1 for r in results if r[2])
    where = ((f"counted on the {'2x16x16' if multi_pod else '16x16'} mesh "
              f"on meta") if production else "ran on one card")
    print(f"\n{n_ok}/{len(results)} cells {where}")
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--mesh", help="e.g. 2x2 (with pod: 2x2x4): the cell "
                    "as one rank per mesh device")
    ap.add_argument("--production", action="store_true",
                    help="count one rank's step on the production mesh on "
                    "the meta device (no device touched)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production: the (2, 16, 16) mesh")
    args = ap.parse_args()
    if args.multi_pod and not args.production:
        ap.error("--multi-pod goes with --production")
    if not args.production:
        default_device()                 # a run goes on cuda only
    if args.all:
        run_all(args.out, args.production, args.multi_pod)
        return
    rec = (dry_run_cell(args.arch, args.shape, args.multi_pod, args.out)
           if args.production else
           run_cell(args.arch, args.shape, args.out, mesh=args.mesh))
    print(json.dumps({k: v for k, v in rec.items()
                      if k != "traceback" and k not in _ARRAYS},
                     indent=1, default=str))
    if not rec["ok"]:
        print(rec.get("traceback", ""), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
