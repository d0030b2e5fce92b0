"""Cell run on one H100: build every (arch × shape) cell on the card, run
it, and record its time, memory and counted work.

The counterpart of the reference's dry-run, which lowers and compiles each
cell for a TPU mesh without running it. Eager PyTorch has no compile step
to stop at, so a cell that fits the card is run:

  * before anything is allocated, the cell's argument bytes plus its
    ``meta["model_bytes_per_device"]`` are set against the card's memory
    (``fits_h100``); a cell that cannot fit is recorded ``ok: false`` with
    its estimate and not launched (it waits for a device mesh, ROADMAP A8);
  * otherwise its arguments are drawn on the card (``Cell.materialize``),
    then come warm-up steps, N steps timed with CUDA events, one step
    counted by ``launch/op_analysis.py`` (flops, bytes, the kernels'
    launches) and one step under torch.profiler (device busy time, idle
    share); ``max_memory_allocated`` is recorded.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch schnet --shape molecule
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all      # subprocesses

Records: ``<out>/<arch>__<shape>__1xH100.json`` (``1xcpu`` for a CPU run,
whose times are the host's and are not written as the card's). The CLI
runs on ``cuda`` only; :func:`run_cell` also takes ``device="cpu"``.
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

from repro_torch import default_device
from repro_torch import kernels as K
from repro_torch.launch import op_analysis, roofline
from repro_torch.launch.specs import build_cell

DEFAULT_OUT = "artifacts/dryrun"
CELL_TIMEOUT_S = 1800


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


def profile_step(run, dev) -> dict:
    """One call of ``run`` under torch.profiler: its wall, the device's
    busy time (the device events' durations summed from the raw trace)
    and idle share, and the largest kernels by device time. A pass that
    comes back without device events (it happens on a short step) is
    repeated, up to three calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        _sync(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            _sync(dev)
            wall = time.perf_counter() - t0
        by_name: dict = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                n, ns = by_name.get(e.name(), (0, 0))
                by_name[e.name()] = (n + 1, ns + e.duration_ns())
        if by_name:
            break
    busy = sum(ns for _, ns in by_name.values()) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall if wall else None,
            "device_events": sum(n for n, _ in by_name.values()),
            "top": [(name[:90], n, ns / 1e9) for name, (n, ns) in top]}


def run_cell(arch_id: str, shape_name: str, out_dir: str = DEFAULT_OUT,
             device=None, steps: int = 5, warmup: int = 2,
             reduced: bool = False) -> dict:
    """Build, fit-check, run, time and count one cell on ``device``
    (``cuda`` if None); write and return its record. An exception inside
    the cell is recorded (``ok: false``, ``error``) and not raised, so a
    sweep goes on."""
    dev = default_device(device)
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
                            f"(waits for a device mesh, ROADMAP A8)")
        else:
            _run(cell, rec, dev, steps, warmup)
            rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    rec["t_total_s"] = round(time.monotonic() - t0, 2)

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch_id}__{shape_name}__{mesh}.json"),
              "w") as f:
        json.dump(rec, f, indent=1, default=str)
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
        rec["profile"] = profile_step(step, dev)
        rec["memory"]["max_allocated_bytes"] = \
            torch.cuda.max_memory_allocated(dev)
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run_all(out_dir: str):
    """One subprocess per cell (a cell's memory goes with its process; one
    bad cell, or one past CELL_TIMEOUT_S, does not stop the sweep)."""
    from repro_torch.configs import registry
    results = []
    for arch in registry.ARCHS.values():
        for shape in arch.shapes:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch.arch_id, "--shape", shape.name,
                   "--out", out_dir]
            t0 = time.monotonic()
            try:
                p = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=CELL_TIMEOUT_S)
                ok = p.returncode == 0
                tail = (p.stdout + p.stderr)[-400:] if not ok else ""
            except subprocess.TimeoutExpired:
                ok, tail = False, "TIMEOUT"
            results.append((arch.arch_id, shape.name, ok,
                            round(time.monotonic() - t0, 1)))
            print(f"[{'OK' if ok else 'FAIL'}] {arch.arch_id} × {shape.name} "
                  f"({results[-1][3]}s) {tail}", flush=True)
    n_ok = sum(1 for r in results if r[2])
    print(f"\n{n_ok}/{len(results)} cells ran on one card")
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    default_device()                     # the CLI runs on cuda only
    if args.all:
        run_all(args.out)
        return
    rec = run_cell(args.arch, args.shape, args.out)
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"},
                     indent=1, default=str))
    if not rec["ok"]:
        print(rec.get("traceback", ""), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
