"""One run of one cell: set-up, the measured window, the traced
sub-window, the comparison with the reference, and the result line.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (``configs/<config>.json``, reference
``reference/<config>.py``), traffic (``traffic/<traffic>.json``, whose
``"loop"`` names ``loops/<loop>.py``), limits (``cells/<cell>.json``),
and each metric's reader (``metrics/<metric>.py``)."""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from portbench import gen, program
from portbench.loops.common import sync

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path):
    """A module of the benchmark by its file (names may hold dots)."""
    name = "portbench._by_path." + path.relative_to(HERE).as_posix()
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def find(kind: str, name: str, ext: str) -> Path:
    """``<kind>/<name><ext>`` under the benchmark, which must exist."""
    path = HERE / kind / f"{name}{ext}"
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(HERE.parent)}")
    return path


def load_bench() -> dict:
    return load_json(BENCHMARK)


def cell_entry(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, kind: str, workload: str) -> list[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics: those that list
    it, or list no cells."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def merged(base: dict, over: dict | None) -> dict:
    out = dict(base)
    out.update(over or {})
    return out


class Run(SimpleNamespace):
    """What the metric readers read (``readers.py``)."""

    def count(self, module: str, slot: int):
        key = (module, slot)
        if key not in self.counts:
            mod = load_module(find("costs", module, ".py"))
            fn = getattr(mod, self.loop.name, None)
            self.counts[key] = (None if fn is None else
                                fn(self.cfg, self.loop.ring[slot], self.weights))
        return self.counts[key]


def prepare(workload: str, seed: int, device,
            overrides: dict | None = None) -> SimpleNamespace:
    """The cell's set-up without its warm-up: files found, the program's
    kernels built or loaded, weights drawn and the loop's ring of inputs
    made on ``device`` from ``seed``.
    ``overrides`` ({"config": {...}, "traffic": {...}}) replace keys of
    the configuration and the traffic (smaller sizes for tests)."""
    device = torch.device(device)
    bench = load_bench()
    entry = cell_entry(bench, workload)
    overrides = overrides or {}
    cfg = merged(load_json(find("configs", entry["config"], ".json")),
                 overrides.get("config"))
    traffic = merged(load_json(find("traffic", entry["traffic"], ".json")),
                     overrides.get("traffic"))
    limits = load_json(find("cells", workload, ".json"))["limits"]
    ref = load_module(find("reference", entry["config"], ".py"))
    loop_mod = load_module(find("loops", traffic["loop"], ".py"))
    w_seed, t_seed = gen.seeds(seed, 2)
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    program.module(cfg)
    phases = {}
    t = time.perf_counter()
    program.build(cfg, device)
    phases["build_s"] = time.perf_counter() - t
    with torch.no_grad():
        t = time.perf_counter()
        weights = ref.draw(gen.generator(w_seed, device), cfg)
        sync(device)
        phases["weights_s"] = time.perf_counter() - t
        cell = SimpleNamespace(bench=bench, entry=entry, cfg=cfg,
                               traffic=traffic, limits=limits, ref=ref,
                               weights=weights, device=device,
                               gen=gen.generator(t_seed, device),
                               phases=phases)
        t = time.perf_counter()
        cell.loop = loop_mod.Loop(cell)
        sync(device)
        phases["inputs_s"] = time.perf_counter() - t
    return cell


def compared(checks: dict, limits: dict) -> dict:
    """Each number compared, with its limit."""
    return {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}


def within(comp: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in comp.values())


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, overrides: dict | None = None) -> dict:
    """Run ``workload`` once on ``device`` and return its result: the
    contract's keys, "setup_phases" (the seconds of each phase of set-up:
    ``build_s``, the kernels' nvcc build on a checkout's first run and
    their load after it, is one) and last "checks" (each number
    compared, with its limit). ``t_start`` is the host clock at process
    start."""
    kind = "per_layer" if trace else "end_to_end"
    cell = prepare(workload, seed, device, overrides)
    device, loop = cell.device, cell.loop
    chosen = metrics_of(cell.bench, kind, workload)
    readers = {m["name"]: load_module(find("metrics", m["name"], ".py"))
               for m in chosen}
    with torch.no_grad():
        t = time.perf_counter()
        loop.run(count=cell.traffic["warm_calls"])
        cell.phases["warm_s"] = time.perf_counter() - t
        setup_s = time.perf_counter() - t_start
        window = loop.run(seconds=seconds)
        traced = None
        if trace and device.type == "cuda":
            from portbench import tracing
            traced = tracing.profile(loop, cell.traffic["profile_seconds"])
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        outputs = loop.outputs()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = compared(loop.check(outputs), cell.limits)
    run = Run(cfg=cell.cfg, traffic=cell.traffic, loop=loop,
              weights=cell.weights, window=window, trace=traced,
              setup_s=setup_s, counts={}, peak=peaks(device))
    metrics = {}
    for m in chosen:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.entry["chips"], "memory_peak_bytes": peak}
    out = {"correct": within(checks) and window["items"] > 0,
           "attempted": window["items"], "failed": 0,
           "metrics": metrics, "device": dev}
    phases = {"before_s": setup_s - sum(cell.phases.values()),
              **cell.phases}
    print("portbench: set-up " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items())
        + " (before_s: imports, the device)", file=sys.stderr)
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        out["breakdown"] = {"device_ops": traced["device_ops"],
                            "idle_gaps": traced["idle_gaps"]}
    out["setup_phases"] = phases
    out["checks"] = checks
    return out


def peaks(device) -> dict | None:
    """The chip's published peaks (``peaks.json``); None off the card,
    where no share of a peak is read."""
    if device.type != "cuda":
        return None
    table = load_json(HERE / "peaks.json")
    name = torch.cuda.get_device_name(device)
    if name not in table:
        raise KeyError(f"no peaks for {name!r} in portbench/peaks.json")
    return table[name]
