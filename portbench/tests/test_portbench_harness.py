"""The harness finds each configuration, traffic mix, loop, limit file,
cost count and metric reader by name; a run without a card exits
non-zero and names the missing device; every cell runs end to end on the
CPU at small sizes and comes out correct; the readers and the trace's
reduction read what they are given."""
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness, readers, tracing
from portbench.tests.small import overrides

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_is_found_by_name(cell):
    entry = harness.cell_entry(harness.load_bench(), cell)
    cfg = harness.load_json(harness.find("configs", entry["config"], ".json"))
    traffic = harness.load_json(harness.find("traffic", entry["traffic"],
                                             ".json"))
    assert cfg["name"] == entry["config"]
    assert harness.find("reference", entry["config"], ".py").is_file()
    assert harness.load_module(harness.find("loops", traffic["loop"], ".py")
                               ).Loop.name == traffic["loop"]
    assert harness.load_json(harness.find("cells", cell, ".json"))["limits"]
    assert harness.load_module(harness.find("costs", cfg["model"], ".py"))


@pytest.mark.parametrize("metric", sorted(
    {m["name"] for k in ("end_to_end", "per_layer")
     for m in harness.load_bench()[k]}))
def test_every_metric_has_a_reader(metric):
    mod = harness.load_module(harness.find("metrics", metric, ".py"))
    assert callable(mod.read)


def test_a_missing_file_is_named():
    with pytest.raises(FileNotFoundError, match="traffic/nosuch.json"):
        harness.find("traffic", "nosuch", ".json")
    with pytest.raises(KeyError, match="nosuch"):
        harness.cell_entry(harness.load_bench(), "nosuch")


def test_run_without_a_card_exits_nonzero_and_names_it():
    got = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "din.bulk",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert got.returncode != 0
    assert "no CUDA device" in got.stderr
    assert got.stdout.strip() == ""


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_on_the_cpu_and_is_correct(cell):
    out = harness.run_cell(cell, 2**31 + 17, 0.2, False, "cpu",
                           time.perf_counter(), overrides(cell))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    e2e = {m["name"] for m in harness.metrics_of(harness.load_bench(),
                                                 "end_to_end", cell)}
    assert set(out["metrics"]) == e2e
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def test_the_same_seed_gives_the_same_inputs():
    a = harness.prepare("din.bulk", 2**31 + 3, "cpu", overrides("din.bulk"))
    b = harness.prepare("din.bulk", 2**31 + 3, "cpu", overrides("din.bulk"))
    c = harness.prepare("din.bulk", 2**31 + 4, "cpu", overrides("din.bulk"))
    ha, hb, hc = (x.loop.ring[1]["user"]["hist"] for x in (a, b, c))
    assert torch.equal(ha, hb) and not torch.equal(ha, hc)
    assert torch.equal(a.weights["mlp"][0]["w"], b.weights["mlp"][0]["w"])
    # the same amount of work: the same multiset of history lengths
    la, lc = ((h >= 0).sum(1).sort().values for h in (ha, hc))
    assert torch.equal(la, lc)


def _run(**kw):
    base = dict(loop=SimpleNamespace(name="pairs", ring=[None, None]),
                cfg={"model": "x"}, window={"seconds": 2.0, "items": 10,
                                            "slots": np.array([3, 2])},
                trace=None, setup_s=7.5, peak={"fp32_flops_per_s": 100.0,
                                               "hbm_bytes_per_s": 10.0})
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers_read_what_they_are_given():
    run = _run(count=lambda module, slot: (20.0, 5.0))
    assert readers.rate(run) == 5.0
    # (3 + 2) steps x 20 flops / 2 s / 100 flops/s
    assert readers.mfu(run) == pytest.approx(50.0)
    assert readers.idle(run) is None and readers.roofline(run, "x") is None
    run.trace = {"slots": np.array([1, 1]), "layer_s": {"b3": 2.0},
                 "busy_s": 0.75, "window_s": 1.0, "other_s": 0.5, "calls": 2}
    # 2 calls x max(20 / 100, 5 / 10) s over 2 s of kernels
    assert readers.roofline(run, "b3") == pytest.approx(50.0)
    assert readers.roofline(run, "absent") is None
    assert readers.idle(run) == pytest.approx(25.0)
    assert readers.torch_ops_ms(run) == pytest.approx(250.0)
    assert readers.percentile_ms([0.001] * 19 + [0.1], 95) == pytest.approx(
        5.95)
    mod = harness.load_module(harness.find("metrics", "batch_p95_ms", ".py"))
    assert mod.read(_run(window={"latencies": []})) is None
    assert readers.mfu(_run(peak=None)) is None


def test_trace_reduction():
    ev = [{"cat": "user_annotation", "name": tracing.WINDOW, "ts": 0.0,
           "dur": 100.0, "ph": "X"},
          {"cat": "kernel", "name": "void (anonymous namespace)::"
           "din_attention_fused(float const*)", "ts": 10.0, "dur": 30.0},
          {"cat": "kernel", "name": "at::native::silu_kernel", "ts": 30.0,
           "dur": 20.0},
          {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60.0, "dur": 10.0},
          {"cat": "gpu_user_annotation", "name": tracing.WINDOW, "ts": 0.0,
           "dur": 100.0},
          {"cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 12.0},
          {"cat": "cuda_runtime", "name": "cudaEventSynchronize", "ts": 55.0,
           "dur": 40.0}]
    got = tracing.reduce(ev)
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["busy_s"] == pytest.approx(50e-6)       # [10, 50) and [60, 70)
    assert got["layer_s"] == {"din_attention": pytest.approx(30e-6)}
    assert got["other_s"] == pytest.approx(20e-6)
    assert got["copy_s"] == pytest.approx(10e-6)
    # each gap by the innermost host event at its start: [0, 10), [50, 60)
    # (no event), [70, 100)
    assert dict(got["idle_gaps"]) == {
        "aten::mm": pytest.approx(10e-6),
        "host: no recorded op": pytest.approx(10e-6),
        "cudaEventSynchronize": pytest.approx(30e-6)}
    assert tracing.reduce(ev[:1] + ev[5:]) is None


def test_every_kernel_of_the_port_has_a_layer():
    src = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    layers = tracing.kernel_layers()
    import re
    names = set()
    for f in src.glob("*.cu"):
        names.update(re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?"
                                r"(\w+)", f.read_text()))
    names.discard("launch_floor_kernel")
    assert names
    for n in names:
        assert tracing.layer_of(f"void (anonymous namespace)::{n}<float>(x)",
                                layers), n
