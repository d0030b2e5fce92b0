"""The program's layer spans as the traced sub-window reads them: the
reduction by span name (device work matched to its launch by
correlation, idle time while the host is in a span, launches), the
readers' figures a call, the wrapper of the harness's reduction, the four
span metrics, and the spans of a real cell's loop traced on the CPU."""
import json
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, spans, tracing
from portbench.tests.small import overrides


def _span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "ph": "X"}


def _host(name, ts, corr, cat="cuda_runtime"):
    return {"cat": cat, "name": name, "ts": ts, "dur": 5.0,
            "args": {"correlation": corr}}


def _dev(ts, dur, corr, cat="kernel"):
    return {"cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


#: a window [0, 1000) us holding two model steps. The first step's GRU
#: launches three kernels, one of each name form, and the third of them
#: runs while the host is in the second step; a span that starts before
#: the window is left out, though its kernel runs inside it; one kernel
#: matches no host event.
EVENTS = [
    _span(tracing.WINDOW, 0.0, 1000.0),
    {"cat": "gpu_user_annotation", "name": "model.step", "ts": 0.0,
     "dur": 900.0},
    _span("model.step", -50.0, 100.0), _host("cudaLaunchKernel", -40.0, 7),
    _span("model.step", 100.0, 300.0),
    _span("model.gru", 150.0, 150.0),
    _host("cudaLaunchKernel", 160.0, 1),
    _host("cuLaunchKernel", 200.0, 2, "cuda_driver"),
    _host("cudaGraphLaunch", 250.0, 3),
    _span("model.augru", 310.0, 80.0),
    _span("kernel.augru", 320.0, 60.0),
    _host("cudaLaunchKernelExC", 330.0, 4),
    _span("model.step", 420.0, 280.0),
    _span("model.gru", 430.0, 170.0),
    _host("cudaLaunchKernel", 440.0, 5),
    _host("cudaMemcpyAsync", 650.0, 6),
    _host("cudaEventSynchronize", 720.0, 40),
    {"cat": "cpu_op", "name": "aten::mm", "ts": 440.0, "dur": 20.0},
    _dev(0.0, 20.0, 7),
    _dev(170.0, 30.0, 1), _dev(200.0, 40.0, 2),
    _dev(450.0, 50.0, 3),       # launched in the first step's model.gru
    _dev(500.0, 20.0, 4), _dev(520.0, 40.0, 5),
    _dev(660.0, 10.0, 6, "gpu_memcpy"),
    _dev(900.0, 10.0, 99),      # no host event has its correlation
]
# device busy [0, 20), [170, 240), [450, 560), [660, 670), [900, 910):
# idle [20, 170), [240, 450), [560, 660), [670, 900), [910, 1000)


def test_reduction_by_span_name():
    got = spans.reduce(EVENTS)
    assert got["unmatched_s"] == pytest.approx(10e-6)
    s = got["spans"]
    assert sorted(s) == ["kernel.augru", "model.augru", "model.gru",
                         "model.step"]
    want = {
        # steps [100, 400) and [420, 700); the one from -50 is left out
        "model.step": dict(count=2, host_s=580e-6,
                           device_s=(30 + 40 + 50 + 20 + 40 + 10) * 1e-6,
                           idle_s=(70 + 160 + 30 + 100 + 30) * 1e-6,
                           launches=5),
        # [150, 300) and [430, 600): the kernel of correlation 3 by its
        # launch at 250, though it ran in [450, 500); the idle gap
        # [240, 450) lies half inside the first
        "model.gru": dict(count=2, host_s=320e-6,
                          device_s=(30 + 40 + 50 + 40) * 1e-6,
                          idle_s=(20 + 60 + 20 + 40) * 1e-6, launches=4),
        "model.augru": dict(count=1, host_s=80e-6, device_s=20e-6,
                            idle_s=80e-6, launches=1),
        "kernel.augru": dict(count=1, host_s=60e-6, device_s=20e-6,
                             idle_s=60e-6, launches=1),
    }
    for name, fig in want.items():
        assert s[name] == pytest.approx(fig), name


def test_reduction_without_a_window_or_spans():
    assert spans.reduce(EVENTS[1:]) is None
    bare = [e for e in EVENTS if not e["name"].startswith(spans.PREFIXES)]
    got = spans.reduce(bare)
    assert got["spans"] == {}
    assert got["unmatched_s"] == pytest.approx(10e-6)


def _run(trace):
    return SimpleNamespace(trace=trace)


def test_readers_give_a_call_or_none():
    tr = {"calls": 2, **spans.reduce(EVENTS)}
    run = _run(tr)
    assert spans.span_host_ms(run, "model.step") == pytest.approx(0.29)
    assert spans.span_device_ms(run, "model.gru") == pytest.approx(0.08)
    assert spans.span_idle_ms(run, "model.gru") == pytest.approx(0.07)
    assert spans.span_launches(run, "model.step") == pytest.approx(2.5)
    for reader in (spans.span_host_ms, spans.span_device_ms,
                   spans.span_idle_ms, spans.span_launches):
        assert reader(_run(None), "model.step") is None
        assert reader(run, "model.absent") is None
        # the parent's program: a trace without spans
        assert reader(_run({"calls": 2, "spans": {}}), "model.step") is None
        assert reader(_run({"calls": 2}), "model.step") is None
        assert reader(_run({**tr, "calls": 0}), "model.step") is None


def test_install_adds_spans_to_the_harness_reduction(monkeypatch):
    base = getattr(tracing.reduce, "base", tracing.reduce)
    monkeypatch.setattr(tracing, "reduce", base)
    spans.install()
    wrapped = tracing.reduce
    spans.install()
    assert tracing.reduce is wrapped and wrapped is not base
    got, plain = wrapped(EVENTS), base(EVENTS)
    assert {k: got[k] for k in plain} == plain
    assert got["spans"] == spans.reduce(EVENTS)["spans"]
    assert got["unmatched_s"] == pytest.approx(10e-6)
    assert wrapped([e for e in EVENTS if e["cat"] != "kernel"
                    and e["cat"] != "gpu_memcpy"]) is None


@pytest.mark.parametrize("metric,cell,want", [
    ("host_ms.bulk", "dien.bulk", 0.29),
    ("launches.bulk", "din.bulk", 2.5),
    ("gru_ms.bulk", "dien.bulk", 0.08),
    ("gru_idle_ms.bulk", "dien.bulk", 0.07)])
def test_span_metrics_read_their_span(metric, cell, want):
    entry = next(m for m in harness.load_bench()["per_layer"]
                 if m["name"] == metric)
    assert entry["source"] == "program_span" and cell in entry["workloads"]
    mod = harness.load_module(harness.find("metrics", metric, ".py"))
    assert mod.read(_run({"calls": 2, **spans.reduce(EVENTS)})) == \
        pytest.approx(want)
    assert mod.read(_run({"calls": 2, "spans": {}})) is None
    assert mod.read(_run(None)) is None


@pytest.mark.parametrize("cell,layers", [
    ("din.bulk", ["model.lookup", "model.hist_mask", "model.attention",
                  "model.score_mlp"]),
    ("dien.bulk", ["model.lookup", "model.hist_mask", "model.gru",
                   "model.attention", "model.augru", "model.score_mlp"])])
def test_a_cells_loop_traced_on_the_cpu_gives_each_span_once_a_call(
        cell, layers, tmp_path):
    """The cell's dispatch loop at small sizes, traced as the harness
    traces it: every layer span once a call, each kernel span at least
    once a call; on the CPU no device event, so no launch."""
    c = harness.prepare(cell, 2**31 + 29, "cpu", overrides(cell))
    with torch.no_grad():
        c.loop.run(count=1)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function(tracing.WINDOW):
                got = c.loop.run(count=3)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    s = spans.reduce(events)["spans"]
    for name in ["model.step", *layers]:
        assert s[name]["count"] == got["calls"] == 3, name
        assert s[name]["launches"] == 0 and s[name]["device_s"] == 0
        assert s[name]["host_s"] <= s["model.step"]["host_s"]
    kernels = {"din.bulk": ["kernel.embedding_bag", "kernel.din_attention"],
               "dien.bulk": ["kernel.embedding_bag", "kernel.augru"]}[cell]
    for name in kernels:
        assert s[name]["count"] >= 3, name
