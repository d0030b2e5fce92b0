"""The port's single-device cell tooling against the reference's, on the
CPU:

  * ``specs.build_cell``'s ``meta`` (``model_flops``,
    ``model_bytes_per_device``, ``params`` and the rest) equals the
    reference's ``build_cell(..., make_mesh((1, 1), ("data", "model")))``
    for every arch × shape; both sides abstract, nothing allocated;
  * the op counter's flops against ``hlo_analysis.analyze_hlo`` of the
    reference's compiled cell (within 10%): SchNet × molecule and
    × full_graph_sm at published widths, DIN × serve_p99 reduced, and a
    small decode shape of reduced smollm-135m;
  * a Python loop of 7 matmuls counts 7× (the HLO analyzer's trip-count
    test, ``test_analyzer_multiplies_scan_bodies``); views move no bytes;
    a hand-written kernel's launch adds its ``cost(...)`` to an active
    counter, and calls it only then;
  * the kernels' ``cost(...)`` give the flops and bytes of the bound
    formulas they replace in ``chip_smoke.py`` phase [3], at its shapes;
  * ``Cell.materialize`` draws arguments of the abstract shapes, graph
    edges padded to a multiple of 512 with sentinel edges;
  * ``run_cell(device="cpu", reduced=True)`` writes a record that
    ``roofline.analyze_row`` reads; a cell that cannot fit one card is
    recorded ``ok: false`` and not run.
"""
import contextlib
import json
import math
import types

import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.launch import specs as jax_specs
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_mesh
from repro_torch import kernels as K
from repro_torch import tree as tree_lib
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.synthetic import zipf_ids
from repro_torch.kernels.augru import ops as augru_ops
from repro_torch.kernels.candidate_scorer import ops as scorer_ops
from repro_torch.kernels.din_attention import ops as din_ops
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.flash_decode import ops as decode_ops
from repro_torch.kernels.rerank_score import ops as rerank_ops
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.launch.op_analysis import OpCounter, count_ops

ALL_CELLS = [(a.arch_id, s.name) for a in jax_registry.ARCHS.values()
             for s in a.shapes]


def _mesh():
    return make_mesh((1, 1), ("data", "model"))


def _arch(reg, arch_id, reduced):
    a = reg.get(arch_id)
    if reduced:
        a = reg.ArchDef(a.arch_id, a.family, a.reduced(a.config), a.shapes,
                        a.reduced)
    return a


# ------------------------------------------------------------------ specs

@pytest.mark.parametrize("arch_id,shape_name", ALL_CELLS)
def test_cell_meta_equals_reference(arch_id, shape_name):
    want = jax_specs.build_cell(arch_id, shape_name, _mesh()).meta
    cell = specs.build_cell(arch_id, shape_name)
    assert cell.meta == want
    assert all(t.device.type == "meta" for t in _leaves(cell.args))


def _leaves(tree):
    return [t for t in tree_lib.leaves(tree) if isinstance(t, torch.Tensor)]


def _same_shapes(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [tuple(t.shape) for t in g] == [tuple(t.shape) for t in w]
    assert [t.dtype for t in g] == [t.dtype for t in w]
    assert all(t.device.type == "cpu" for t in g)


@pytest.mark.parametrize("arch_id,shape_name,reduced", [
    ("schnet", "molecule", False), ("schnet", "full_graph_sm", False),
    ("din", "serve_p99", True), ("din", "train_batch", True),
    ("mind", "retrieval_cand", True), ("two-tower-retrieval", "serve_p99", True),
    ("dien", "retrieval_cand", True)])
def test_materialize_draws_the_abstract_shapes(arch_id, shape_name, reduced):
    cell = specs.build_cell(arch_id, shape_name, reduced=reduced)
    args = cell.materialize("cpu", torch.Generator().manual_seed(1))
    _same_shapes(args, cell.args)
    again = cell.materialize("cpu", torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(args),
                                                 _leaves(again)))


def test_graph_cells_pad_edges_with_sentinels_and_run():
    """A small graph_mini shape through the sampler, and full_graph_sm:
    the edge list is padded to a multiple of 512 with sentinel edges
    (src = dst = N), and a train step runs on them; meta equals the
    reference's for the small shape too."""
    dims = {"n_nodes": 600, "n_edges": 4800, "batch_nodes": 8,
            "fanout": (3, 2), "d_feat": 5}
    arch = _arch(registry, "schnet", True)
    cell = specs.build_gnn_cell(arch, ShapeSpec("mini", "graph_mini", dims))
    want = jax_specs.build_gnn_cell(
        _arch(jax_registry, "schnet", True),
        JaxShapeSpec("mini", "graph_mini", dims), _mesh()).meta
    assert cell.meta == want
    params, opt, batch = cell.materialize("cpu")
    _same_shapes((params, opt, batch), cell.args)
    edges = batch["inputs"]["edges"]
    N = batch["inputs"]["node_feat"].shape[0]
    assert N == 8 + 8 * 3 + 8 * 3 * 2 and edges.shape == (512, 2)
    assert (edges[8 * 3 + 8 * 3 * 2:] == N).all()
    assert (edges[:8 * 3 + 8 * 3 * 2] <= N).all()
    _, _, loss = cell.fn(params, opt, batch)
    assert math.isfinite(float(loss))

    full = specs.build_cell("schnet", "full_graph_sm", reduced=True)
    _, _, batch = full.materialize("cpu")
    e = batch["inputs"]["edges"]
    assert e.shape == (10752, 2) and (e[10556:] == 2708).all()


def test_decode_cell_reads_the_whole_cache():
    """The decode cell's cache holds S - 1 valid rows, so a step reads all
    S; repeated steps write the same row (the cache is not fed back)."""
    arch = _arch(registry, "smollm-135m", True)
    cell = specs.build_lm_cell(arch, ShapeSpec("dec", "decode",
                                               {"seq_len": 32,
                                                "global_batch": 2}))
    params, cache, toks = cell.materialize("cpu")
    assert int(cache.length) == 31 and cache.a.shape[2] == 32
    with torch.no_grad():
        logits, new = cell.fn(params, cache, toks)
        again, _ = cell.fn(*cell.next_args((params, cache, toks),
                                           (logits, new)))
    assert int(new.length) == 32 and int(cache.length) == 31
    torch.testing.assert_close(again, logits, rtol=0, atol=0)


# ------------------------------------------------------------ op counter

def test_op_counter_counts_a_loop_once_per_trip():
    L, M, Kd, N = 7, 256, 512, 512
    ws, x = torch.randn(L, Kd, N), torch.randn(M, Kd)

    def f(ws, x):
        for i in range(L):
            x = x @ ws[i]
        return x
    _, s = count_ops(f, ws, x)
    assert s["flops_per_device"] == 2 * L * M * Kd * N
    assert s["top_ops"]["mm"]["n"] == L
    # each mm reads its operands once and writes its output once; the
    # ws[i] selects are views and move nothing
    assert s["bytes_per_device"] == L * 4 * (M * Kd + Kd * N + M * N)
    assert s["collective_bytes_per_device"] == 0


def test_op_counter_sees_the_backward():
    w = torch.randn(16, 8, requires_grad=True)
    x = torch.randn(4, 16)
    _, fwd = count_ops(lambda: (x @ w).sum())
    _, both = count_ops(lambda: (x @ w).sum().backward())
    assert fwd["flops_per_device"] == 2 * 4 * 16 * 8
    # the backward's mm for w's gradient (x's is not needed)
    assert both["flops_per_device"] == 2 * fwd["flops_per_device"]


@contextlib.contextmanager
def _fake_card(monkeypatch):
    """K.launch on a machine without a card: a C entry that launches
    nothing and returns success."""
    monkeypatch.setattr(K, "kernel", lambda name, device: lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    yield torch.device("cuda", 0)


def test_a_kernel_launch_adds_its_cost_to_an_active_counter(monkeypatch):
    calls = []

    def cost():
        calls.append(1)
        torch.ones(1000).sum()         # the cost's own ops are not counted
        return 123, 456
    with _fake_card(monkeypatch) as dev:
        K.launch("din_attention_f32", "din_attention", dev, cost=cost)
        assert calls == []             # no counter: cost is not called
        with OpCounter() as c:
            K.launch("din_attention_f32", "din_attention", dev, cost=cost)
            K.launch("din_attention_f32", "din_attention", dev, cost=cost)
        K.launch("din_attention_f32", "din_attention", dev, cost=cost)
    s = c.summary()
    assert calls == [1, 1]
    assert s["kernels"] == {"din_attention": {"launches": 2, "flops": 246,
                                              "bytes": 912}}
    assert s["flops_per_device"] == 246 and s["bytes_per_device"] == 912


def test_a_launch_on_another_thread_is_not_added_to_a_counter(monkeypatch):
    """A counter sees only its own thread's aten ops, so it takes only its
    own thread's launches: a service's executor thread launching while a
    counter is active elsewhere adds nothing to it."""
    import threading

    with _fake_card(monkeypatch) as dev:
        with OpCounter() as c:
            other = threading.Thread(target=lambda: K.launch(
                "din_attention_f32", "din_attention", dev,
                cost=lambda: (123, 456)))
            other.start()
            other.join()
            K.launch("din_attention_f32", "din_attention", dev,
                     cost=lambda: (7, 8))
    s = c.summary()
    assert s["kernels"] == {"din_attention": {"launches": 1, "flops": 7,
                                              "bytes": 8}}


def _jax_cell(arch_id, shape, reduced):
    a = _arch(jax_registry, arch_id, reduced)
    build = {"lm": jax_specs.build_lm_cell, "gnn": jax_specs.build_gnn_cell,
             "recsys": jax_specs.build_rec_cell}[a.family]
    mesh = _mesh()
    cell = build(a, shape, mesh)
    return analyze_hlo(cell.jitted(mesh).lower(*cell.args).compile().as_text(),
                       1)


def _port_cell(arch_id, shape, reduced):
    a = _arch(registry, arch_id, reduced)
    build = {"lm": specs.build_lm_cell, "gnn": specs.build_gnn_cell,
             "recsys": specs.build_rec_cell}[a.family]
    cell = build(a, ShapeSpec(shape.name, shape.kind, dict(shape.dims)))
    args = cell.materialize("cpu")
    with torch.no_grad():
        return count_ops(cell.fn, *args)[1]


@pytest.mark.parametrize("arch_id,shape_name,reduced", [
    ("schnet", "molecule", False), ("schnet", "full_graph_sm", False),
    ("din", "serve_p99", True), ("smollm-135m", None, True)])
def test_op_counter_flops_match_the_hlo_analyzer(arch_id, shape_name,
                                                 reduced):
    """Every dot XLA keeps is a matrix product the port dispatches: no op
    is rewritten away on either side at these cells, so the counts agree
    to 0.1% (measured: within 0.01%)."""
    if shape_name is None:
        shape = JaxShapeSpec("decode_small", "decode",
                             {"seq_len": 256, "global_batch": 2})
    else:
        shape = jax_registry.get_shape(jax_registry.get(arch_id), shape_name)
    want = _jax_cell(arch_id, shape, reduced)["flops_per_device"]
    got = _port_cell(arch_id, shape, reduced)["flops_per_device"]
    assert want > 0
    assert abs(got / want - 1) < 1e-3, (got, want)


# ------------------------------------------------------------ kernel costs

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_costs_equal_the_bound_formulas_they_replace():
    """At chip_smoke.py phase [3]'s shapes, each kernel's ``cost(...)``
    gives the flops and bytes its bound was computed from before the
    formulas moved into the package (the old expressions, restated)."""
    rng = np.random.default_rng(0)
    # B3, per table: 16 x 100 single-id bags into a 2^26-row table
    V, D, n = 1 << 26, 18, 1600
    ids = torch.as_tensor(zipf_ids(rng, n, V).reshape(n, 1), dtype=torch.int64)
    uniq = int(torch.unique(ids).numel())
    assert bag_ops.cost([(_meta(V, D), ids, None)]) == \
        (2 * n * D, n * 8 + uniq * D * 4 + n * D * 4)
    # B3 grouped: a DIN micro-batch's five groups, weights on one
    look = [(_meta(1 << 26, 18), torch.as_tensor(rng.integers(0, 1 << 26, (1600, 1))), None, "sum"),
            (_meta(1 << 26, 18), torch.as_tensor(rng.integers(0, 1 << 26, (16, 1))), None, "sum"),
            (_meta(1 << 20, 18), torch.as_tensor(rng.integers(0, 1 << 20, (16, 4))),
             torch.rand(16, 4), "mean"),
            (_meta(1 << 26, 18), torch.as_tensor(rng.integers(0, 1 << 26, (16, 1))), None, "sum"),
            (_meta(1 << 20, 18), torch.as_tensor(rng.integers(0, 1 << 20, (16, 1))), None, "sum")]
    nbytes = flops = 0
    for table_, i, w, _comb in look:
        B, Kb = i.shape
        D = table_.shape[1]
        nbytes += (i.numel() * 8 + (0 if w is None else w.numel() * 4)
                   + int(torch.unique(i).numel()) * D * 4 + B * D * 4)
        flops += 2 * i.numel() * D
    assert bag_ops.cost(look) == (flops, nbytes)
    # B2 at B=16 T=100 D=18 H1=80 H2=40
    B, T, D, H1, H2 = 16, 100, 18, 80, 40
    mask = torch.as_tensor(rng.random((B, T)) > 0.2, dtype=torch.float32)
    args = (_meta(B, T, D), mask, _meta(B, D), _meta(4 * D, H1), _meta(H1),
            _meta(H1, H2), _meta(H2), _meta(H2, 1), _meta(1))
    active = int((mask != 0).sum())
    assert din_ops.cost(*args) == (
        B * 2 * D * H1 + active * (4 * D * H1 + D + 2 * H1 * H2 + 2 * H2
                                   + 2 * D),
        4 * (B * T * D + B * T + B * D + 4 * D * H1 + H1 + H1 * H2 + 2 * H2
             + 1 + B * D))
    # B1 at C=64 T=100, full DIN towers
    C, T, D, d_u, d_i, (H1, H2, M1, M2) = 64, 100, 18, 36, 18, (80, 40, 200, 80)
    K1 = 2 * D + d_u + d_i
    m = torch.as_tensor(rng.random(T) > 0.2, dtype=torch.float32)
    flat = [_meta(4 * D, H1), _meta(H1), _meta(H1, H2), _meta(H2),
            _meta(H2, 1), _meta(1), _meta(K1, M1), _meta(M1), _meta(M1, M2),
            _meta(M2), _meta(M2, 1), _meta(1)]
    active = int((m != 0).sum())
    assert rerank_ops.cost(_meta(T, D), m, _meta(C, D), _meta(d_u),
                           _meta(C, d_i), *flat) == (
        2 * T * D * H1 + C * 2 * D * H1
        + C * active * (2 * D * H1 + D + 2 * H1 * H2 + 2 * H2 + 2 * D)
        + C * 2 * (K1 * M1 + M1 * M2 + M2),
        4 * (T * D + T + C * D + d_u + C * d_i
             + sum(x.numel() for x in flat) + C))
    # B4 at the DIEN path's B=16 and 64, T=100, Din=H=108
    for B in (16, 64):
        T, H = 100, 108
        assert augru_ops.cost(_meta(B, T, H), _meta(B, T), _meta(H, 3 * H),
                              _meta(H, 3 * H), _meta(3 * H)) == (
            2 * B * T * H * 3 * H + B * T * (2 * H * 3 * H + 12 * H),
            4 * (B * T * H + B * T + 2 * H * 3 * H + 3 * H + B * H))
    # B5 at the service, recall and mid-range shapes
    for C, k in ((64, 64), (1_000_000, 8), (1024, 8), (4096, 8)):
        D = 256
        assert scorer_ops.cost(_meta(C, D), _meta(D), k) == \
            (2 * C * D, 4 * (C * D + D) + 12 * k)
    # B6 at the LM service's, decode_32k's and long_500k's shapes
    for B, S, H, G, D, L, dtype in [(4, 64, 3, 3, 64, 40, torch.float32),
                                    (128, 32768, 3, 3, 64, 32763,
                                     torch.float32),
                                    (1, 524288, 8, 4, 128, 524283,
                                     torch.bfloat16)]:
        q = _meta(B, H, G, D, dtype=dtype)
        k = _meta(B, S, H, D, dtype=dtype)
        item = k.element_size()
        assert decode_ops.cost(q, k, k, L) == (
            4 * B * H * G * L * D,
            2 * B * L * H * D * item + 2 * B * H * G * D * item)


def test_roofline_peaks_are_the_h100_data_sheet():
    assert (roofline.HBM_BYTES_PER_S, roofline.FP32_FLOPS_PER_S,
            roofline.BF16_FLOPS_PER_S) == (3.35e12, 67e12, 989e12)
    assert roofline.peak_flops("bfloat16") == 989e12
    assert roofline.peak_flops("float32") == 67e12
    assert roofline.bound_s(67e12, 1.0) == (1.0, "operations")
    assert roofline.bound_s(1.0, 3.35e12) == (1.0, "bytes")


# -------------------------------------------------------------- cell run

def test_run_cell_on_the_cpu_writes_a_record_the_roofline_reads(tmp_path):
    rec = dryrun.run_cell("schnet", "molecule", str(tmp_path), device="cpu",
                          steps=2, warmup=1, reduced=True)
    assert rec["ok"], rec.get("traceback")
    path = tmp_path / "schnet__molecule__1xcpu.json"
    on_disk = json.loads(path.read_text())
    assert on_disk["ops"]["flops_per_device"] > 0
    assert on_disk["memory"]["fits_h100"] is True
    # a CPU run's time is the host's: no device step time, no roofline share
    assert "step_ms" not in on_disk and on_disk["host_step_ms"] > 0
    row = roofline.analyze_row(on_disk)
    assert row["roofline_frac"] is None
    assert row["dominant"] in ("compute", "memory")
    assert row["flops_ratio"] > 0 and row["modelled_frac"] > 0
    assert "| schnet | molecule | yes |" in roofline.markdown_table([row])
    assert roofline.load(str(tmp_path), "1xcpu")[0]["shape"] == "molecule"


def test_a_cell_that_cannot_fit_is_recorded_and_not_run(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(specs.Cell, "materialize",
                        lambda *a, **k: pytest.fail("materialized"))
    rec = dryrun.run_cell("schnet", "ogb_products", str(tmp_path),
                          device="cpu")
    assert rec["ok"] is False and rec["memory"]["fits_h100"] is False
    assert rec["memory"]["estimate_bytes"] > 300e9        # ~365 GB of edges
    assert "does not fit" in rec["error"]
    row = roofline.analyze_row(rec)
    assert "no: does not fit" in roofline.markdown_table([row])


def test_a_failing_cell_is_recorded_and_the_sweep_goes_on(tmp_path,
                                                          monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("cell failed")
    monkeypatch.setattr(specs.Cell, "materialize", boom)
    rec = dryrun.run_cell("schnet", "molecule", str(tmp_path), device="cpu",
                          reduced=True)
    assert rec["ok"] is False and "cell failed" in rec["error"]
    assert (tmp_path / "schnet__molecule__1xcpu.json").exists()


def test_dryrun_cli_asks_for_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "schnet",
                                     "--shape", "molecule"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main()
