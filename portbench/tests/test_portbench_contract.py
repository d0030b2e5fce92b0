"""BENCHMARK.json keeps to the benchmark's contract: its keys, names,
units, bounds, cells, configurations and the metrics each cell
reports."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"]: w for w in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per_token")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_units_and_whys():
    items = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[kind]]
        assert len(names) == len(set(names))
    for x in items:
        assert NAME.match(x["name"]), x["name"]
        for text in (x.get("why"), x.get("layer"), x.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://")
        assert c["file"].startswith("portbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert not [k for k in c["reduced"] if WIDTHS.search(k)]
        assert any(w["config"] == c["name"] for w in CELLS.values())


def test_cells():
    pairs = [(w["config"], w["traffic"]) for w in CELLS.values()]
    assert len(pairs) == len(set(pairs))
    assert 1 <= len(CELLS) <= 24
    for w in CELLS.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()


def reported(kind: str, cell: str) -> set:
    return {m["name"] for m in BENCH[kind]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_enough(cell):
    e2e = reported("end_to_end", cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert reported("per_layer", cell)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert E2E["setup_s"]["bound"] == 0.25


def test_per_layer_metrics_move_what_their_cells_report():
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in E2E and m["workloads"]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert m["moves"] in reported("end_to_end", cell)
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert {"model step", "device"} <= set(layers)
