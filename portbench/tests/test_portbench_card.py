"""On the card (skipped without one): at the published widths with the
tables cut to 2^16 rows and smaller rings, a sound run is correct and the
control, the reference in TF32 in the program's place, is not."""
import time

import pytest
import torch

from portbench import control, harness

CUT = {"din.bulk": {"batch": 8192, "ring": 2, "warm_calls": 2},
       "dien.bulk": {"batch": 4096, "ring": 2, "warm_calls": 2}}


def cut(cell: str) -> dict:
    cfg = harness.load_json(harness.find(
        "configs", harness.cell_entry(harness.load_bench(), cell)["config"],
        ".json"))
    fields = {k: [dict(f, vocab=min(f["vocab"], 1 << 16)) for f in cfg[k]]
              for k in ("user_fields", "item_fields")}
    return {"config": fields, "traffic": CUT[cell]}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CUT))
def test_the_control_is_not_correct(card, cell):
    limits = harness.load_json(harness.find("cells", cell, ".json"))["limits"]
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        got = control.readings(cell, seed, card, True, cut(cell))
        assert harness.within(harness.compared(got["program"], limits))
        assert not harness.within(harness.compared(got["control"], limits))
    torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CUT))
def test_a_short_run_is_correct_on_the_card(card, cell):
    out = harness.run_cell(cell, 2**31 + 9, 1.0, True, card,
                           time.perf_counter(), cut(cell))
    assert out["correct"], out["checks"]
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    torch.cuda.empty_cache()
