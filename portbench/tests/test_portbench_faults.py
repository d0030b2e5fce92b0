"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a card is skipped and the rest of a run is driven
on the CPU at small sizes, with the program's entry altered where its
answers are produced."""
import importlib
import time

import pytest

from portbench import harness
from portbench.tests.small import overrides


def one_score_altered(scores):
    scores = scores.clone()
    scores[scores.shape[0] // 3] += 1e-3
    return scores


def half_the_batch_left_out(scores):
    scores = scores.clone()
    scores[scores.shape[0] // 2:] = 0.5
    return scores


FAULTS = [one_score_altered, half_the_batch_left_out]
CASES = [(cell, "serve_scores", f) for cell in ("din.bulk", "dien.bulk")
         for f in FAULTS]


@pytest.mark.parametrize("cell,entry,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, _, f in CASES])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, entry, fault):
    cfg = harness.load_json(harness.find(
        "configs", harness.cell_entry(harness.load_bench(), cell)["config"],
        ".json"))
    mod = importlib.import_module(cfg["program"])
    sound = getattr(mod, entry)
    monkeypatch.setattr(mod, entry,
                        lambda *a, **k: fault(sound(*a, **k)))
    out = harness.run_cell(cell, 2**31 + 29, 0.2, False, "cpu",
                           time.perf_counter(), overrides(cell))
    assert not out["correct"], out["checks"]
