"""Pytest settings of the benchmark's tests: the ``card`` marker (tests
that need a CUDA device; they skip without one, deciding inside the
``card`` fixture, never at import) and the paths the tests import from.

Run the card tests on a machine with the card:
``python3 -m pytest -q portbench/tests -m card``."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python3 -m pytest -q portbench/tests -m card`")
    return torch.device("cuda")
