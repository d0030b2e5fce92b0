"""Cells whose small CPU sizes ``small.py`` does not list: the tests that
run every cell of ``BENCHMARK.json`` on the CPU (``small.overrides``) take
them from their own modules. Loaded before the test modules of this
folder import ``overrides``."""
from portbench.tests import small, small_decode

_listed = small.overrides


def overrides(workload: str) -> dict:
    if workload == small_decode.CELL:
        return small_decode.overrides()
    return _listed(workload)


small.overrides = overrides
