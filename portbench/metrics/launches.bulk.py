"""Kernel launches a batch inside the program's ``model.step`` span
(traced)."""
from portbench import spans

spans.install()


def read(run):
    return spans.span_launches(run, "model.step")
