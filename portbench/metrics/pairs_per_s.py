"""Pairs whose scores reached the host, a second of the window."""
from portbench.readers import rate


def read(run):
    return rate(run)
