"""The din_attention kernels' share of their roofline (%), traced."""
from portbench.readers import roofline


def read(run):
    return roofline(run, "din_attention")
