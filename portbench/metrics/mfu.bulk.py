"""The bulk model steps' needed flops over the window, against the fp32
peak (%)."""
from portbench.readers import mfu


def read(run):
    return mfu(run)
