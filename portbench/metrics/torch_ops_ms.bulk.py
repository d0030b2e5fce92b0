"""Device ms a batch in kernels the port did not write (traced)."""
from portbench.readers import torch_ops_ms


def read(run):
    return torch_ops_ms(run)
