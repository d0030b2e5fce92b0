"""Device ms a batch of the kernels launched inside DIEN's ``model.gru``
span: the GRU's input projection, its 100 steps and their stack
(traced)."""
from portbench import spans

spans.install()


def read(run):
    return spans.span_device_ms(run, "model.gru")
