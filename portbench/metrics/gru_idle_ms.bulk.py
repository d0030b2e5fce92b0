"""Device idle ms a batch while the host is inside DIEN's ``model.gru``
span (traced)."""
from portbench import spans

spans.install()


def read(run):
    return spans.span_idle_ms(run, "model.gru")
