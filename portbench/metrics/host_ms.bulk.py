"""Host ms a batch inside the program's ``model.step`` span: the host's
enqueue of one batch (traced, the profiler's own cost included)."""
from portbench import spans

spans.install()


def read(run):
    return spans.span_host_ms(run, "model.step")
