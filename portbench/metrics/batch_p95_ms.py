"""The 95th percentile over every batch of the window, from its enqueue
to its scores on the host (ms)."""
from portbench.readers import percentile_ms


def read(run):
    return percentile_ms(run.window.get("latencies"), 95)
