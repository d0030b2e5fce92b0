"""Process start to the first timed second: imports, the device, the
kernels' build or load, weights and inputs drawn, every shape warmed."""


def read(run):
    return run.setup_s
