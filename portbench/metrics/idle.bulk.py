"""Share of the traced window with the device idle (%), bulk cells."""
from portbench.readers import idle


def read(run):
    return idle(run)
