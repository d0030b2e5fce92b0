"""Latent rows the program's MLA decode kernel loads a valid row, from
one launch with the kernel's rows counter on over the cell's cache (1: no
row past a sequence's length is read; the plain absorbed path reads the
whole cache, ~1.36 here). None where the program has no such counter."""


def read(run):
    if run.trace is None:
        return None
    return run.loop.rows_read()
