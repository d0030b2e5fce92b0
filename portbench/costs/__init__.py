"""Frozen operation and byte counts, one module a layer (``<layer>.py``),
each with a function per dispatch loop (``pairs(cfg, batch, weights)``)
that returns the (flops, bytes) that the layer's mathematics needs for
that call, from its shapes and ids: a multiply-add is 2 flops, an
elementwise sum or product 1, a nonlinearity 0; each input byte read once and each output byte written
once, of the valid history steps only; distinct table rows once. Counts
are lower bounds of any implementation's work, so a share of a roofline
that reads over 100% means a time that leaves out work."""
