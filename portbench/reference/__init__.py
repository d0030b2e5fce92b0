"""Plain PyTorch references, one module a configuration: ``draw`` (the
weights from the seed, in the layout of the program's ``init``),
and ``scores`` (a batch of (user, item) pairs). They import nothing of
the program."""
