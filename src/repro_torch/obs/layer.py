"""Layer spans: the program's one way to mark a layer of its model step.

The port carries two kinds of span:

  * request spans (``obs.trace``): the ``Tracer``'s per-request spans
    through the SEDP executors, on the executor's wall or virtual clock;
  * layer spans (:func:`span`): ``with span("model.attention"): ...``
    around a layer of a model step or a kernel wrapper's host path, on
    the profiler's clock. With ``torch.profiler`` running, a span is a
    ``record_function`` and lands in the profiler's Chrome trace as a
    ``user_annotation`` event, on the same timeline as the device's
    kernels and copies; a trace reader matches each kernel to the span its
    launch lay in. With the profiler off, a span costs one check and
    returns a shared null context.

No span belongs inside a loop over time steps or items: a layer is marked
once a call.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager marking layer ``name``: a ``record_function``
    while the torch profiler runs, else one shared ``nullcontext``."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(name)
