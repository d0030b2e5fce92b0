"""Helpers of the metric readers (``metrics/<metric>.py``). A reader's
``read(run)`` returns the metric's value, or None where the run holds
nothing to read it from; the harness then leaves the metric out.

``run`` carries the window of the run (``run.window``: "seconds",
"items", "slots", and the loop's own lists), the traced sub-window
(``run.trace``, None without ``--trace 1`` or without device events),
``run.setup_s``, the chip's peaks (``run.peak``, None off the card) and ``run.count(module,
slot)``, a layer's (flops, bytes) for one ring slot from
``costs/<module>.py``, or None where the layer is not on the loop's
path."""
from __future__ import annotations

import numpy as np


def rate(run):
    """Items that reached the host a second of the window."""
    return run.window["items"] / run.window["seconds"]


def percentile_ms(values, q: float):
    return None if not values else float(np.percentile(values, q)) * 1e3


def mfu(run):
    """The model steps' needed flops over the window's time, as a share of
    the fp32 peak (%)."""
    if run.peak is None:
        return None
    model = run.cfg["model"]
    flops = 0
    for slot, n in enumerate(run.window["slots"]):
        if n:
            c = run.count(model, slot)
            if c is None:
                return None
            flops += int(n) * c[0]
    return 100.0 * flops / run.window["seconds"] / run.peak["fp32_flops_per_s"]


def roofline(run, layer: str):
    """The least time the traced calls of ``layer`` could take (the larger
    of flops over the fp32 peak and bytes over HBM bandwidth) over the
    time its kernels took (%)."""
    tr = run.trace
    if tr is None or run.peak is None or not tr["layer_s"].get(layer):
        return None
    bound = 0.0
    for slot, n in enumerate(tr["slots"]):
        if n:
            c = run.count(layer, slot)
            if c is None:
                return None
            bound += int(n) * max(c[0] / run.peak["fp32_flops_per_s"],
                                  c[1] / run.peak["hbm_bytes_per_s"])
    return 100.0 * bound / tr["layer_s"][layer]


def idle(run):
    """Share of the traced window with no kernel or copy on the device
    (%)."""
    tr = run.trace
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def torch_ops_ms(run):
    """Device ms a call in kernels that are not the port's own."""
    tr = run.trace
    if tr is None or not tr["calls"]:
        return None
    return 1e3 * tr["other_s"] / tr["calls"]
