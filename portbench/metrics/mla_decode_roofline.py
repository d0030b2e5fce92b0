"""The MLA latent-decode kernel's share of its roofline (%), traced: the
least time of the traced steps' kernel calls (the larger of flops over the
bf16 peak and bytes over HBM bandwidth, ``costs/mla_decode.py``) over the
device time of the kernels ``mla_decode::flash_decode_split_tc`` and
``mla_decode::flash_decode_combine`` in the traced window (the MLA
kernels, told from B6's by their namespace). By name, not by span: the
traced window replays the step's CUDA graph, which opens no span. A
program without those kernels gives no time, and the reader None."""
import re

from portbench import tracing

NAMES = re.compile(r"\bmla_decode::(flash_decode_split_tc|flash_decode_combine)\b")


def kernel_s(events: list):
    """Device seconds of the kernels ``NAMES`` matches that start inside
    the window, or None without a window."""
    win = next((e for e in events if e.get("name") == tracing.WINDOW
                and e.get("cat") == "user_annotation"), None)
    if win is None:
        return None
    lo, hi = win["ts"], win["ts"] + win["dur"]
    return sum(e["dur"] for e in events
               if e.get("cat") == "kernel" and "dur" in e
               and lo <= e["ts"] <= hi and NAMES.search(e["name"])) / 1e6


def install():
    """Wrap ``tracing.reduce`` once so that its figures also hold
    "mla_decode_s" (:func:`kernel_s`)."""
    f = tracing.reduce
    while f is not None:
        if getattr(f, "mla_decode", False):
            return
        f = getattr(f, "base", None) or getattr(f, "inner", None)
    inner = tracing.reduce

    def with_mla(events):
        out = inner(events)
        if out is not None:
            out["mla_decode_s"] = kernel_s(events)
        return out
    with_mla.mla_decode = True
    with_mla.inner = inner
    tracing.reduce = with_mla


install()


def read(run):
    tr = run.trace
    if tr is None or run.peak is None or not tr.get("mla_decode_s"):
        return None
    bound = 0.0
    for slot, n in enumerate(tr["slots"]):
        if n:
            f, b = run.count("mla_decode", slot)
            bound += int(n) * max(f / run.peak["bf16_flops_per_s"],
                                  b / run.peak["hbm_bytes_per_s"])
    return 100.0 * bound / tr["mla_decode_s"]
