"""Device ms a decode step of the kernels launched inside the program's
``model.moe`` spans: routing, dispatch, the routed experts and the
combine of every MoE layer (traced; the step launched eagerly, the
kernels its graph replays, ``Loop.span_ms``)."""


def read(run):
    if run.trace is None or not hasattr(run.loop, "span_ms"):
        return None
    return (run.loop.span_ms() or {}).get("model.moe")
