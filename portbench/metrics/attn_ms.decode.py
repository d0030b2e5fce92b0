"""Device ms a decode step of the kernels launched inside the program's
``model.attention`` spans: every layer's MLA projections, cache writes,
the latent-decode kernel, wv_b and wo (traced; the step launched
eagerly, the kernels its graph replays, ``Loop.span_ms``)."""


def read(run):
    if run.trace is None or not hasattr(run.loop, "span_ms"):
        return None
    return (run.loop.span_ms() or {}).get("model.attention")
