"""The decode steps' needed flops over the window (``costs/deepseek_v2.py``,
the model that the configuration's ``model`` names) against the bf16
peak (%)."""


def read(run):
    if run.peak is None:
        return None
    flops = 0
    for slot, n in enumerate(run.window["slots"]):
        if n:
            c = run.count(run.cfg["model"], slot)
            if c is None:
                return None
            flops += int(n) * c[0]
    return (100.0 * flops / run.window["seconds"]
            / run.peak["bf16_flops_per_s"])
