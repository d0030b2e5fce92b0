"""The layer spans of the port's DIN and DIEN model step (``obs.span``):
traced on the CPU, each layer's span opens once a call, nested under
``model.step`` in the order the step runs its layers, each kernel's span
inside its layer's; the GRU's steps open none of their own; tracing
leaves the scores bitwise as they were; with the profiler off a span is
the shared null context and builds no ``record_function``."""
import json

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.models.recsys import dien, din

MODELS = {"din": din, "dien": dien}
#: the layers of each model's step, in the order it runs them
LAYERS = {
    "din": ["model.lookup", "model.hist_mask", "model.attention",
            "model.score_mlp"],
    "dien": ["model.lookup", "model.hist_mask", "model.gru",
             "model.attention", "model.augru", "model.score_mlp"]}
#: each kernel's span and the layer span it lies in
KERNELS = {
    "din": {"kernel.embedding_bag": "model.lookup",
            "kernel.din_attention": "model.attention"},
    "dien": {"kernel.embedding_bag": "model.lookup",
             "kernel.augru": "model.augru"}}
CALLS = 2


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return torch.as_tensor(a, dtype=torch.int64 if a.dtype.kind in "iu"
                           else torch.float32)


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """(name, module, cfg, params, batch) at the reduced config."""
    arch = registry.get(request.param)
    cfg = arch.reduced(arch.config)
    mod = MODELS[request.param]
    params = mod.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = _torch(synthetic.recsys_batch(np.random.default_rng(0), cfg, 6))
    return request.param, mod, cfg, params, batch


@pytest.fixture(scope="module")
def traced(model, tmp_path_factory):
    """The scores of ``CALLS`` calls under the profiler and the spans of
    the exported Chrome trace, (name, start, end) by start."""
    _, mod, cfg, params, batch = model
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        scores = [mod.serve_scores(params, batch, cfg) for _ in range(CALLS)]
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith(("model.", "kernel.")))
    return scores, [(n, s, e) for s, e, n in spans]


def _inside(spans, name, outer):
    """Each span ``name`` lies inside one span ``outer``."""
    outs = [(s, e) for n, s, e in spans if n == outer]
    return all(any(os <= s and e <= oe for os, oe in outs)
               for n, s, e in spans if n == name)


def test_each_layer_opens_once_a_call_under_the_step_in_order(model, traced):
    name = model[0]
    _, spans = traced
    steps = [(s, e) for n, s, e in spans if n == "model.step"]
    assert len(steps) == CALLS
    for s0, e0 in steps:
        layers = [n for n, s, e in spans
                  if n.startswith("model.") and n != "model.step"
                  and s0 <= s and e <= e0]
        assert layers == LAYERS[name]
    assert {n for n, _, _ in spans if n.startswith("model.")} == \
        {"model.step", *LAYERS[name]}


def test_kernel_spans_lie_inside_their_layers(model, traced):
    name = model[0]
    _, spans = traced
    for kernel, layer in KERNELS[name].items():
        assert sum(n == kernel for n, _, _ in spans) >= CALLS, kernel
        assert _inside(spans, kernel, layer), (kernel, layer)


def test_no_span_opens_per_gru_step(model, traced):
    """``model.gru`` covers all of the GRU's steps once a call; the spans a
    call are as many as its layers and kernels, whatever the history's
    length."""
    name, _, cfg, _, _ = model
    _, spans = traced
    assert sum(n == "model.gru" for n, _, _ in spans) == \
        (CALLS if name == "dien" else 0)
    assert cfg.seq_len > 1
    assert len(spans) == CALLS * (1 + len(LAYERS[name]) + len(KERNELS[name]))


def test_scores_are_bitwise_the_same_traced_or_not(model, traced):
    _, mod, cfg, params, batch = model
    scores, _ = traced
    plain = mod.serve_scores(params, batch, cfg)
    for s in scores:
        assert torch.equal(s, plain)


def test_a_span_off_the_profiler_is_the_shared_null_context(model,
                                                            monkeypatch):
    """Off the profiler a span is one check: the same null context every
    time, and a whole model step builds no ``record_function``."""
    _, mod, cfg, params, batch = model

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built off the "
                             "profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    a, b = obs.span("model.step"), obs.span("kernel.augru")
    assert a is b
    with a:
        with b:
            pass
    assert a.__enter__() is None
    assert mod.serve_scores(params, batch, cfg).shape == (6,)
