"""The program's decode entry (``serve/graphs.py``) without a card: the
eager step function against ``decode_step`` itself, with and without the
routes recorded; ``DecodeGraph`` (CUDA's graph and stream objects stood
in for) warming up and capturing on the first call's inputs and copying
each call's inputs into its static buffers before the replay; and
``serve_lm``'s ``decode_graph`` option, which leaves the CPU eager."""
import argparse
import contextlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.loops.decode import lm_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import graphs  # noqa: E402

REF = harness.load_module(ROOT / "portbench" / "reference"
                          / "deepseek-v2-lite.py")
CFG = {**json.loads((ROOT / "portbench" / "configs"
                     / "deepseek-v2-lite.json").read_text()),
       "hidden_size": 32, "num_hidden_layers": 3, "num_attention_heads": 2,
       "kv_lora_rank": 16, "qk_nope_head_dim": 8, "qk_rope_head_dim": 8,
       "v_head_dim": 8, "intermediate_size": 48, "moe_intermediate_size": 16,
       "n_routed_experts": 4, "num_experts_per_tok": 2, "n_shared_experts": 1,
       "vocab_size": 64, "dtype": "float32"}


def setup():
    lm = lm_config(CFG)
    w = REF.draw(torch.Generator().manual_seed(1), CFG)
    g = torch.Generator().manual_seed(2)
    cache = transformer.KVCache.zeros(lm, 2, 8, "cpu")
    cache.a.copy_(torch.randn(cache.a.shape, generator=g))
    cache.b.copy_(torch.randn(cache.b.shape, generator=g))
    return lm, w, cache


def test_the_eager_step_is_decode_step_with_its_routes():
    """Two steps of the eager step function at per-row lengths: the
    logits and cache rows of ``decode_step`` on a copy of the cache, and
    one ``moe.Routed`` a MoE layer (2 of 3 layers) only where asked."""
    lm, w, cache = setup()
    twin = cache._replace(a=cache.a.clone(), b=cache.b.clone())
    toks = [torch.tensor([[3], [9]]), torch.tensor([[5], [1]])]
    lens = [torch.tensor([2, 5], dtype=torch.int32),
            torch.tensor([3, 6], dtype=torch.int32)]
    step = graphs.decoder(w, cache, toks[0], lm, graph=False,
                          record_routes=True)
    for t, n in zip(toks, lens):
        got, routes = step(t, n)
        want, _ = transformer.decode_step(w, twin._replace(length=n), t, lm)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert len(routes) == 2
        assert [tuple(r.ids.shape) for r in routes] == [(2, 2), (2, 2)]
    torch.testing.assert_close(cache.a, twin.a, rtol=0, atol=0)
    torch.testing.assert_close(cache.b, twin.b, rtol=0, atol=0)
    quiet = graphs.decoder(w, cache, toks[0], lm, graph=False)
    assert quiet(toks[0], lens[0])[1] == []


class FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_the_graph_captures_on_the_first_inputs_and_copies_each_call(
        monkeypatch):
    """Warm-up and capture run ``decode_step`` on the tokens and lengths
    handed at capture (their cache rows are the first call's); a call
    copies its tokens and lengths into the static buffers, replays once
    and returns the captured outputs, without a step of its own."""
    lm, w, cache = setup()
    seen = []
    step = transformer.decode_step

    def counted(params, c, tokens, cfg, **kw):
        seen.append((tokens.clone(), c.length.clone()))
        return step(params, c, tokens, cfg, **kw)
    monkeypatch.setattr(transformer, "decode_step", counted)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda: SimpleNamespace(wait_stream=lambda s: None))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, stream=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    first = torch.tensor([[3], [9]])
    lens = torch.tensor([2, 5], dtype=torch.int32)
    dg = graphs.decoder(w, cache._replace(length=lens), first, lm,
                        graph=True, record_routes=True)
    assert isinstance(dg, graphs.DecodeGraph)
    assert len(seen) == 3                       # 2 warm-up calls, 1 capture
    for t, n in seen:
        assert torch.equal(t, first) and torch.equal(n, lens)
    logits, routes = dg.out
    assert logits.shape == (2, 64) and len(routes) == 2
    nxt, nlens = torch.tensor([[7], [8]]), lens + 1
    out = dg(nxt, nlens)
    assert out is dg.out and dg.graph.replays == 1 and len(seen) == 3
    assert torch.equal(dg.tokens, nxt) and torch.equal(dg.length, nlens)
    assert torch.equal(lens, torch.tensor([2, 5], dtype=torch.int32))


def test_serve_lm_decode_graph_stays_eager_on_the_cpu():
    """``decode_graph`` asks for a CUDA graph; on the CPU the service runs
    its eager steps and its figures do not change."""
    args = dict(arch="smollm-135m", requests=6, reduced=True)
    plain = serve.serve_lm(argparse.Namespace(**args), device="cpu")
    graphed = serve.serve_lm(argparse.Namespace(**args, decode_graph=True),
                             device="cpu")
    for k in ("steps", "tokens", "completed", "utilization"):
        assert graphed[k] == plain[k]
