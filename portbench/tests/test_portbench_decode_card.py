"""On the card (skipped without one): the MLA latent-decode kernel against
its plain float32 version, at short and odd lengths (a row of length 0,
rows shorter than a tile and than a block's share, tile edges) and at the
decode cell's shape (32 rows of 16,384-31,264 valid of 32,768), and its
rows counter reading every valid row once; the program's decode entry as
one CUDA graph against its eager steps, and ``serve_lm`` with it."""
import pytest
import torch

SCALE = 0.1147


def inputs(card, B, S, lens, seed=1):
    g = torch.Generator(device=card).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=card).to(torch.bfloat16)
    return (draw(B, 16, 512), draw(B, 16, 64), draw(B, S, 512),
            draw(B, S, 64), torch.tensor(lens, dtype=torch.int32,
                                         device=card), SCALE)


CASES = [(4, 256, [1, 63, 64, 65]), (4, 256, [0, 1, 200, 256]),
         (1, 64, [1]), (5, 300, [300, 0, 0, 17, 129]),
         (40, 512, list(range(1, 513, 13))[:40]), (2, 70000, [69999, 1])]


@pytest.mark.card
@pytest.mark.parametrize("B,S,lens", CASES + [
    (32, 32768, [16384 + 480 * k for k in range(32)])],
    ids=lambda v: str(v)[:24])
def test_mla_decode_matches_its_plain_version(card, B, S, lens):
    """Within 1% of the output's largest value: the kernel rounds p and
    its output to bf16, the plain version neither. A row of length 0
    gives 0."""
    from repro_torch.kernels.mla_decode import (mla_decode, mla_decode_ref,
                                                rows_read)
    args = inputs(card, B, S, lens)
    got = mla_decode(*args).float()
    want = mla_decode_ref(*args).float()
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= 1e-2 * float(want.abs().max()), err
    for b, n in enumerate(lens):
        if n == 0:
            assert bool((got[b] == 0).all())
    assert rows_read(*args) == sum(min(max(n, 0), S) for n in lens)
    torch.cuda.empty_cache()


#: DeepSeek-V2-Lite's attention geometry (the kernel's: 16 heads over
#: 512 + 64 latents), every other width cut
GRAPH_CFG = {"hidden_size": 256, "num_hidden_layers": 3,
             "num_attention_heads": 16, "kv_lora_rank": 512,
             "qk_nope_head_dim": 16, "qk_rope_head_dim": 64,
             "v_head_dim": 16, "intermediate_size": 128,
             "moe_intermediate_size": 32, "n_routed_experts": 8,
             "num_experts_per_tok": 3, "n_shared_experts": 1,
             "vocab_size": 512, "dtype": "bfloat16"}


@pytest.mark.card
def test_the_decode_graph_replays_the_eager_steps(card):
    """The program's decode entry as one CUDA graph against the eager
    ``decode_step`` on a twin of the cache, over four steps at per-row
    lengths (a row starting empty): the same logits, routes and cache
    rows, bit for bit (the same kernels on the same inputs)."""
    import json
    from pathlib import Path

    from portbench import harness
    from portbench.loops.decode import lm_config
    from repro_torch.models import transformer
    from repro_torch.serve import graphs
    root = Path(__file__).resolve().parents[2]
    cfg = {**json.loads((root / "portbench" / "configs"
                         / "deepseek-v2-lite.json").read_text()),
           **GRAPH_CFG}
    ref = harness.load_module(harness.find("reference", "deepseek-v2-lite",
                                           ".py"))
    lm = lm_config(cfg)
    w = ref.draw(torch.Generator(device=card).manual_seed(4), cfg)
    g = torch.Generator(device=card).manual_seed(5)
    cache = transformer.KVCache.zeros(lm, 4, 300, card)
    cache.a.normal_(generator=g)
    cache.b.normal_(generator=g)
    twin = cache._replace(a=cache.a.clone(), b=cache.b.clone())
    lens = torch.tensor([0, 63, 64, 250], dtype=torch.int32, device=card)
    toks = torch.randint(0, 512, (4, 4, 1), generator=g, device=card)
    with torch.no_grad():
        step = graphs.decoder(w, cache._replace(length=lens), toks[0], lm,
                              graph=True, record_routes=True)
        for n in range(4):
            got, routes = step(toks[n], lens + n)
            want, want_routes = graphs.decoder(
                w, twin, toks[n], lm, graph=False,
                record_routes=True)(toks[n], lens + n)
            assert torch.equal(got, want), n
            assert all(torch.equal(a.ids, b.ids)
                       for a, b in zip(routes, want_routes))
    assert torch.equal(cache.a, twin.a) and torch.equal(cache.b, twin.b)


@pytest.mark.card
def test_serve_lm_with_a_decode_graph(card):
    """``serve_lm`` replaying each step as a CUDA graph serves what the
    eager loop serves: the same steps, tokens and completed requests."""
    import argparse

    from repro_torch.launch import serve
    args = dict(arch="smollm-135m", requests=6, reduced=True)
    eager = serve.serve_lm(argparse.Namespace(**args), device=card)
    graphed = serve.serve_lm(argparse.Namespace(**args, decode_graph=True),
                             device=card)
    for k in ("steps", "tokens", "completed", "utilization"):
        assert graphed[k] == eager[k], k
