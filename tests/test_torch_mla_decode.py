"""DeepSeek-V2-Lite's decode path in the port at a small size on the CPU,
held to the benchmark's plain reference (``portbench/reference/
deepseek-v2-lite.py``, the published equations in plain PyTorch) on
seeded random weights: decoding a ragged batch whose rows restart, prefill
then decode against the reference's full forward, YaRN at the published
values, gates without renormalisation, dropless routing under forced skew,
and the 0-d cache length of every other caller."""
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.loops.decode import lm_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import attention, moe, transformer  # noqa: E402
from repro_torch.models.layers import apply_rope, rope_freqs  # noqa: E402

REF = harness.load_module(ROOT / "portbench" / "reference"
                          / "deepseek-v2-lite.py")
PUBLISHED = json.loads((ROOT / "portbench" / "configs"
                        / "deepseek-v2-lite.json").read_text())
#: the published widths cut for the CPU; everything else as published
SMALL = {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
         "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
         "v_head_dim": 16, "intermediate_size": 96,
         "moe_intermediate_size": 32, "n_routed_experts": 8,
         "num_experts_per_tok": 3, "n_shared_experts": 1, "vocab_size": 200,
         "dtype": "float32"}
#: float32 program against float32 reference: only the order of sums
TOL = 2e-4


def small_cfg(**over) -> dict:
    return {**PUBLISHED, **SMALL, **over}


def weights(cfg, seed=5):
    return REF.draw(torch.Generator().manual_seed(seed), cfg)


def close(got, want, tol=TOL):
    scale = want.abs().max().clamp_min(1.0)
    assert float((got - want).abs().max()) <= tol * float(scale)


def test_ragged_decode_with_restarts_matches_the_reference():
    """Four rows at prompt lengths 5-23 decode 9 steps with per-row
    lengths; two rows restart from their prompt midway and overwrite
    their answer rows. The last step's logits and router probabilities
    equal the reference's over each row's answer since its restart."""
    cfg = small_cfg()
    lm, w = lm_config(cfg), weights(cfg)
    B, S, L = 4, 40, cfg["num_hidden_layers"]
    kv = cfg["kv_lora_rank"]
    prompts = [5, 23, 11, 17]
    cache = transformer.KVCache.zeros(lm, B, S, "cpu")
    for layer in range(L):
        for s, P in enumerate(prompts):
            rows = REF.prompt_rows(9, layer, s, P, cfg, "cpu")
            cache.a[layer, s, :P] = rows[:, :kv]
            cache.b[layer, s, :P] = rows[:, kv:]
    # answer position of each row at each step; rows 1 and 3 restart
    pos = np.array([[t, t, t, t] for t in range(9)])
    pos[5:, 1] = np.arange(4)
    pos[3:, 3] = np.arange(6)
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg["vocab_size"], (9, B, 1), generator=g)
    for t in range(9):
        length = torch.as_tensor(np.array(prompts) + pos[t], dtype=torch.int32)
        with moe.recording() as routes:
            logits, out = transformer.decode_step(
                w, cache._replace(length=length), toks[t], lm)
        assert torch.equal(out.length, length + 1)
    answers = [toks[9 - 1 - pos[-1, s]:, s, 0] for s in range(B)]
    want, probs = REF.decode_logits(
        w, cfg, [(P, lambda layer, s=s, P=P: REF.prompt_rows(
            9, layer, s, P, cfg, "cpu")) for s, P in enumerate(prompts)],
        answers, [r.ids for r in routes])
    close(logits, want)
    own, _ = REF.decode_logits(
        w, cfg, [(P, lambda layer, s=s, P=P: REF.prompt_rows(
            9, layer, s, P, cfg, "cpu")) for s, P in enumerate(prompts)],
        answers)
    close(logits, own)           # the same experts without the hint
    assert all(r.dropped() == 0 for r in routes)
    assert probs.shape == (L - 1, B, cfg["n_routed_experts"])


@pytest.mark.parametrize("seq", [12, 20])
def test_prefill_then_decode_equals_the_full_forward(seq):
    """Prefill 8 tokens into the cache, then decode the rest teacher
    forced: every step's logits are the reference's full forward over the
    tokens so far (no prompt cache), with the published YaRN scaling and
    un-renormalised, dropless routing."""
    cfg = small_cfg()
    lm, w = lm_config(cfg), weights(cfg, seed=seq)
    B, n0 = 3, 8
    toks = torch.randint(0, cfg["vocab_size"], (B, seq),
                         generator=torch.Generator().manual_seed(seq))
    logits = transformer.teacher_forced(w, toks, lm, 32, n0)[0]
    for i, t in enumerate(range(n0, seq + 1)):
        want, _ = REF.decode_logits(w, cfg, [(0, None)] * B,
                                    [toks[b, :t] for b in range(B)])
        close(logits[i], want)


def test_yarn_at_the_published_values():
    """The rope frequencies, the cos/sin scale and MLA's softmax scale at
    DeepSeek-V2-Lite's rope_scaling, against YaRN's formulas written out
    here: correction dims 10 and 23 of 64 at 4,096 original positions,
    mscale = mscale_all_dim = 0.707 (cos and sin unscaled), and the
    softmax scale times (0.1 x 0.707 x ln 40 + 1)^2."""
    lm = lm_config(PUBLISHED)
    rs, dim, base = lm.rope_scaling, 64, 1e4

    def corr(turns):
        return dim * math.log(4096 / (turns * 2 * math.pi)) / (2 * math.log(base))
    lo, hi = math.floor(corr(32)), math.ceil(corr(1))
    assert (lo, hi) == (10, 23)
    i = np.arange(dim // 2)
    extra = 1.0 / base ** (2 * i / dim)
    ramp = np.clip((i - lo) / (hi - lo), 0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    got = rope_freqs(dim, base, scaling=rs).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert rope_freqs(dim, base).double().numpy() == pytest.approx(extra)
    x = torch.randn(2, 5, 3, dim, generator=torch.Generator().manual_seed(0))
    pos = torch.tensor([[0, 1, 4095, 4097, 30000]] * 2)
    turned = apply_rope(x, pos, base, rs)
    torch.testing.assert_close(turned.norm(dim=-1), x.norm(dim=-1))
    m = 0.1 * 0.707 * math.log(40) + 1
    assert attention.mla_scale(lm) == pytest.approx(m * m / math.sqrt(192))
    ang = pos[..., None].double() * torch.as_tensor(want)
    x1, x2 = x.double().chunk(2, -1)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    torch.testing.assert_close(
        turned.double(), torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                                   -1), atol=1e-3, rtol=1e-4)


def test_gates_without_renormalisation():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(10, 16, generator=g)
    router = torch.randn(16, 8, generator=g)
    probs = torch.softmax(x @ router, -1)
    raw, ids, _ = moe._route(x, router, 3, norm=False)
    torch.testing.assert_close(raw, probs.gather(1, ids))
    assert float(raw.sum(-1).max()) < 1
    normed, ids2, _ = moe._route(x, router, 3)
    assert torch.equal(ids, ids2)
    torch.testing.assert_close(normed.sum(-1), torch.ones(10))


@pytest.mark.parametrize("factor", [None, 1.25])
def test_no_pair_dropped_under_forced_skew(factor):
    """Every one of 24 tokens routes to expert 0 first. Dropless serving
    (capacity_factor None) keeps all 48 pairs, so each token's output is
    its gated experts' sum; at capacity factor 1.25 an expert keeps 8
    pairs and the counter reads every pair past that (16 of expert 0's
    at least)."""
    d, E, f = 16, 8, 12
    cfg = MoEConfig(n_routed=E, top_k=2, d_ff_expert=f, n_shared=0,
                    capacity_factor=factor, norm_topk_prob=False)
    p = moe.moe_expert_init(torch.Generator().manual_seed(2), d, cfg,
                            torch.float32, "cpu")
    p["router"] = torch.zeros(d, E)
    p["router"][:, 0] = 4.0
    p["router"][:, 1:] = torch.randn(d, E - 1,
                                     generator=torch.Generator().manual_seed(4))
    x = torch.rand(24, d, generator=torch.Generator().manual_seed(3)) + 0.5
    with moe.recording() as rec:
        out, _ = moe.moe_apply(p, x, cfg)
    (routed,) = rec
    ids, n_dropped = routed.ids, routed.dropped()
    assert bool((ids[:, 0] == 0).all())
    load = torch.bincount(ids.reshape(-1), minlength=E)
    cap = moe._capacity(24, cfg)
    assert cap == (24 if factor is None else 8)
    assert int(n_dropped) == int((load - cap).clamp_min(0).sum())
    assert (int(n_dropped) == 0) == (factor is None)
    if factor is None:
        probs = torch.softmax(x @ p["router"], -1)
        want = torch.zeros_like(x)
        for j in range(2):
            e = ids[:, j]
            h = torch.nn.functional.silu(torch.einsum("td,tdf->tf", x, p["w1"][e]))
            h = h * torch.einsum("td,tdf->tf", x, p["w3"][e])
            want += torch.einsum("tf,tfd->td", h, p["w2"][e]) \
                * probs.gather(1, ids)[:, j, None]
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


def test_a_scalar_cache_length_is_unchanged():
    """A 0-d length (every caller but the per-row one) writes every row at
    one index and returns a 0-d length; it gives the same logits and the
    same cache as a (B,) length whose rows are all equal."""
    cfg = small_cfg()
    lm, w = lm_config(cfg), weights(cfg)
    B, S = 3, 16
    toks = torch.randint(0, cfg["vocab_size"], (B, 1),
                         generator=torch.Generator().manual_seed(8))
    g = torch.Generator().manual_seed(9)
    a = torch.randn(cfg["num_hidden_layers"], B, S, cfg["kv_lora_rank"],
                    generator=g)
    b = torch.randn(cfg["num_hidden_layers"], B, S, cfg["qk_rope_head_dim"],
                    generator=g)
    one = transformer.KVCache(a.clone(), b.clone(),
                              torch.tensor(6, dtype=torch.int32))
    rows = transformer.KVCache(a.clone(), b.clone(),
                               torch.full((B,), 6, dtype=torch.int32))
    l1, c1 = transformer.decode_step(w, one, toks, lm)
    l2, c2 = transformer.decode_step(w, rows, toks, lm)
    assert c1.length.dim() == 0 and int(c1.length) == 7
    torch.testing.assert_close(l1, l2)
    assert torch.equal(c1.a, c2.a) and torch.equal(c1.b, c2.b)
    assert not torch.equal(c1.a, a)            # row 6 written in place
    assert torch.equal(c1.a[:, :, 7:], a[:, :, 7:])
