"""DeepSeek-V2-Lite [arXiv:2405.04434] decoding, in plain PyTorch: the
published equations in float32 from the stored (bf16) weights and cache,
rounded to the stored dtype exactly where the configuration stores it
(the residual stream between layers, and the latents written to the
cache). Imports nothing of the program.

Multi-head latent attention in its expanded form: each cached latent
row c (kv_lora_rank wide) is expanded per head into a key, c W_kb, and
a value, c W_vb, and the rope key r (qk_rope_head_dim wide, shared by
the heads) is appended to the key; then ordinary causal softmax
attention, scaled by 1/sqrt(qk_nope + qk_rope) times the square of
YaRN's temperature at mscale_all_dim. YaRN rope (the published
rope_scaling). The leading dense layer; then the MoE: softmax router
over n_routed_experts, top num_experts_per_tok without renormalising
the gates (norm_topk_prob false, routed_scaling_factor 1), no pair
dropped, plus the shared experts; final RMSNorm and the head.

``departures`` in the configuration file lists where this follows the
program's layout rather than DeepSeek's code.

With ``low`` (a float8 dtype) it is computed in that precision instead,
as the cell's control: every weight, the residual between layers and
every cached latent rounded through ``low`` (:func:`rounded`)."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

#: the dtype of each configuration's stored weights, cache and residual
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype(cfg: dict) -> torch.dtype:
    return DTYPES[cfg["dtype"]]


def part_seed(seed: int, *path) -> int:
    """A 63-bit seed for one part (names and indices) of a draw."""
    state = np.random.SeedSequence([int(seed)] + [
        int.from_bytes(str(p).encode(), "little") % (1 << 32) if
        isinstance(p, str) else int(p) for p in path]).generate_state(
            1, np.uint64)
    return int(state[0]) >> 1


def _randn(gen, shape, std, out_dtype):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).mul_(std).to(out_dtype)


# ------------------------------------------------------------------ weights

def draw(gen: torch.Generator, cfg: dict) -> dict:
    """The weights, drawn on ``gen``'s device from its seed, in the layout
    of the program's ``transformer.init`` (layers stacked; the router in
    float32, every other weight in the configuration's dtype): dense
    weights N(0, 1/fan_in), the embedding N(0, embed_std²), each norm's
    scale 1 + N(0, norm_std²) (``init``). One layer's float32 draw is
    alive at a time beside the stacks."""
    d, H, V = cfg["hidden_size"], cfg["num_attention_heads"], cfg["vocab_size"]
    kv, nope = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
    rope, vd = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    E, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs = cfg["n_shared_experts"] * f
    n_dense = cfg["first_k_dense_replace"]
    init, dt = cfg["init"], dtype(cfg)
    seed = gen.initial_seed()
    dev = gen.device

    def g(*path):
        return torch.Generator(device=dev).manual_seed(part_seed(seed, *path))

    def dense(gen_, d_in, d_out, out_dtype=dt):
        return _randn(gen_, (d_in, d_out), 1.0 / math.sqrt(d_in), out_dtype)

    def norm(gen_, width):
        return {"scale": (1.0 + _randn(gen_, (width,), init["norm_std"],
                                       torch.float32)).to(dt)}

    def layer(name, i, moe):
        gi = g(name, i)
        p = {"ln1": norm(gi, d), "ln2": norm(gi, d),
             "attn": {"wq": dense(gi, d, H * (nope + rope)),
                      "wkv_a": dense(gi, d, kv + rope),
                      "kv_norm": norm(gi, kv),
                      "wk_b": dense(gi, kv, H * nope),
                      "wv_b": dense(gi, kv, H * vd),
                      "wo": dense(gi, H * vd, d)}}
        if not moe:
            w = cfg["intermediate_size"]
            p["mlp"] = {"w1": dense(gi, d, w), "w2": dense(gi, w, d),
                        "w3": dense(gi, d, w)}
            return p
        p["moe"] = {"router": dense(gi, d, E, torch.float32),
                    "w1": _randn(gi, (E, d, f), 1.0 / math.sqrt(d), dt),
                    "w3": _randn(gi, (E, d, f), 1.0 / math.sqrt(d), dt),
                    "w2": _randn(gi, (E, f, d), 1.0 / math.sqrt(f), dt)}
        p["shared"] = {"w1": dense(gi, d, fs), "w2": dense(gi, fs, d),
                       "w3": dense(gi, d, fs)}
        return p

    def stack(name, n, moe):
        first = layer(name, 0, moe)
        out = _tree(first, lambda t: t.new_empty((n, *t.shape)))
        for i in range(n):
            one = first if i == 0 else layer(name, i, moe)
            _tree2(out, one, lambda o, t: o[i].copy_(t))
            del one
        return out

    return {"embed": {"table": _randn(g("embed"), (V, d), init["embed_std"],
                                      dt)},
            "final_norm": norm(g("final_norm"), d),
            "dense_layers": stack("dense_layers", n_dense, False),
            "layers": stack("layers", cfg["num_hidden_layers"] - n_dense,
                            True),
            "lm_head": {"w": dense(g("lm_head"), d, V)}}


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _tree2(a, b, fn):
    if isinstance(a, dict):
        for k in a:
            _tree2(a[k], b[k], fn)
    else:
        fn(a, b)


def layer_params(w: dict, cfg: dict, i: int) -> dict:
    """Layer ``i``'s weights (views of the stacks)."""
    n_dense = cfg["first_k_dense_replace"]
    stack, j = ((w["dense_layers"], i) if i < n_dense
                else (w["layers"], i - n_dense))
    return _tree(stack, lambda t: t[j])


# ------------------------------------------------------------ the cache

def prompt_rows(seed: int, layer: int, slot: int, rows: int, cfg: dict,
                device) -> torch.Tensor:
    """A prompt's cached latents of one layer: (rows, kv_lora_rank +
    qk_rope_head_dim) N(0, 1), c then r, in the configuration's dtype,
    from their own generator (the same rows whichever part is drawn
    first)."""
    width = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    gen = torch.Generator(device=device).manual_seed(
        part_seed(seed, "prompt", layer, slot))
    return _randn(gen, (rows, width), 1.0, dtype(cfg))


# ----------------------------------------------------------------- pieces

def rounded(t, low, rows: bool = False, amax=None):
    """``t`` in float32 after a round trip through the dtype ``low``,
    scaled by a power of two that puts its largest magnitude (``amax``,
    else taken from ``t``) within ``low``'s range: one scale for a
    weight, one an expert for a (E, ...) stack of experts, one a row for
    activations (``rows``)."""
    t = t.float()
    if amax is None:
        amax = (t.abs().amax(-1, keepdim=True) if rows else
                t.abs().amax((-2, -1), keepdim=True) if t.dim() == 3 else
                t.abs().amax())
    scale = torch.exp2(torch.floor(torch.log2(
        torch.finfo(low).max / amax.float().clamp_min(1e-30))))
    return (t * scale).to(low).float() / scale


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def rope_inv_freq(cfg: dict, device) -> torch.Tensor:
    """YaRN's inverse frequencies of the qk_rope_head_dim rotated dims:
    theta^(-2i/dim) where a dim turns more than beta_fast times over
    original_max_position_embeddings, those over factor where it turns
    fewer than beta_slow times, and a linear blend between."""
    dim, theta = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    extra = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim)
    rs = cfg.get("rope_scaling")
    if not rs:
        return extra

    def corr(turns):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (turns * 2 * math.pi))) / (2 * math.log(theta))
    lo = max(math.floor(corr(rs["beta_fast"])), 0)
    hi = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo if hi > lo else 1e-3)).clamp(0, 1)
    keep = 1.0 - ramp                    # 1: the dim keeps its frequency
    return extra / rs["factor"] * (1.0 - keep) + extra * keep


def rope(x, pos, cfg: dict):
    """Rotate x (N, ..., dim) at positions pos (N,): the halves (x1, x2)
    turned by the position's angles; cos and sin times YaRN's mscale over
    mscale_all_dim."""
    ang = pos.float()[:, None] * rope_inv_freq(cfg, x.device)      # (N, dim/2)
    rs = cfg.get("rope_scaling")
    m = (yarn_mscale(rs["factor"], rs["mscale"])
         / yarn_mscale(rs["factor"], rs["mscale_all_dim"])) if rs else 1.0
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (ang.shape[1],)
    cos, sin = (torch.cos(ang) * m).view(shape), (torch.sin(ang) * m).view(shape)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def softmax_scale(cfg: dict) -> float:
    s = 1.0 / math.sqrt(cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"])
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        s *= yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return s


def glu(p, x):
    """SiLU-gated FFN in float32: (silu(x w1) * x w3) w2."""
    return (F.silu(x @ p["w1"].float()) * (x @ p["w3"].float())) @ p["w2"].float()


def attention(p, h, pos, seg, ctx, cfg, block: int = 128):
    """Expanded MLA for the tokens of each sequence against its context.
    h (N, d) the normed inputs at positions pos; ``seg`` lists each
    sequence's token rows (lo, hi) and its context's prefix length P;
    ``ctx(s)`` gives the context's latents (P + hi - lo, kv + rope),
    float32, the prefix then the tokens' own. → (N, d)."""
    H, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rope_d, vd, kv = (cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                      cfg["kv_lora_rank"])
    q = (h @ p["wq"].float()).view(-1, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], rope(q[..., nope:], pos, cfg)
    wkb = p["wk_b"].float().view(kv, H, nope)
    wvb = p["wv_b"].float().view(kv, H, vd)
    scale = softmax_scale(cfg)
    out = h.new_empty((h.shape[0], H * vd))
    for s, (lo, hi, P) in enumerate(seg):
        lat = ctx(s)
        k_nope = torch.einsum("jl,lhd->jhd", lat[:, :kv], wkb)
        v = torch.einsum("jl,lhd->jhd", lat[:, :kv], wvb)
        k_rope = lat[:, kv:]
        keys = torch.arange(lat.shape[0], device=h.device)
        for a in range(lo, hi, block):
            b = min(a + block, hi)
            sc = (torch.einsum("qhd,jhd->qhj", q_nope[a:b], k_nope)
                  + torch.einsum("qhd,jd->qhj", q_rope[a:b], k_rope)) * scale
            own = P + torch.arange(a - lo, b - lo, device=h.device)
            sc = sc.masked_fill((keys[None, :] > own[:, None])[:, None],
                                float("-inf"))
            o = torch.einsum("qhj,jhd->qhd", torch.softmax(sc, -1), v)
            out[a:b] = o.reshape(b - a, H * vd)
    return out @ p["wo"].float()


def moe(p, x, cfg, chosen=None):
    """Routed experts on x (N, d), float32: the softmax router's top
    num_experts_per_tok, gates the probabilities themselves; ``chosen``
    maps token rows to the experts they take instead (N_c, k) → (out,
    the router's probabilities (N, E))."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(x @ p["router"].float(), -1)
    ids = torch.topk(probs, k, -1).indices
    if chosen is not None:
        rows, ex = chosen
        ids = ids.clone()
        ids[rows] = ex.to(ids.device)
    gates = probs.gather(1, ids)
    out = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel():
            ep = {n: p[n][e] for n in ("w1", "w2", "w3")}
            out.index_add_(0, tok, glu(ep, x[tok]) * gates[tok, slot, None])
    return out, probs


# ----------------------------------------------------------------- decode

@torch.no_grad()
def decode_logits(w: dict, cfg: dict, prefix, answers, routes=None,
                  low=None):
    """The next-token logits of each sequence after its answer so far.

    ``prefix``: per sequence its prompt's length P and ``rows(layer)``,
    the prompt's cached latents of a layer (P, kv + rope), as a list of
    (P, rows) pairs; ``answers``: per sequence the (n,) token ids fed so
    far, at positions P .. P + n - 1 (each sequence's last is the one
    whose logits are returned); ``routes``: one (B, k) of expert ids a
    MoE layer, the experts each sequence's last token takes there in the
    program's step (the program's choices, so that a near-tie the two
    sides break apart does not widen the comparison; route_slack checks
    them); ``low``: a dtype below the configured one to compute in
    (every weight, the residual and every cached latent rounded through
    it by :func:`rounded`; a control).

    → (logits (B, V) float32, the router's probabilities of each last
    token (MoE layers, B, E))."""
    dev = w["lm_head"]["w"].device
    dt, eps = dtype(cfg), cfg["rms_norm_eps"]
    kv = cfg["kv_lora_rank"]
    ids = torch.cat([a.to(dev).long() for a in answers])
    n = [int(a.numel()) for a in answers]
    ends = np.cumsum(n).tolist()
    seg = [(e - k, e, P) for e, k, (P, _) in zip(ends, n, prefix)]
    pos = torch.cat([P + torch.arange(k, device=dev)
                     for k, (P, _) in zip(n, prefix)])
    last = torch.tensor([e - 1 for e in ends], device=dev)

    def stored(t):
        return rounded(t, low, rows=True) if low else t.to(dt).float()

    def weights(p):
        return _tree(p, lambda t: rounded(t, low)) if low else p

    table = w["embed"]["table"]
    x = (rounded(table[ids], low, amax=table.abs().amax()) if low
         else table[ids].float())
    probs_out = []
    n_layers = cfg["num_hidden_layers"]
    for i in range(n_layers):
        p = weights(layer_params(w, cfg, i))
        h = rmsnorm(x, p["ln1"]["scale"], eps)
        a = h @ p["attn"]["wkv_a"].float()
        lat = torch.cat([rmsnorm(a[:, :kv], p["attn"]["kv_norm"]["scale"], eps),
                         rope(a[:, kv:], pos, cfg)], -1)
        lat = stored(lat)

        def ctx(s, i=i, lat=lat):
            P, rows = prefix[s]
            lo, hi, _ = seg[s]
            own = lat[lo:hi]
            if P == 0:
                return own
            return torch.cat([stored(rows(i)), own])
        x = x + attention(p["attn"], h, pos, seg, ctx, cfg)
        h = rmsnorm(x, p["ln2"]["scale"], eps)
        if "mlp" in p:
            x = x + glu(p["mlp"], h)
        else:
            j = len(probs_out)
            chosen = None if routes is None else (last, routes[j])
            out, probs = moe(p["moe"], h, cfg, chosen)
            probs_out.append(probs[last])
            x = x + out + glu(p["shared"], h)
        x = stored(x)
        del p
    top = weights({"final_norm": w["final_norm"], "lm_head": w["lm_head"]})
    h = rmsnorm(x[last], top["final_norm"]["scale"], eps)
    logits = h @ top["lm_head"]["w"].float()
    return logits, (torch.stack(probs_out) if probs_out else
                    logits.new_zeros((0, len(answers), 0)))
