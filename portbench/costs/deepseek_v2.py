"""DeepSeek-V2's whole decode step for B new tokens: every weight a token
uses (2 flops a multiply-add) in the absorbed form — the query and latent
projections, q_nope through wk_b, o_lat through wv_b, wo; the dense FFN;
the router, num_experts_per_tok routed experts and the shared experts;
the head — plus the attention over each token's valid latent rows
(``costs/mla_decode.py``). Norms, rope, softmax and the gates' products
are left out. bytes: the latent rows once and the weights outside the
routed experts once (which routed experts a step touches depends on the
routing): a lower bound."""
from __future__ import annotations

from portbench.costs import mla_decode


def linear_macs(cfg: dict) -> tuple[int, int]:
    """(multiply-adds a token, weights outside the routed experts)."""
    d, H, V = cfg["hidden_size"], cfg["num_attention_heads"], cfg["vocab_size"]
    kv, nope, rope, vd = (cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
                          cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    E, k, f = (cfg["n_routed_experts"], cfg["num_experts_per_tok"],
               cfg["moe_intermediate_size"])
    attn = (d * H * (nope + rope) + d * (kv + rope) + H * nope * kv
            + H * kv * vd + H * vd * d)
    attn_w = d * H * (nope + rope) + d * (kv + rope) + kv * H * (nope + vd) \
        + H * vd * d
    n_dense = cfg["first_k_dense_replace"]
    n_moe = cfg["num_hidden_layers"] - n_dense
    dense = 3 * d * cfg["intermediate_size"]
    shared = 3 * d * cfg["n_shared_experts"] * f
    moe = d * E + k * 3 * d * f + shared
    macs = (cfg["num_hidden_layers"] * attn + n_dense * dense + n_moe * moe
            + d * V)
    weights = (cfg["num_hidden_layers"] * attn_w + n_dense * dense
               + n_moe * (d * E + shared) + d * V)
    return macs, weights


def decode(cfg: dict, batch: dict, weights: dict) -> tuple[int, int]:
    macs, w = linear_macs(cfg)
    B = batch["lengths"].numel()
    f_att, b_att = mla_decode.decode(cfg, batch, weights)
    return 2 * macs * B + f_att, 2 * w + b_att
