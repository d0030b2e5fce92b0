"""The MLA latent-decode kernel over one decode step: every layer's
absorbed attention of the B new tokens against their valid latent rows
(each row's length before the step's write, plus the row it writes).
flops: a row's scores (heads x (kv_lora + rope) multiply-adds) and its
share of p·c (heads x kv_lora); bytes: each valid row's latents once, q
and o once, in the configured dtype (bf16: 2 bytes)."""
from __future__ import annotations


def rows(batch: dict) -> int:
    """Valid latent rows a layer attends in the step: sum(length + 1)."""
    lens = batch["lengths"]
    return int(lens.sum()) + int(lens.numel())


def decode(cfg: dict, batch: dict, weights: dict) -> tuple[int, int]:
    H, kv, rope = (cfg["num_attention_heads"], cfg["kv_lora_rank"],
                   cfg["qk_rope_head_dim"])
    L, B, item = cfg["num_hidden_layers"], batch["lengths"].numel(), 2
    n = rows(batch)
    flops = L * n * H * (2 * kv + rope) * 2
    nbytes = L * item * (n * (kv + rope) + B * H * (2 * kv + rope))
    return flops, nbytes
