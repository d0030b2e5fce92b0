"""Small sizes of the decode cell for the CPU tests: the published widths
cut (the hidden size, heads, latents, experts and vocabulary), the
traffic's shape kept (prompt and answer multisets, restarts, a ring a
multiple of every answer length)."""

CELL = "deepseek-v2-lite.decode"
CONFIG = {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
          "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
          "v_head_dim": 16, "intermediate_size": 96,
          "moe_intermediate_size": 32, "n_routed_experts": 8,
          "num_experts_per_tok": 3, "n_shared_experts": 1, "vocab_size": 256,
          "dtype": "float32"}
TRAFFIC = {"slots": 4, "prompt_base": 20, "prompt_step": 3, "answers": [2, 4],
           "ring": 8, "cache_rows": 40, "warm_calls": 8}


def overrides(dtype: str = "float32") -> dict:
    return {"config": dict(CONFIG, dtype=dtype), "traffic": dict(TRAFFIC)}
