"""The five assigned LM-family architectures (exact public configs)."""
from repro_torch.configs.base import LMConfig, MLAConfig, MoEConfig

# [hf:Qwen/Qwen3-8B] 36L d4096 32H (GQA kv=8) ff12288 v151936, qk_norm, RoPE
QWEN3_8B = LMConfig(
    name="qwen3-8b", n_layers=36, d_model=4096, n_heads=32, n_kv=8, d_head=128,
    d_ff=12288, vocab=151936, qk_norm=True, rope_theta=1e6,
    norm="rmsnorm", act="silu", glu=True,
    param_dtype="bfloat16", attn_shard="kv")

# [hf:HuggingFaceTB/SmolLM-135M] 30L d576 9H (GQA kv=3) ff1536 v49152, llama-arch
SMOLLM_135M = LMConfig(
    name="smollm-135m", n_layers=30, d_model=576, n_heads=9, n_kv=3, d_head=64,
    d_ff=1536, vocab=49152, rope_theta=1e4, tie_embeddings=True,
    norm="rmsnorm", act="silu", glu=True,
    param_dtype="float32", attn_shard="none")

# [arXiv:2402.19173] 32L d4608 36H (GQA kv=4) ff18432 v49152; LayerNorm+GELU MLP
STARCODER2_7B = LMConfig(
    name="starcoder2-7b", n_layers=32, d_model=4608, n_heads=36, n_kv=4, d_head=128,
    d_ff=18432, vocab=49152, rope_theta=1e5,
    norm="layernorm", act="gelu", glu=False,
    param_dtype="bfloat16", attn_shard="group")

# [arXiv:2405.04434 / hf:deepseek-ai/DeepSeek-V2-Lite] 27L d2048 16H MLA
# kv_lora=512 d_rope=64; 1 leading dense layer (ff 10944); 26 MoE layers:
# 2 shared + 64 routed top-6, expert ff 1408.
DEEPSEEK_V2_LITE = LMConfig(
    name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16, n_kv=16,
    d_head=128, d_ff=10944, vocab=102400, rope_theta=1e4,
    mla=MLAConfig(kv_lora=512, q_lora=None, d_nope=128, d_rope=64, v_dim=128),
    moe=MoEConfig(n_routed=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  n_dense_layers=1, dense_d_ff=10944, capacity_factor=1.25),
    norm="rmsnorm", act="silu", glu=True,
    param_dtype="bfloat16", attn_shard="kv", attn_chunk=512)

# [arXiv:2412.19437] 61L d7168 128H MLA (kv_lora 512, q_lora 1536, rope 64);
# 3 leading dense layers (ff 18432); 58 MoE layers: 1 shared + 256 routed
# top-8, expert ff 2048; MTP depth 1.
DEEPSEEK_V3 = LMConfig(
    name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128, n_kv=128,
    d_head=128, d_ff=18432, vocab=129280, rope_theta=1e4,
    mla=MLAConfig(kv_lora=512, q_lora=1536, d_nope=128, d_rope=64, v_dim=128),
    moe=MoEConfig(n_routed=256, top_k=8, d_ff_expert=2048, n_shared=1,
                  n_dense_layers=3, dense_d_ff=18432, capacity_factor=1.25),
    mtp=True,
    norm="rmsnorm", act="silu", glu=True,
    param_dtype="bfloat16", attn_shard="kv", shard_carry=True,
    fsdp_params=True, attn_chunk=512)


def reduced_lm(cfg: LMConfig) -> LMConfig:
    """Same family, smoke-test scale: few layers, narrow, tiny vocab."""
    from dataclasses import replace
    moe = cfg.moe
    if moe is not None:
        # capacity 4.0 → no token drops: smoke tests assert exact
        # decode≡prefill equivalence, which capacity drops would break
        moe = replace(moe, n_routed=8, top_k=2, d_ff_expert=64,
                      n_dense_layers=min(1, moe.n_dense_layers),
                      dense_d_ff=128, capacity_factor=4.0)
    mla = cfg.mla
    if mla is not None:
        from dataclasses import replace as rep
        mla = rep(mla, kv_lora=32, q_lora=(24 if mla.q_lora else None),
                  d_nope=16, d_rope=8, v_dim=16)
    n_kv = min(cfg.n_kv, 2) if cfg.mla is None else 4
    n_heads = (4 if cfg.mla else (n_kv * min(cfg.n_group, 2)))
    return replace(
        cfg, n_layers=3 if moe is None else 4, d_model=64,
        n_heads=n_heads, n_kv=(n_heads if cfg.mla else n_kv), d_head=16,
        d_ff=128, vocab=512, mla=mla, moe=moe,
        param_dtype="float32", attn_chunk=32, remat=False)
