"""Config dataclasses for every supported architecture family + shape specs."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

# --------------------------------------------------------------------------
# LM family
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: Optional[int] = None
    d_nope: int = 128
    d_rope: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 1
    n_dense_layers: int = 1          # leading dense-FFN layers (DeepSeek style)
    dense_d_ff: Optional[int] = None  # d_ff of those leading dense layers
    capacity_factor: Optional[float] = 1.25  # None: dropless (no pair dropped)
    router_scale: Optional[float] = None
    norm_topk_prob: bool = True      # renormalise the top-k gates to sum 1


@dataclass(frozen=True)
class RopeScaling:
    """YaRN rope scaling, under the published ``rope_scaling`` keys."""
    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0
    type: str = "yarn"


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    rope_theta: float = 1e6
    rope_scaling: Optional[RopeScaling] = None  # None: plain RoPE
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu
    glu: bool = True                 # SwiGLU-style gated FFN
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    mtp: bool = False                # DeepSeek-V3 multi-token prediction head
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    param_dtype: str = "float32"     # big configs override to bfloat16
    attn_chunk: int = 1024           # KV-chunk for memory-efficient attention
    attn_shard: str = "kv"           # which head dim to TP-shard: kv | group | none
    remat: bool = True
    shard_carry: bool = False        # shard residual stream over `model`
                                     # (Megatron-SP-style activation sharding)
    fsdp_params: bool = False        # ZeRO-3: shard non-expert params over
                                     # `data` too (re-gathered per layer)
    family: str = "lm"

    @property
    def n_group(self) -> int:
        return self.n_heads // self.n_kv

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.mla is None:
            attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv * self.d_head \
                + self.n_heads * self.d_head * d
        else:
            m = self.mla
            dq = m.d_nope + m.d_rope
            if m.q_lora:
                q = d * m.q_lora + m.q_lora * self.n_heads * dq
            else:
                q = d * self.n_heads * dq
            attn = q + d * (m.kv_lora + m.d_rope) \
                + m.kv_lora * self.n_heads * (m.d_nope + m.v_dim) \
                + self.n_heads * m.v_dim * d
        def ffn(dff): return d * dff * (3 if self.glu else 2)
        if self.moe is None:
            blocks = L * (attn + ffn(self.d_ff))
        else:
            mo = self.moe
            n_moe = L - mo.n_dense_layers
            dense = mo.n_dense_layers * ffn(mo.dense_d_ff or self.d_ff)
            routed = n_moe * (mo.n_routed * ffn(mo.d_ff_expert)
                              + mo.n_shared * ffn(mo.d_ff_expert)
                              + d * mo.n_routed)
            blocks = L * attn + dense + routed
        if self.mtp:
            blocks += attn + ffn(self.moe.d_ff_expert * (self.moe.n_routed + self.moe.n_shared)
                                 if self.moe else self.d_ff) * 0  # MTP block ≈ one layer, counted coarsely below
            blocks += 2 * d * d  # mtp projection
        return emb + blocks

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        mo = self.moe
        full = self.param_count()
        def ffn(dff): return d * dff * (3 if self.glu else 2)
        n_moe = L - mo.n_dense_layers
        inactive = n_moe * (mo.n_routed - mo.top_k) * ffn(mo.d_ff_expert)
        return full - inactive


# --------------------------------------------------------------------------
# GNN family
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class GNNConfig:
    name: str
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_atom_types: int = 100          # embedding vocab for molecular graphs
    readout: str = "sum"
    param_dtype: str = "float32"
    family: str = "gnn"


# --------------------------------------------------------------------------
# RecSys family
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class FeatureField:
    name: str
    vocab: int                       # hashed bucket count
    bag: int = 1                     # multi-hot width (1 = one-hot)
    combiner: str = "sum"


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    model: str                       # two_tower | mind | din | dien
    embed_dim: int
    user_fields: tuple[FeatureField, ...] = ()
    item_fields: tuple[FeatureField, ...] = ()
    tower_mlp: tuple[int, ...] = ()          # two-tower
    n_interests: int = 0                      # mind
    capsule_iters: int = 0                    # mind
    seq_len: int = 0                          # din/dien/mind history length
    attn_mlp: tuple[int, ...] = ()            # din
    gru_dim: int = 0                          # dien
    mlp: tuple[int, ...] = ()                 # final MLP
    param_dtype: str = "float32"
    family: str = "recsys"

    def table_specs(self):
        from repro_torch.sparse.embedding import TableSpec
        return [TableSpec(f.name, f.vocab, self.embed_dim, f.combiner)
                for f in self.user_fields + self.item_fields]

    def param_count(self) -> int:
        n = sum(f.vocab * self.embed_dim for f in self.user_fields + self.item_fields)
        return n  # MLP params are negligible vs tables; counted exactly in models


# --------------------------------------------------------------------------
# Shapes
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode | graph_full | graph_mini | graph_batched
                     # | rec_train | rec_serve | rec_retrieval
    dims: dict = field(default_factory=dict)


LM_SHAPES = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode_long", {"seq_len": 524288, "global_batch": 1}),
)

GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "graph_full",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeSpec("minibatch_lg", "graph_mini",
              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
               "fanout": (15, 10), "d_feat": 602}),
    ShapeSpec("ogb_products", "graph_full",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100}),
    ShapeSpec("molecule", "graph_batched",
              {"n_nodes": 30, "n_edges": 64, "batch": 128}),
)

REC_SHAPES = (
    ShapeSpec("train_batch", "rec_train", {"batch": 65536}),
    ShapeSpec("serve_p99", "rec_serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "rec_serve", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "rec_retrieval", {"batch": 1, "n_candidates": 1000000}),
)
