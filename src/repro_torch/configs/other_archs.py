"""SchNet (GNN) and the four recsys architectures, exact assigned configs.

RecSys feature-field vocabularies: the assignment fixes embed_dim / mlp /
seq_len; table row counts follow the paper's regime (10^6–10^9 rows; JiZHI's
production models are 210–500 GB of sparse parameters, Table 1). We size
fields to land the flagship (two-tower) at ~0.5 TB fp32 — web-scale, and
shardable over 256 chips (2 GB/device) — with smaller tables for the
18/64-dim rankers, mirroring Table 1's service spread. All vocabs are
multiples of 512 so rows shard evenly over the ``model`` axis of both meshes.
"""
from dataclasses import replace

from repro_torch.configs.base import FeatureField, GNNConfig, RecsysConfig

# [arXiv:1706.08566] SchNet: 3 interactions, 64 hidden, 300 RBF, 10Å cutoff.
SCHNET = GNNConfig(name="schnet", n_interactions=3, d_hidden=64,
                   n_rbf=300, cutoff=10.0, n_atom_types=100)

_M = 1024 * 1024

# [RecSys'19 (YouTube)] two-tower retrieval: dim 256, towers 1024-512-256, dot.
TWO_TOWER = RecsysConfig(
    name="two-tower-retrieval", model="two_tower", embed_dim=256,
    user_fields=(
        FeatureField("user_id", 256 * _M),
        FeatureField("user_hist", 64 * _M, bag=50, combiner="mean"),
        FeatureField("user_geo", 1 * _M),
        FeatureField("user_ctx", 16 * _M, bag=8),
    ),
    item_fields=(
        FeatureField("item_id", 128 * _M),
        FeatureField("item_cat", 1 * _M, bag=4),
        FeatureField("item_author", 32 * _M),
    ),
    tower_mlp=(1024, 512, 256),
)

# [arXiv:1904.08030] MIND: dim 64, 4 interests, 3 capsule routing iters.
MIND = RecsysConfig(
    name="mind", model="mind", embed_dim=64,
    user_fields=(FeatureField("user_id", 64 * _M),),
    item_fields=(FeatureField("item_id", 64 * _M),
                 FeatureField("item_cat", 1 * _M)),
    n_interests=4, capsule_iters=3, seq_len=50,
    mlp=(256, 64),
)

# [arXiv:1706.06978] DIN: dim 18, seq 100, attn MLP 80-40, MLP 200-80.
DIN = RecsysConfig(
    name="din", model="din", embed_dim=18,
    user_fields=(FeatureField("user_id", 64 * _M),
                 FeatureField("user_profile", 1 * _M, bag=4)),
    item_fields=(FeatureField("item_id", 64 * _M),
                 FeatureField("item_cat", 1 * _M)),
    seq_len=100, attn_mlp=(80, 40), mlp=(200, 80),
)

# [arXiv:1809.03672] DIEN: dim 18, seq 100, GRU 108, AUGRU, MLP 200-80.
DIEN = RecsysConfig(
    name="dien", model="dien", embed_dim=18,
    user_fields=(FeatureField("user_id", 64 * _M),
                 FeatureField("user_profile", 1 * _M, bag=4)),
    item_fields=(FeatureField("item_id", 64 * _M),
                 FeatureField("item_cat", 1 * _M)),
    seq_len=100, gru_dim=108, mlp=(200, 80),
)


def reduced_gnn(cfg: GNNConfig) -> GNNConfig:
    return replace(cfg, n_interactions=2, d_hidden=16, n_rbf=20)


def reduced_recsys(cfg: RecsysConfig) -> RecsysConfig:
    uf = tuple(replace(f, vocab=1024) for f in cfg.user_fields)
    itf = tuple(replace(f, vocab=1024) for f in cfg.item_fields)
    small = {"tower_mlp": tuple(min(w, 32) for w in cfg.tower_mlp),
             "mlp": tuple(min(w, 32) for w in cfg.mlp),
             "attn_mlp": tuple(min(w, 16) for w in cfg.attn_mlp)}
    return replace(cfg, user_fields=uf, item_fields=itf,
                   embed_dim=min(cfg.embed_dim, 16),
                   seq_len=min(cfg.seq_len, 12) if cfg.seq_len else 0,
                   gru_dim=min(cfg.gru_dim, 16) if cfg.gru_dim else 0, **small)
