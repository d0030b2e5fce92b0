"""Each frozen count against a hand count at a small shape."""
import torch

from portbench.costs import augru, dien, din, din_attention, embedding_bag

T = torch.tensor
CFG = {"embed_dim": 2, "attn_mlp": [3, 2], "mlp": [4, 3], "gru_dim": 2,
       "user_fields": [{"name": "user_id", "vocab": 16, "bag": 1},
                       {"name": "user_profile", "vocab": 16, "bag": 2}],
       "item_fields": [{"name": "item_id", "vocab": 16, "bag": 1},
                       {"name": "item_cat", "vocab": 16, "bag": 1}]}
BATCH = {"user": {"fields": {"user_id": T([3, 3]),
                             "user_profile": T([[1, 2], [2, 2]])},
                  "hist": T([[5, -1, -1], [1, 2, 5]])},
         "item": {"item_id": T([5, 7]), "item_cat": T([0, 0])}}


def dense(i, o):
    return {"w": torch.zeros(i, o), "b": torch.zeros(o)}


W = {"attn_mlp": [dense(8, 3), dense(3, 2), dense(2, 1)],
     "mlp": [dense(10, 4), dense(4, 3), dense(3, 1)],
     "augru": {"w": torch.zeros(2, 6), "u": torch.zeros(2, 6),
               "b": torch.zeros(6)}}


def test_embedding_bag_pairs():
    # distinct rows: item_id {1, 2, 5, 7} + user_id {3} + profile {1, 2}
    # + cat {0} = 8 rows of 8 bytes; ids: 4 history + 2 targets + 2 user
    # ids + 4 profile + 2 cat = 14 of 8 bytes; pooled rows: 4 + 2 + 2 + 2
    # + 2 = 12 of 8 bytes; a multiply-add per looked-up element
    assert embedding_bag.pairs(CFG, BATCH, W) == (2 * 14 * 2,
                                                  64 + 112 + 96)


def test_din_attention():
    # a pair's target half 2*2*3 = 12, twice; a valid step 24 + 2 + 3 + 12
    # + 2 + 4 + 1 + 4 = 52, four of them; bytes: 4 steps x 3 floats, 2
    # targets, 38 weights, 2 outputs of 2 floats
    assert din_attention.pairs(CFG, BATCH, W) == (24 + 4 * 52,
                                                  (12 + 4 + 38 + 4) * 4)


def test_augru():
    # a valid step: x W 24 + bias 6 + h U 24 + gates 9 * 2 = 72, four steps
    assert augru.pairs(CFG, BATCH, W) == (288, (12 + 30 + 4) * 4)


def test_model_steps():
    assert din.pairs(CFG, BATCH, W)[0] == 56 + 232 + 2 * 118
    # GRU 70 a step x 4; attention 2 x 8 + 4 x 7; AUGRU 288; MLP 2 x 118
    assert dien.pairs(CFG, BATCH, W)[0] == 56 + 280 + 44 + 288 + 236
