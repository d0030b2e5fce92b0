"""The frozen traffic generator: fixed output for a fixed seed, the
Zipf law of the original, the same work for every seed."""
import numpy as np
import pytest
import torch

from portbench import gen
from portbench.tests.small import FIELDS


def cpu_gen(seed):
    return gen.generator(seed, "cpu")


def test_seeds_are_fixed_and_large_seeds_work():
    assert gen.seeds(2**31 + 5, 2) == gen.seeds(2**31 + 5, 2)
    assert gen.seeds(2**31 + 5, 2) != gen.seeds(2**31 + 6, 2)
    assert all(0 <= s < 2**63 for s in gen.seeds(2**33, 4))


def test_zipf_is_fixed_for_a_fixed_seed():
    got = gen.zipf(cpu_gen(12345), 12, 1 << 20, 1.05).tolist()
    assert got == gen.zipf(cpu_gen(12345), 12, 1 << 20, 1.05).tolist()
    assert got == GOLDEN_ZIPF


#: the first draws of seed 12345 on the CPU's generator
GOLDEN_ZIPF = [8647, 350663, 1019112, 675296, 707053, 594559, 2231, 573852,
               50, 3017, 897844, 129]


def test_zipf_follows_the_original_law():
    """Against numpy's Generator.zipf folded as data/synthetic.zipf_ids
    folds it: the shares of the hottest ids and of the tail agree."""
    n, vocab = 400_000, 1 << 16
    ours = gen.zipf(cpu_gen(7), n, vocab, 1.05).numpy()
    z = np.random.default_rng(7).zipf(1.05, n).astype(np.int64)
    theirs = (z - 1) % vocab
    for ids in (ours, theirs):
        assert ids.min() >= 0 and ids.max() < vocab
    for k in (0, 1, 2, 10):
        assert np.mean(ours == k) == pytest.approx(np.mean(theirs == k),
                                                   rel=0.05, abs=1e-3)
    assert np.mean(ours < 100) == pytest.approx(np.mean(theirs < 100),
                                                rel=0.02)


def test_quantile_sets():
    q = gen.quantile_ints(1000, 1, 100)
    assert q.min() == 1 and q.max() == 100
    assert np.all(np.bincount(q)[1:] == 10)


def test_pairs_batch_layout_and_padding():
    cfg = {"seq_len": 10, **FIELDS}
    traffic = {"batch": 40, "zipf_a": 1.05, "hist_len": [1, 10]}
    b = gen.pairs_batch(cpu_gen(3), cfg, traffic)
    hist = b["user"]["hist"]
    assert hist.shape == (40, 10) and hist.dtype == torch.int64
    lengths = (hist >= 0).sum(1)
    assert sorted(lengths.tolist()) == sorted(gen.quantile_ints(40, 1, 10))
    # the valid ids first, -1 after them
    assert torch.all((hist >= 0) == (torch.arange(10)[None] < lengths[:, None]))
    assert b["user"]["fields"]["user_profile"].shape == (40, 4)
    assert b["item"]["item_cat"].shape == (40,)
    assert int(b["item"]["item_id"].max()) < 1024

