"""The plain references against the port's CPU path (its kernels' plain
versions) at a reduced configuration, on the same weights and inputs;
and the configuration files against the repository's."""
import copy
import dataclasses

import pytest
import torch

from portbench import gen, harness, program
from portbench.tests.small import FIELDS


def reduced(name: str) -> dict:
    cfg = copy.deepcopy(harness.load_json(harness.find("configs", name,
                                                       ".json")))
    cfg.update(FIELDS, embed_dim=8, seq_len=12, mlp=[32, 16])
    if cfg["attn_mlp"]:
        cfg["attn_mlp"] = [16, 8]
    if cfg["gru_dim"]:
        cfg["gru_dim"] = 12
    return cfg


def setup(name: str, seed: int):
    cfg = reduced(name)
    ref = harness.load_module(harness.find("reference", name, ".py"))
    w = ref.draw(gen.generator(seed, "cpu"), cfg)
    return cfg, ref, w, program.module(cfg), program.recsys_config(cfg)


@pytest.mark.parametrize("name", ["din", "dien"])
def test_configs_are_the_repositorys(name):
    """The repository's configuration, but for the keys the file lists
    under "differs_from_repository"; the tables' cut is its "reduced"."""
    from repro_torch.configs import other_archs
    cfg = harness.load_json(harness.find("configs", name, ".json"))
    ours = dataclasses.asdict(program.recsys_config(cfg))
    repo = dataclasses.asdict(getattr(other_archs, name.upper()))
    differ = {k for k in ours if ours[k] != repo[k]}
    assert differ == set(cfg["differs_from_repository"])
    assert {"user_fields", "item_fields"} & differ == set(cfg["reduced"])
    for k in ("user_fields", "item_fields"):
        # only the rows of a table change
        assert ([dict(f, vocab=0) for f in ours[k]]
                == [dict(f, vocab=0) for f in repo[k]])


@pytest.mark.parametrize("name", ["din", "dien"])
def test_pair_scores_match_the_program(name):
    cfg, ref, w, prog, pcfg = setup(name, 11)
    batch = gen.pairs_batch(gen.generator(12, "cpu"), cfg,
                            {"batch": 64, "zipf_a": 1.05,
                             "hist_len": [1, cfg["seq_len"]]})
    want = ref.scores(w, batch, cfg, block=24)
    got = prog.serve_scores(w, batch, pcfg)
    assert torch.allclose(got, want, rtol=0, atol=1e-6)
    assert float(want.std()) > 1e-2          # the scores are spread

