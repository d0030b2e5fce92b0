"""The port's retrieval models, MIND and two-tower, against the reference,
with the reference's weights carried across through numpy: serve_scores,
retrieve (full rankings compared by candidate, the top 10 index for
index),
interests / the towers' user and item vectors, and the forward loss, at
2e-5 (tests/test_rerank_fused.py). Configs: each arch's reduced config and
its published widths (MIND: D=64, K=4, 3 routing iterations, T=50, MLP
256-64; two-tower: D=256, towers 1024-512-256) with every table cut to
1024 rows."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry
from repro.configs.other_archs import MIND, TWO_TOWER
from repro.data import synthetic
from repro.models.recsys import mind as jax_mind
from repro.models.recsys import towers as jax_towers
from repro.serve.bucketing import ShapeBucketer, compact_history, step_buckets
from repro_torch.convert import params_from_numpy
from repro_torch.models.recsys import mind, towers

TOL = dict(rtol=2e-5, atol=2e-5)
MODULES = {"mind": (jax_mind, mind), "two_tower": (jax_towers, towers)}


def _vocab_1024(cfg):
    return dataclasses.replace(
        cfg, user_fields=tuple(dataclasses.replace(f, vocab=1024)
                               for f in cfg.user_fields),
        item_fields=tuple(dataclasses.replace(f, vocab=1024)
                          for f in cfg.item_fields))


def _reduced(arch_id):
    arch = registry.get(arch_id)
    return arch.reduced(arch.config)


CONFIGS = {
    "mind-reduced": lambda: _reduced("mind"),
    "mind-paper_vocab1024": lambda: _vocab_1024(MIND),
    "two_tower-reduced": lambda: _reduced("two-tower-retrieval"),
    "two_tower-paper_vocab1024": lambda: _vocab_1024(TWO_TOWER),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(cfg, reference module, port module, reference params, port params):
    the same weights in both."""
    cfg = CONFIGS[request.param]()
    jmod, tmod = MODULES[cfg.model]
    ref = jmod.init(jax.random.PRNGKey(0), cfg)
    port = params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    return cfg, jmod, tmod, ref, port


def _to_jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(
        a.astype(np.int32) if a.dtype.kind in "iu" else a), tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return torch.as_tensor(a, dtype=torch.int64 if a.dtype.kind in "iu"
                           else torch.float32)


def test_params_carry_across_unchanged(model):
    cfg, jmod, _tmod, ref, port = model
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_port = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), port))[0]
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_port]
    for (_, a), (_, b) in zip(flat_ref, flat_port):
        np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("arch_id", ["mind", "two-tower-retrieval"])
def test_init_layout_matches_reference(arch_id):
    cfg = _reduced(arch_id)
    jmod, tmod = MODULES[cfg.model]
    ref = jax.tree.map(np.shape, jmod.init(jax.random.PRNGKey(0), cfg))
    port = tmod.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), port) == ref


def test_serve_scores_match_reference(model, rng):
    cfg, jmod, tmod, ref, port = model
    batch = synthetic.recsys_batch(rng, cfg, 12)
    want = jmod.serve_scores(ref, _to_jax(batch), cfg)
    got = tmod.serve_scores(port, _to_torch(batch), cfg)
    assert got.shape == (12,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_loss_fn_matches_reference(model, rng):
    cfg, jmod, tmod, ref, port = model
    batch = synthetic.recsys_batch(rng, cfg, 8)
    want = jmod.loss_fn(ref, _to_jax(batch), cfg)
    got = tmod.loss_fn(port, _to_torch(batch), cfg)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_user_representation_matches_reference(model, rng):
    """MIND's interest capsules (B,K,D), with a partly padded history and
    one row with no valid step; the towers' user and item vectors."""
    cfg, jmod, tmod, ref, port = model
    batch = synthetic.recsys_batch(rng, cfg, 6)
    if cfg.model == "mind":
        hist = batch["user"]["hist"]
        hist[-1] = -1
        emb_ref, mask_ref = jax_mind._hist(ref, _to_jax(batch), cfg)
        emb, mask = mind._hist(port, _to_torch(batch), cfg)
        np.testing.assert_allclose(emb.numpy(), np.asarray(emb_ref), **TOL)
        want = jax_mind.interests(ref, emb_ref, mask_ref, cfg)
        got = mind.interests(port, emb, mask, cfg)
        assert got.shape == (6, cfg.n_interests, cfg.embed_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        for fn, ids in (("user_vec", batch["user"]["fields"]),
                        ("item_vec", batch["item"])):
            want = getattr(jmod, fn)(ref, _to_jax(ids), cfg)
            got = getattr(tmod, fn)(port, _to_torch(ids), cfg)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _request(cfg, rng, C):
    """One user and C distinct candidates; history compacted and bucketed
    as the serving path hands it over (MIND only)."""
    user = {"fields": {f.name: rng.integers(0, f.vocab, (1,) if f.bag == 1
                                            else (1, f.bag))
                       for f in cfg.user_fields}}
    if cfg.seq_len:
        hist = np.full(cfg.seq_len, -1, np.int64)
        n = max(1, cfg.seq_len - 5)
        hist[:n] = rng.integers(0, cfg.item_fields[0].vocab, n)
        user["hist"] = compact_history(
            hist, ShapeBucketer(step_buckets(cfg.seq_len)))[None]
    cand = {"item_id": rng.permutation(cfg.item_fields[0].vocab)[:C]}
    for f in cfg.item_fields[1:]:
        cand[f.name] = rng.integers(0, f.vocab, (C,) if f.bag == 1
                                    else (C, f.bag))
    return user, cand


def _retrieve(mod, params, user, cand, cfg, k):
    # the towers take the bare user-fields dict (serve/scenario.py)
    u = user["fields"] if cfg.model == "two_tower" else user
    return mod.retrieve(params, u, cand, cfg, top_k=k)


def _dense(v, i, C):
    out = np.empty(C, np.float32)
    out[np.asarray(i)] = np.asarray(v)
    return out


@pytest.mark.parametrize("C", [30, 64])
def test_retrieve_matches_reference(model, C, rng):
    cfg, jmod, tmod, ref, port = model
    user, cand = _request(cfg, rng, C)
    v_ref, i_ref = _retrieve(jmod, ref, _to_jax(user), _to_jax(cand), cfg, C)
    v, i = _retrieve(tmod, port, _to_torch(user), _to_torch(cand), cfg, C)
    assert v.shape == (C,) and i.dtype == torch.int64
    assert bool((v[:-1] >= v[1:]).all())                       # best first
    np.testing.assert_allclose(_dense(v, i, C), _dense(v_ref, i_ref, C), **TOL)


def test_retrieve_top10_matches_reference(model, rng):
    """The top 10 agree index for index (both rank equal scores lower
    index first, as lax.top_k does)."""
    cfg, jmod, tmod, ref, port = model
    user, cand = _request(cfg, rng, 64)
    _, i_ref = _retrieve(jmod, ref, _to_jax(user), _to_jax(cand), cfg, 10)
    v, i = _retrieve(tmod, port, _to_torch(user), _to_torch(cand), cfg, 10)
    assert i.tolist() == np.asarray(i_ref).tolist()
    # dot products of l2-normalised vectors
    assert float(v.abs().max()) <= 1.0 + 1e-5
