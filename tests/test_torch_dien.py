"""The port's DIEN model against the reference, with the reference's
weights carried across through numpy: serve_scores, score_candidates
(rankings compared index for index), logits_fn with the auxiliary loss,
loss_fn, and the GRU / AUGRU pieces, at 2e-5 (tests/test_rerank_fused.py)
on the reduced config and at the published widths (D=18, T=100, GRU and
AUGRU 108, MLP 200-80) with every table cut to 1024 rows."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry
from repro.configs.other_archs import DIEN
from repro.data import synthetic
from repro.models.recsys import dien as jax_dien
from repro.serve.bucketing import ShapeBucketer, compact_history, step_buckets
from repro_torch.convert import params_from_numpy
from repro_torch.models.recsys import dien

TOL = dict(rtol=2e-5, atol=2e-5)


def _reduced():
    arch = registry.get("dien")
    return arch.reduced(arch.config)


def _paper_vocab_1024():
    return dataclasses.replace(
        DIEN, user_fields=tuple(dataclasses.replace(f, vocab=1024)
                                for f in DIEN.user_fields),
        item_fields=tuple(dataclasses.replace(f, vocab=1024)
                          for f in DIEN.item_fields))


CONFIGS = {"reduced": _reduced, "paper_vocab1024": _paper_vocab_1024}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(cfg, reference params, port params): the same weights in both."""
    cfg = CONFIGS[request.param]()
    ref = jax_dien.init(jax.random.PRNGKey(0), cfg)
    port = params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    return cfg, ref, port


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
    """convert.params_from_numpy keeps DIEN's nested {"gru": {"w","u","b"},
    ...} tree: the same keys, shapes and values."""
    _cfg, ref, port = model
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_port = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), port))[0]
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_port]
    for (_, a), (_, b) in zip(flat_ref, flat_port):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_init_layout_matches_reference():
    cfg = _reduced()
    ref = jax.tree.map(np.shape, jax_dien.init(jax.random.PRNGKey(0), cfg))
    port = dien.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), port) == ref


def test_serve_scores_match_reference(model, rng):
    cfg, ref, port = model
    batch = synthetic.recsys_batch(rng, cfg, 12)
    want = jax_dien.serve_scores(ref, _to_jax(batch), cfg)
    got = dien.serve_scores(port, _to_torch(batch), cfg)
    assert got.shape == (12,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_logits_and_aux_match_reference(model, rng):
    cfg, ref, port = model
    batch = synthetic.recsys_batch(rng, cfg, 8)
    want_l, want_aux = jax_dien.logits_fn(ref, _to_jax(batch), cfg,
                                          return_aux=True)
    got_l, got_aux = dien.logits_fn(port, _to_torch(batch), cfg,
                                    return_aux=True)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)


def test_loss_fn_matches_reference(model, rng):
    cfg, ref, port = model
    batch = synthetic.recsys_batch(rng, cfg, 8)
    want = jax_dien.loss_fn(ref, _to_jax(batch), cfg)
    got = dien.loss_fn(port, _to_torch(batch), cfg)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_gru_and_augru_match_reference(model, rng):
    cfg, ref, port = model
    B, T, D, H = 4, cfg.seq_len, cfg.embed_dim, cfg.gru_dim
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    states_ref = jax_dien.gru_apply(ref["gru"], jnp.asarray(x))
    states = dien.gru_apply(port["gru"], torch.as_tensor(x))
    assert states.shape == (B, T, H)
    np.testing.assert_allclose(states.numpy(), np.asarray(states_ref), **TOL)
    att = rng.random((B, T)).astype(np.float32)
    np.testing.assert_allclose(
        dien.augru_apply(port["augru"], states, torch.as_tensor(att)).numpy(),
        np.asarray(jax_dien.augru_apply(ref["augru"], states_ref,
                                        jnp.asarray(att))), **TOL)


def test_all_padding_history_gives_zero_attention(model, rng):
    """jnp.where(mask > 0, att, -1e30) then softmax × mask: a history with
    no valid step attends nowhere, so the AUGRU state stays 0."""
    cfg, _ref, port = model
    B, T, D, H = 3, cfg.seq_len, cfg.embed_dim, cfg.gru_dim
    hist = torch.as_tensor(rng.normal(size=(B, T, D)), dtype=torch.float32)
    target = torch.as_tensor(rng.normal(size=(B, D)), dtype=torch.float32)
    mask = torch.zeros((B, T))
    states = dien.gru_apply(port["gru"], hist)
    att = dien._attention(states, port["att_w"], target, mask)
    assert torch.equal(att, torch.zeros((B, T)))
    _states, final = dien._evolved_interest(port, hist, mask, target)
    assert torch.equal(final, torch.zeros((B, H)))


def _request(cfg, rng, C, distinct=False):
    V = cfg.item_fields[0].vocab
    hist = np.full(cfg.seq_len, -1, np.int64)
    idx = rng.permutation(cfg.seq_len)[:max(1, cfg.seq_len - 3)]
    hist[idx] = rng.integers(0, V, len(idx))
    hist = compact_history(hist, ShapeBucketer(step_buckets(cfg.seq_len)))
    fields = {f.name: rng.integers(0, f.vocab, (1,) if f.bag == 1 else (1, f.bag))
              for f in cfg.user_fields}
    ids = rng.permutation(V)[:C] if distinct else rng.integers(0, 16, C)
    cand = {"item_id": ids, "item_cat": rng.integers(0, 1024, C)}
    return {"hist": hist[None], "fields": fields}, cand


def _dense(v, i, C):
    out = np.empty(C, np.float32)
    out[np.asarray(i)] = np.asarray(v)
    return out


@pytest.mark.parametrize("C", [30, 64])
def test_score_candidates_match_reference(model, C, rng):
    cfg, ref, port = model
    user, cand = _request(cfg, rng, C)
    v_ref, i_ref = jax_dien.score_candidates(ref, _to_jax(user),
                                             _to_jax(cand), cfg, top_k=C)
    v, i = dien.score_candidates(port, _to_torch(user), _to_torch(cand), cfg,
                                 top_k=C)
    assert v.shape == (C,) and bool((v[:-1] >= v[1:]).all())   # best first
    np.testing.assert_allclose(_dense(v, i, C), _dense(v_ref, i_ref, C), **TOL)


def test_score_candidates_ranking_matches_reference(model, rng):
    """The top 10 agree index for index (both rank equal scores lower
    index first, as lax.top_k does)."""
    cfg, ref, port = model
    user, cand = _request(cfg, rng, 64, distinct=True)
    _, i_ref = jax_dien.score_candidates(ref, _to_jax(user), _to_jax(cand),
                                         cfg, top_k=10)
    _, i = dien.score_candidates(port, _to_torch(user), _to_torch(cand), cfg,
                                 top_k=10)
    assert i.tolist() == np.asarray(i_ref).tolist()
