"""The port's DIN model and sparse substrate against the reference, with
the reference's weights carried across through numpy: serve_scores and
both score_candidates paths at 2e-5 (tests/test_rerank_fused.py) on the
reduced config and on the published widths with vocab 1024; rankings
compared tie-insensitively; hash_bucket bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry
from repro.configs.other_archs import DIN
from repro.data import synthetic
from repro.models import layers as jax_layers
from repro.models.recsys import din as jax_din
from repro.serve.bucketing import ShapeBucketer, compact_history, step_buckets
from repro.sparse import embedding as jax_embedding
from repro.sparse.hashing import hash_bucket as jax_hash_bucket
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers
from repro_torch.models.recsys import din
from repro_torch.sparse import embedding, sharded
from repro_torch.sparse.hashing import hash_bucket

TOL = dict(rtol=2e-5, atol=2e-5)


def _reduced():
    arch = registry.get("din")
    return arch.reduced(arch.config)


def _paper_vocab_1024():
    """Published DIN widths (D=18, T=100, attn 80-40, mlp 200-80) with
    every table cut to 1024 rows."""
    return dataclasses.replace(
        DIN, user_fields=tuple(dataclasses.replace(f, vocab=1024)
                               for f in DIN.user_fields),
        item_fields=tuple(dataclasses.replace(f, vocab=1024)
                          for f in DIN.item_fields))


CONFIGS = {"reduced": _reduced, "paper_vocab1024": _paper_vocab_1024}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(cfg, reference params, port params): the same weights in both."""
    cfg = CONFIGS[request.param]()
    ref = jax_din.init(jax.random.PRNGKey(0), cfg)
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


def test_serve_scores_match_reference(model, rng):
    cfg, ref, port = model
    batch = synthetic.recsys_batch(rng, cfg, 12)
    want = jax_din.serve_scores(ref, _to_jax(batch), cfg)
    got = din.serve_scores(port, _to_torch(batch), cfg)
    assert got.shape == (12,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_loss_fn_matches_reference(model, rng):
    cfg, ref, port = model
    batch = synthetic.recsys_batch(rng, cfg, 8)
    want = jax_din.loss_fn(ref, _to_jax(batch), cfg)
    got = din.loss_fn(port, _to_torch(batch), cfg)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def _request(cfg, rng, C, distinct=False):
    V = cfg.item_fields[0].vocab
    hist = np.full(cfg.seq_len, -1, np.int64)
    idx = rng.permutation(cfg.seq_len)[:max(1, cfg.seq_len - 3)]
    hist[idx] = rng.integers(0, V, len(idx))
    hist = compact_history(hist, ShapeBucketer(step_buckets(cfg.seq_len)))
    fields = {f.name: rng.integers(0, f.vocab, (1,) if f.bag == 1 else (1, f.bag))
              for f in cfg.user_fields}
    # duplicate-heavy candidate ids (the realistic recall mix) unless a
    # strict ranking is wanted
    ids = rng.permutation(V)[:C] if distinct else rng.integers(0, 16, C)
    cand = {"item_id": ids, "item_cat": rng.integers(0, 1024, C)}
    return {"hist": hist[None], "fields": fields}, cand


def _dense(v, i, C):
    out = np.empty(C, np.float32)
    out[np.asarray(i)] = np.asarray(v)
    return out


@pytest.mark.parametrize("path", ["fused", "jnp"])
@pytest.mark.parametrize("C", [30, 64])
def test_score_candidates_match_reference(model, path, C, rng):
    cfg, ref, port = model
    user, cand = _request(cfg, rng, C)
    v_ref, i_ref = jax_din.score_candidates(ref, _to_jax(user), _to_jax(cand),
                                            cfg, top_k=C, path=path)
    v, i = din.score_candidates(port, _to_torch(user), _to_torch(cand), cfg,
                                top_k=C, path=path)
    assert v.shape == (C,) and bool((v[:-1] >= v[1:]).all())   # best first
    np.testing.assert_allclose(_dense(v, i, C), _dense(v_ref, i_ref, C), **TOL)


def test_score_candidates_fused_matches_broadcast_path(model, rng):
    cfg, _ref, port = model
    C = 48
    user, cand = _request(cfg, rng, C)
    u, c = _to_torch(user), _to_torch(cand)
    s_fused = _dense(*din.score_candidates(port, u, c, cfg, top_k=C), C)
    s_jnp = _dense(*din.score_candidates(port, u, c, cfg, top_k=C,
                                         path="jnp"), C)
    np.testing.assert_allclose(s_fused, s_jnp, **TOL)


def test_score_candidates_ranking_matches_reference(model, rng):
    """Top-10 sets agree (the order among equal scores is not fixed:
    torch.topk, like lax.top_k, leaves ties to the implementation)."""
    cfg, ref, port = model
    C = 64
    user, cand = _request(cfg, rng, C, distinct=True)
    _, i_ref = jax_din.score_candidates(ref, _to_jax(user), _to_jax(cand), cfg,
                                        top_k=10)
    _, i = din.score_candidates(port, _to_torch(user), _to_torch(cand), cfg,
                                top_k=10)
    assert set(i.tolist()) == set(np.asarray(i_ref).tolist())


def test_din_init_layout_matches_reference():
    cfg = _reduced()
    ref = jax.tree.map(np.shape, jax_din.init(jax.random.PRNGKey(0), cfg))
    port = din.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), port) == ref


# ------------------------------------------------------------------ sparse

@pytest.mark.parametrize("group,vocab", [(0, 1024), (3, 1 << 26), (17, 1000)])
def test_hash_bucket_bit_exact(group, vocab, rng):
    ids = np.concatenate([rng.integers(0, 2**31 - 1, 512),
                          rng.integers(-2**31, 0, 64), [0, 1, 2**31 - 1, -1]])
    want = np.asarray(jax_hash_bucket(group, jnp.asarray(ids.astype(np.int32)),
                                      vocab))
    got = hash_bucket(group, torch.as_tensor(ids), vocab)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_ragged_matches_reference(combiner, weighted, rng):
    table = rng.normal(size=(40, 6)).astype(np.float32)
    ids = rng.integers(-2, 45, 30)              # out-of-range ids clip
    seg = np.sort(rng.integers(0, 7, 30))
    w = rng.random(30).astype(np.float32) if weighted else None
    want = jax_embedding.embedding_bag_ragged(
        jnp.asarray(table), jnp.asarray(ids.astype(np.int32)),
        jnp.asarray(seg.astype(np.int32)), 8,
        None if w is None else jnp.asarray(w), combiner)
    got = embedding.embedding_bag_ragged(
        torch.as_tensor(table), torch.as_tensor(ids), torch.as_tensor(seg), 8,
        None if w is None else torch.as_tensor(w), combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lookup_and_padded_bag_match_reference(rng):
    table = rng.normal(size=(20, 5)).astype(np.float32)
    ids = rng.integers(-3, 25, (4, 3))
    w = rng.random((4, 3)).astype(np.float32)
    tj, ij = jnp.asarray(table), jnp.asarray(ids.astype(np.int32))
    tt, it = torch.as_tensor(table), torch.as_tensor(ids)
    np.testing.assert_array_equal(embedding.lookup(tt, it).numpy(),
                                  np.asarray(jax_embedding.lookup(tj, ij)))
    for comb in ("sum", "mean"):
        want = jax_embedding.embedding_bag_padded(tj, ij, jnp.asarray(w), comb)
        got = sharded.sharded_embedding_bag_2d(tt, it, torch.as_tensor(w), comb)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # 1-D ids are single-id bags
    np.testing.assert_allclose(
        sharded.sharded_embedding_bag_2d(tt, it[:, 0]).numpy(),
        embedding.lookup(tt, it[:, 0]).numpy(), **TOL)


def test_sharded_paths_refuse_a_mesh():
    t = torch.zeros(4, 2)
    i = torch.zeros(3, dtype=torch.int64)
    for fn in (sharded.sharded_lookup, sharded.sharded_gather_a2a,
               sharded.sharded_embedding_bag, sharded.sharded_embedding_bag_2d):
        with pytest.raises(NotImplementedError):
            fn(t, i[:, None] if "bag" in fn.__name__ else i, mesh=object())


def test_offsets_and_cube_bag_are_the_reference_numpy(rng):
    offsets = np.array([0, 2, 2, 5])
    np.testing.assert_array_equal(
        embedding.offsets_to_segment_ids(offsets, 7),
        jax_embedding.offsets_to_segment_ids(offsets, 7))


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("kind", ["gelu", "silu"])
def test_activation_matches_reference(kind, rng):
    x = rng.normal(size=(64,)).astype(np.float32) * 4
    np.testing.assert_allclose(
        layers.activation(torch.as_tensor(x), kind).numpy(),
        np.asarray(jax_layers.activation(jnp.asarray(x), kind)), **TOL)


def test_mlp_tower_apply_matches_reference(rng):
    ref = jax_layers.mlp_tower_init(jax.random.PRNGKey(1), 10, (16, 8, 1),
                                    jnp.float32)
    port = params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    x = rng.normal(size=(5, 10)).astype(np.float32)
    for act, final in (("silu", False), ("gelu", True)):
        np.testing.assert_allclose(
            layers.mlp_tower_apply(port, torch.as_tensor(x), act, final).numpy(),
            np.asarray(jax_layers.mlp_tower_apply(ref, jnp.asarray(x), act,
                                                  final)), **TOL)
