"""The port's kernels, plain versions (CPU), against the reference: the JAX
ops in Pallas interpret mode and the reference's ref.py oracles, on the
reference's own sweep and edge cells and at its tolerances (2e-5 f32,
3e-5 on edge cells, 2e-2 bf16). The CUDA kernels themselves run only on
the card (chip_smoke.py holds each against these plain versions)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.din_attention.ops import din_attention as jax_din_attention
from repro.kernels.din_attention.ref import din_attention_ref as jax_din_ref
from repro.kernels.embedding_bag.ops import embedding_bag as jax_embedding_bag
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_bag_ref
from repro.kernels.rerank_score.ops import rerank_score as jax_rerank_score
from repro.kernels.rerank_score.ref import rerank_score_ref as jax_rerank_ref
from repro_torch.kernels.din_attention import din_attention
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.rerank_score import rerank_score

TOL_F32 = dict(rtol=2e-5, atol=2e-5)
TOL_EDGE = dict(rtol=3e-5, atol=3e-5)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)


def _f32(x):
    return np.asarray(x, np.float32)


def _pair(a, jdtype=jnp.float32, tdtype=torch.float32):
    """Same numpy values as a JAX array and a CPU torch tensor."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return jnp.asarray(a.astype(np.int32)), torch.as_tensor(a, dtype=torch.int64)
    a = a.astype(np.float32)
    return jnp.asarray(a).astype(jdtype), torch.as_tensor(a).to(tdtype)


def _check(got, wants, tol):
    for want in wants:
        np.testing.assert_allclose(_f32(got.float()), _f32(want), **tol)


# ------------------------------------------------------------ embedding_bag

def _bag_case(table, ids, w, combiner, tol, jdtype=jnp.float32,
              tdtype=torch.float32):
    tj, tt = _pair(table, jdtype, tdtype)
    ij, it = _pair(ids)
    wj, wt = _pair(w)
    got = embedding_bag(tt, it, wt, combiner=combiner)
    assert got.dtype == tdtype and got.shape == (ids.shape[0], table.shape[1])
    _check(got, [jax_embedding_bag(tj, ij, wj, combiner=combiner,
                                   interpret=True).astype(jnp.float32),
                 jax_bag_ref(tj, ij, wj, combiner=combiner).astype(jnp.float32)],
           tol)


@pytest.mark.parametrize("V,D,B,K", [(64, 8, 8, 3), (128, 64, 16, 5),
                                     (1000, 128, 8, 10), (32, 256, 24, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_sweep(V, D, B, K, dtype, combiner, rng):
    bf16 = dtype == "bfloat16"
    _bag_case(rng.normal(size=(V, D)), rng.integers(0, V, (B, K)),
              rng.random((B, K)) > 0.2, combiner, TOL_BF16 if bf16 else TOL_F32,
              jnp.bfloat16 if bf16 else jnp.float32,
              torch.bfloat16 if bf16 else torch.float32)


@pytest.mark.parametrize("B,K", [(1, 1), (1, 5), (8, 1)])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_edge_shapes(B, K, combiner, rng):
    _bag_case(rng.normal(size=(32, 8)), rng.integers(0, 32, (B, K)),
              rng.random((B, K)), combiner, TOL_EDGE)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_all_zero_weight_bags(combiner, rng):
    table = rng.normal(size=(16, 4))
    ids = rng.integers(0, 16, (3, 4))
    _bag_case(table, ids, np.zeros((3, 4)), combiner, TOL_EDGE)
    got = embedding_bag(torch.as_tensor(table, dtype=torch.float32),
                        torch.as_tensor(ids), torch.zeros(3, 4), combiner)
    assert torch.isfinite(got).all() and float(got.abs().max()) <= 1e-6


def test_embedding_bag_clips_ids_and_defaults_weights(rng):
    """Out-of-range ids clip to [0, V-1] (the reference's mode="clip");
    no weights = ones."""
    table = rng.normal(size=(10, 4))
    ids = np.array([[-3, 0, 9, 25]])
    tj, tt = _pair(table)
    ij, it = _pair(ids)
    got = embedding_bag(tt, it)
    _check(got, [jax_bag_ref(tj, ij)], TOL_F32)
    np.testing.assert_allclose(_f32(got[0]), _f32(table[[0, 0, 9, 9]].sum(0)),
                               **TOL_F32)


# ------------------------------------------------------------ din_attention

def _din_case(B, T, D, H1, H2, mask, tol, rng):
    hist, tgt = rng.normal(size=(B, T, D)), rng.normal(size=(B, D))
    w1 = rng.normal(size=(4 * D, H1)) * 0.2
    w2 = rng.normal(size=(H1, H2)) * 0.2
    w3 = rng.normal(size=(H2, 1)) * 0.2
    arrays = [hist, mask, tgt, w1, np.zeros(H1), w2, np.zeros(H2), w3,
              np.zeros(1)]
    pairs = [_pair(a) for a in arrays]
    jx = [p[0] for p in pairs]
    got = din_attention(*[p[1] for p in pairs])
    assert got.shape == (B, D)
    _check(got, [jax_din_attention(*jx, interpret=True), jax_din_ref(*jx)], tol)


@pytest.mark.parametrize("B,T,D,H1,H2", [(8, 8, 8, 8, 4), (16, 100, 18, 80, 40),
                                         (12, 33, 16, 32, 8)])
def test_din_attention_sweep(B, T, D, H1, H2, rng):
    _din_case(B, T, D, H1, H2, rng.random((B, T)) > 0.2, TOL_F32, rng)


@pytest.mark.parametrize("B,T", [(1, 1), (1, 9), (5, 1)])
def test_din_attention_edge_shapes(B, T, rng):
    _din_case(B, T, 8, 16, 8, np.ones((B, T)), TOL_EDGE, rng)


def test_din_attention_zero_mask(rng):
    _din_case(2, 6, 8, 16, 8, np.zeros((2, 6)), TOL_EDGE, rng)


# ------------------------------------------------------------- rerank_score

def _towers(rng, D, d_u, d_i, H1=16, H2=16, M1=32, M2=32):
    def mk(*s):
        return rng.normal(size=s) * 0.2
    return ([(mk(4 * D, H1), mk(H1)), (mk(H1, H2), mk(H2)), (mk(H2, 1), mk(1))],
            [(mk(2 * D + d_u + d_i, M1), mk(M1)), (mk(M1, M2), mk(M2)),
             (mk(M2, 1), mk(1))])


def _rerank_case(C, T, mask, rng):
    D, d_u, d_i = 8, 16, 8
    arrays = [rng.normal(size=(T, D)), mask, rng.normal(size=(C, D)),
              rng.normal(size=(d_u,)), rng.normal(size=(C, d_i))]
    attn, mlp = _towers(rng, D, d_u, d_i)
    pj = [_pair(a) for a in arrays]

    def tower(layers, k):
        return [{"w": _pair(w)[k], "b": _pair(b)[k]} for w, b in layers]

    got = rerank_score(*[p[1] for p in pj], tower(attn, 1), tower(mlp, 1))
    assert got.shape == (C,) and got.dtype == torch.float32
    jx = [p[0] for p in pj]
    flat = [_pair(a)[0] for w_b in attn + mlp for a in w_b]
    _check(got, [jax_rerank_score(*jx, tower(attn, 0), tower(mlp, 0),
                                  block_c=128, impl="pallas", interpret=True),
                 jax_rerank_ref(*jx, *flat)], TOL_F32)


@pytest.mark.parametrize("C,T", [(64, 7), (300, 12), (257, 33), (128, 1),
                                 (130, 16)])
def test_rerank_score_edge_shapes(C, T, rng):
    _rerank_case(C, T, rng.random(T) > 0.3, rng)


def test_rerank_score_fully_masked_history(rng):
    _rerank_case(64, 24, np.zeros(24), rng)
