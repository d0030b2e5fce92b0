"""The port's kernels, plain versions (CPU), against the reference: the JAX
ops in Pallas interpret mode and the reference's ref.py oracles, on the
reference's own sweep and edge cells and at its tolerances (2e-5 f32,
3e-5 on edge cells, for augru and for flash_decode against the model's
decode_attention, 2e-2 bf16; candidate_scorer's f32 index sets equal). The CUDA kernels themselves run only on the card
(chip_smoke.py holds each against these plain versions)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.augru.ops import augru as jax_augru
from repro.kernels.augru.ref import augru_ref as jax_augru_ref
from repro.kernels.candidate_scorer.ops import candidate_scorer as jax_scorer
from repro.kernels.candidate_scorer.ref import (candidate_scorer_ref as
                                                jax_scorer_ref)
from repro.kernels.din_attention.ops import din_attention as jax_din_attention
from repro.kernels.din_attention.ref import din_attention_ref as jax_din_ref
from repro.kernels.embedding_bag.ops import embedding_bag as jax_embedding_bag
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_bag_ref
from repro.kernels.flash_decode.ops import flash_decode as jax_flash_decode
from repro.kernels.flash_decode.ref import flash_decode_ref as jax_decode_ref
from repro.models.attention import decode_attention as jax_decode_attention
from repro.kernels.rerank_score.ops import rerank_score as jax_rerank_score
from repro.kernels.rerank_score.ref import rerank_score_ref as jax_rerank_ref
from repro_torch.kernels.augru import augru, augru_ref
from repro_torch.kernels.candidate_scorer import (candidate_scorer,
                                                  candidate_scorer_ref)
from repro_torch.kernels.din_attention import din_attention
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
from repro_torch.models.attention import decode_attention
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


# -------------------------------------------------------------------- augru

def _augru_case(B, T, Din, H, att, rng, w_scale=0.3, u_scale=0.3,
                b_scale=0.1):
    arrays = [rng.normal(size=(B, T, Din)), att,
              rng.normal(size=(Din, 3 * H)) * w_scale,
              rng.normal(size=(H, 3 * H)) * u_scale,
              rng.normal(size=(3 * H,)) * b_scale]
    pairs = [_pair(a) for a in arrays]
    jx, tx = [p[0] for p in pairs], [p[1] for p in pairs]
    got = augru(*tx)
    assert got.shape == (B, H) and got.dtype == torch.float32
    _check(got, [jax_augru(*jx, interpret=True), jax_augru_ref(*jx),
                 augru_ref(*tx)], TOL_EDGE)
    return got


@pytest.mark.parametrize("B,T,Din,H", [(8, 8, 8, 8), (16, 100, 18, 108),
                                       (4, 25, 12, 20)])
def test_augru_sweep(B, T, Din, H, rng):
    _augru_case(B, T, Din, H, rng.random((B, T)), rng)


@pytest.mark.parametrize("B,T", [(1, 1), (1, 7), (4, 1)])
def test_augru_edge_shapes(B, T, rng):
    _augru_case(B, T, 6, 10, rng.random((B, T)), rng)


def test_augru_zero_attention_freezes_state(rng):
    """a_t = 0 ⇒ h never moves from 0 (the AUGRU gate algebra)."""
    got = _augru_case(4, 12, 8, 8, np.zeros((4, 12)), rng, w_scale=1.0,
                      u_scale=1.0, b_scale=0.0)
    np.testing.assert_allclose(got.numpy(), 0.0, atol=1e-7)


@pytest.mark.parametrize("B", [16, 64])
def test_augru_dien_path_shapes(B, rng):
    """The serving path's shapes: a micro-batch (B=16) and a re-ranked
    request (B=C=64), T=100, Din=H=108, softmax-normalised attention."""
    att = rng.random((B, 100))
    _augru_case(B, 100, 108, 108, att / att.sum(-1, keepdims=True), rng,
                w_scale=1 / np.sqrt(108), u_scale=1 / np.sqrt(108),
                b_scale=0.0)


# --------------------------------------------------------- candidate_scorer

def _scorer_case(cands, q, k, block_c, tol, bf16=False, same_set=True):
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                          torch.float32)
    cj, ct = _pair(cands, jd, td)
    qj, qt = _pair(q, jd, td)
    v, i = candidate_scorer(ct, qt, k=k)
    assert v.shape == (k,) and v.dtype == torch.float32
    assert i.shape == (k,) and i.dtype == torch.int64
    assert bool((v[:-1] >= v[1:]).all())                       # best first
    rv, ri = candidate_scorer_ref(ct, qt, k)
    jv, ji = jax_scorer(cj, qj, k=k, block_c=block_c, interpret=True)
    rjv, rji = jax_scorer_ref(cj, qj, k)
    _check(v, [rv, jv, rjv.astype(jnp.float32)], tol)
    if same_set:
        want = set(np.asarray(rji).tolist())
        assert set(i.tolist()) == want == set(np.asarray(ji).tolist())
        assert set(ri.tolist()) == want


@pytest.mark.parametrize("C,D,k,bc", [(4096, 64, 8, 512), (1000, 16, 4, 256),
                                      (300, 256, 8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_candidate_scorer_sweep(C, D, k, bc, dtype, rng):
    bf16 = dtype == "bfloat16"
    # bf16 near-ties may permute indices (as in tests/test_kernels.py)
    _scorer_case(rng.normal(size=(C, D)), rng.normal(size=(D,)), k, bc,
                 TOL_BF16 if bf16 else TOL_F32, bf16=bf16, same_set=not bf16)


@pytest.mark.parametrize("C,k", [(64, 1), (17, 4), (128, 128)])
def test_candidate_scorer_edge_shapes(C, k, rng):
    _scorer_case(rng.normal(size=(C, 16)), rng.normal(size=(16,)), k, 64,
                 TOL_F32)


def test_candidate_scorer_service_shape(rng):
    """two-tower retrieve in the service: C=64 l2-normalised item vectors,
    D=256, the full ranking (k=C)."""
    v = rng.normal(size=(64, 256))
    q = rng.normal(size=(256,))
    _scorer_case(v / np.linalg.norm(v, axis=-1, keepdims=True),
                 q / np.linalg.norm(q), 64, 1024, TOL_F32)


# ------------------------------------------------------------- flash_decode

def _decode_case(B, S, H, G, D, L, tol, jdtype=jnp.float32,
                 tdtype=torch.float32, rng=None):
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.normal(size=s), jdtype, tdtype)
        for s in ((B, H, G, D), (B, S, H, D), (B, S, H, D)))
    got = flash_decode(qt, kt, vt, torch.tensor(L, dtype=torch.int32))
    assert got.dtype == tdtype and got.shape == (B, H, G, D)
    _check(got, [jax_flash_decode(qj, kj, vj, L, block_k=32,
                                  interpret=True).astype(jnp.float32),
                 jax_decode_ref(qj, kj, vj, L).astype(jnp.float32)], tol)
    return (qj, kj, vj), (qt, kt, vt)


@pytest.mark.parametrize("B,S,H,G,D,L", [(2, 128, 4, 3, 16, 100),
                                         (1, 256, 2, 1, 64, 256),
                                         (4, 64, 8, 4, 32, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_sweep(B, S, H, G, D, L, dtype, rng):
    bf16 = dtype == "bfloat16"
    _decode_case(B, S, H, G, D, L, TOL_BF16 if bf16 else TOL_F32,
                 jnp.bfloat16 if bf16 else jnp.float32,
                 torch.bfloat16 if bf16 else torch.float32, rng=rng)


@pytest.mark.parametrize("B,S,H,G,D,L,dtype", [
    (2, 96, 2, 9, 128, 90, "float32"), (2, 96, 2, 9, 128, 90, "bfloat16"),
    (4, 64, 8, 4, 128, 40, "bfloat16"), (2, 64, 2, 16, 32, 50, "bfloat16"),
    (1, 64, 1, 1, 16, 33, "bfloat16")])
def test_flash_decode_path_groups(B, S, H, G, D, L, dtype, rng):
    """The groups the kernel's paths tile for: starcoder2-7b's G=9 at
    D=128 (two 8-wide N tiles in bf16, fp32 FMAs in f32), qwen3-8b's
    serve-like shape, the bf16 path's widest group (16) and G=1."""
    bf16 = dtype == "bfloat16"
    _decode_case(B, S, H, G, D, L, TOL_BF16 if bf16 else TOL_F32,
                 jnp.bfloat16 if bf16 else jnp.float32,
                 torch.bfloat16 if bf16 else torch.float32, rng=rng)


@pytest.mark.parametrize("B,S,L", [(1, 64, 1), (1, 32, 32), (3, 64, 1)])
def test_flash_decode_edge_shapes(B, S, L, rng):
    _decode_case(B, S, 2, 2, 16, L, TOL_EDGE, rng=rng)


@pytest.mark.parametrize("L", [70, 96])
def test_flash_decode_matches_model_decode_path(L, rng):
    """The plain version ≡ the model's decode_attention, the reference's
    and the port's (the reference's tolerance, 3e-5)."""
    B, S, H, G, D = 2, 96, 2, 2, 16
    (qj, kj, vj), (qt, kt, vt) = _decode_case(B, S, H, G, D, L, TOL_F32,
                                              rng=rng)
    got = flash_decode_ref(qt, kt, vt, L)
    _check(got, [jax_decode_attention(qj[:, None], kj, vj,
                                      jnp.asarray(L))[:, 0]], TOL_EDGE)
    _check(got, [decode_attention(qt[:, None], kt, vt, L)[:, 0].numpy()],
           TOL_EDGE)


def test_flash_decode_plain_version_takes_a_scale(rng):
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
               for s in ((1, 2, 2, 16), (1, 10, 2, 16), (1, 10, 2, 16)))
    qj, kj, vj = (jnp.asarray(x.numpy()) for x in (q, k, v))
    _check(flash_decode(q, k, v, 7, scale=0.5),
           [jax_decode_attention(qj[:, None], kj, vj, 7, scale=0.5)[:, 0]],
           TOL_EDGE)


def _lse64(q, k, L, scale=None):
    """The log-sum-exp of each row's scaled scores over the first L rows,
    in float64, from the definition."""
    q, k = q.double().numpy(), k.double().numpy()
    scale = scale if scale is not None else 1.0 / np.sqrt(q.shape[-1])
    s = np.einsum("bhgd,bshd->bhgs", q, k)[..., :L] * scale
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("L", [1, 40, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_lse_matches_float64(L, dtype, rng):
    """``return_lse`` gives the output of the default call and the float32
    (B,H,G) log-sum-exp over the valid prefix, within 2e-5 of a float64
    one (relative; bf16 inputs as the kernel reads them)."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32).to(dt)
               for s in ((2, 3, 2, 16), (2, 96, 3, 16), (2, 96, 3, 16)))
    out, lse = flash_decode(q, k, v, torch.tensor(L, dtype=torch.int32),
                            return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, 2)
    torch.testing.assert_close(out, flash_decode(q, k, v, L), rtol=0, atol=0)
    np.testing.assert_allclose(lse.numpy(), _lse64(q.float(), k.float(), L),
                               rtol=2e-5, atol=2e-5)


def test_flash_decode_empty_prefix_gives_zero_and_empty_lse(rng):
    """A shard with no valid row (cache_len = 0): out 0 (never the mean of
    V, never NaN) and lse -1e30, the kernel's definition."""
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
               for s in ((2, 2, 3, 16), (2, 8, 2, 16), (2, 8, 2, 16)))
    out, lse = flash_decode_ref(q, k, v, 0, return_lse=True)
    assert not out.any() and not out.isnan().any()
    assert (lse == -1e30).all()
    assert not flash_decode(q, k, v, torch.tensor(0, dtype=torch.int32)).any()


@pytest.mark.parametrize("L", [30, 64, 70])
def test_two_halves_combined_by_lse_equal_the_whole(L, rng):
    """The mesh's rule (``attention.combine_shards``: M = max lse, w =
    exp(lse - M), sum w·out / sum w) over the two 64-row halves of a
    128-row cache equals one call over the whole at 2e-5, also where the
    second half holds no valid row (L <= 64); without a mesh the rule is
    the identity."""
    B, S, H, G, D = 2, 128, 2, 3, 16
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
               for s in ((B, H, G, D), (B, S, H, D), (B, S, H, D)))
    want = flash_decode(q, k, v, L)
    parts = [flash_decode(q, k[:, i:i + 64].contiguous(),
                          v[:, i:i + 64].contiguous(),
                          torch.tensor(min(max(L - i, 0), 64),
                                       dtype=torch.int32), return_lse=True)
             for i in (0, 64)]
    lse = torch.stack([p[1] for p in parts])
    w = torch.exp(lse - lse.max(0).values)[..., None]
    got = sum(wi * p[0] for wi, p in zip(w, parts)) / w.sum(0)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    from repro_torch.models.attention import combine_shards
    for out, l in parts[:1]:           # one shard: the identity
        torch.testing.assert_close(combine_shards(out, l, ("model",)), out)
