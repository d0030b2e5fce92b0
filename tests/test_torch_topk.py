"""The port's rankings keep ``jax.lax.top_k``'s order: values descending,
and among equal values the lower index first. ``torch.topk`` leaves that
order open and, where equal values straddle the k-th place, may return
another set of indices. Equal scores are made exact in any summation
order: integer-valued scores, or candidates repeated row for row. Each
ranking is compared with the reference index for index, with k cutting
through a run of equal scores: the helper itself, DIN and DIEN
score_candidates, MIND and two-tower retrieve, the candidate scorer's
plain version and its kernel path's cross-block merge, and MoE routing
with tied router columns."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry
from repro.configs.other_archs import DIN
from repro.kernels.candidate_scorer.ops import \
    candidate_scorer as jax_candidate_scorer
from repro.models import moe as jax_moe
from repro.models.recsys import dien as jax_dien
from repro.models.recsys import din as jax_din
from repro.models.recsys import mind as jax_mind
from repro.models.recsys import towers as jax_towers
from repro.serve.bucketing import ShapeBucketer, compact_history, step_buckets
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.candidate_scorer import candidate_scorer
from repro_torch.kernels.candidate_scorer.ops import BLOCK_C, merge_blocks
from repro_torch.models import moe
from repro_torch.models.recsys import dien, din, mind, towers
from repro_torch.topk import ordered_topk, total_order_key


def _lax(x, k):
    v, i = jax.lax.top_k(jnp.asarray(x), k)
    return np.asarray(v), np.asarray(i)


def _same(got, want):
    """(values, indices) equal to the reference's, index for index."""
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))


def _tie_cut(v):
    """A k whose cut falls inside a run of at least three equal scores of
    the full ranking ``v`` (two of the run above the cut, the rest below)."""
    v = np.asarray(v)
    for s in range(len(v) - 2):
        if (s == 0 or v[s - 1] != v[s]) and v[s] == v[s + 1] == v[s + 2]:
            return s + 2
    raise AssertionError("no run of three equal scores to cut through")


# ------------------------------------------------------------- the helper

@pytest.mark.parametrize("n,k", [(64, 8), (64, 64), (100, 8), (100, 64),
                                 (1000, 64), (100_000, 8), (100_000, 64)])
def test_ordered_topk_matches_lax_top_k(n, k, rng):
    """Integer scores in {0..3}: long runs of exact ties at every cut."""
    x = rng.integers(0, 4, n).astype(np.float32)
    _same(ordered_topk(torch.as_tensor(x), k), _lax(x, k))


def test_ordered_topk_lower_index_first():
    x = np.zeros(5000, np.float32)
    x[[100, 4000, 2, 3000, 7]] = 1.0
    want = _lax(x, 3)
    assert want[1].tolist() == [2, 7, 100]
    _same(ordered_topk(torch.as_tensor(x), 3), want)


def test_ordered_topk_rows_match_lax_top_k(rng):
    x = rng.integers(-2, 3, (12, 9)).astype(np.float32)
    _same(ordered_topk(torch.as_tensor(x), 4), _lax(x, 4))


@pytest.mark.parametrize("k", [101, -1])
def test_ordered_topk_refuses_k_outside_the_input(k):
    """As lax.top_k and torch.topk do: a short or negative k is an error,
    never a ranking of fewer entries."""
    x = np.arange(100, dtype=np.float32)
    with pytest.raises(Exception):
        _lax(x, k)
    with pytest.raises(ValueError, match="must lie in"):
        ordered_topk(torch.as_tensor(x), k)


# ------------------------------------- signed zeros and NaN (total order)

#: float32 bit patterns: +-0, +-inf, a quiet NaN of either sign, small
#: integers; each is exact in bfloat16 and float16 as its upper 16 bits
_SPECIAL_BITS = np.array([0x00000000, 0x80000000, 0x7f800000, 0xff800000,
                          0x7fc00000, 0xffc00000, 0x3f800000, 0xbf800000,
                          0x40000000], np.uint32)
_DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
           "float64": (np.float64, torch.float64, jnp.float64),
           "bfloat16": (None, torch.bfloat16, jnp.bfloat16),
           "float16": (np.float16, torch.float16, jnp.float16)}


def _same_bits(bits32, dtype):
    """The same floats, bit for bit, as a torch tensor and a JAX array in
    ``dtype`` (torch's own cast of a NaN to bfloat16 sets its sign bit)."""
    np_t, torch_t, jax_t = _DTYPES[dtype]
    f32 = bits32.astype(np.uint32).view(np.float32)
    if dtype == "float32":
        return torch.as_tensor(f32), jnp.asarray(f32)
    if dtype == "float64":
        # JAX runs without x64 here: the reference ranks the float32
        # values, whose order the widening keeps (a NaN keeps its sign)
        return torch.as_tensor(f32.astype(np.float64)), jnp.asarray(f32)
    if dtype == "float16":
        f16 = f32.astype(np.float16)
        return torch.as_tensor(f16), jnp.asarray(f16)
    hi = (bits32.astype(np.uint32) >> 16).astype(np.uint16)
    return (torch.as_tensor(hi.view(np.int16)).view(torch.bfloat16),
            jnp.asarray(hi).view(jnp.bfloat16))


def _c1_case(name, rng):
    """(float32 bits, k): the roadmap's three cases of fault C-1, then
    random draws from the special values (runs of equal keys, both zeros,
    both NaNs, both infinities) with k through them."""
    f = np.float32
    if name == "zeros k=3":
        return np.array([0, -0.0, 0, -0.0, 1, -0.0, 0], f).view(np.uint32), 3
    if name == "zeros k=7":
        return np.array([0, -0.0, 0, -0.0, 1, -0.0, 0], f).view(np.uint32), 7
    if name == "nan k=2":
        return np.array([1, -np.nan, 2, np.nan, 3], f).view(np.uint32), 2
    n = int(name.split("n=")[1].split()[0])
    k = int(name.split("k=")[1])
    return _SPECIAL_BITS[rng.integers(0, _SPECIAL_BITS.size, n)], k


C1_CASES = ["zeros k=3", "zeros k=7", "nan k=2", "random n=64 k=8",
            "random n=64 k=64", "random n=1000 k=100", "random n=5000 k=5000"]


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("case", C1_CASES)
def test_ordered_topk_orders_signed_zeros_and_nan_as_lax(case, dtype, rng):
    """lax.top_k orders floats totally: +NaN above +inf, +0 above -0, -NaN
    below -inf, the lower index first among equal bits. ordered_topk
    returns its indices, index for index, and the same values bit for bit
    (the roadmap's fault C-1: a float sort tied the zeros and put every
    NaN first)."""
    bits, k = _c1_case(case, rng)
    x, xj = _same_bits(bits, dtype)
    v, i = ordered_topk(x, k)
    wv, wi = jax.lax.top_k(xj, k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    wv = np.asarray(wv)
    if dtype == "float64":
        wv = wv.astype(np.float64)
    as_int = {2: (torch.int16, np.uint16), 4: (torch.int32, np.uint32),
              8: (torch.int64, np.uint64)}[x.element_size()]
    np.testing.assert_array_equal(v.view(as_int[0]).numpy().view(as_int[1]),
                                  wv.view(as_int[1]))
    if case == "zeros k=3":
        assert i.tolist() == [4, 0, 2]
    if case == "nan k=2":
        assert i.tolist() == [3, 4]


def _special_cands(rng, C, pool=None):
    """C candidates whose score against the query (1,) is their one entry
    times 1: exactly the special value drawn, -0 and -NaN included."""
    pool = _SPECIAL_BITS if pool is None else pool
    bits = pool[rng.integers(0, pool.size, C)]
    return bits.view(np.float32).reshape(C, 1), np.ones(1, np.float32)


@pytest.mark.parametrize("C,k", [(64, 8), (64, 64), (300, 17), (300, 300)])
def test_candidate_scorer_plain_version_orders_non_finite_scores(C, k, rng):
    """B5's plain version (its CPU path) on -inf, NaN of either sign and
    signed-zero scores: lax.top_k's indices over the same scores, every
    one a real row (fault C-2's card-side counterpart is held in
    chip_smoke.py)."""
    cands, q = _special_cands(rng, C)
    scores = (torch.as_tensor(cands) @ torch.as_tensor(q)).numpy()
    # a product summed from +0 never ends at -0: a -0 entry scores +0
    bits = scores.view(np.uint32)
    assert {0x00000000, 0x7fc00000, 0xffc00000, 0xff800000} <= set(
        bits.tolist())
    v, i = candidate_scorer(torch.as_tensor(cands), torch.as_tensor(q), k)
    wv, wi = _lax(scores, k)
    np.testing.assert_array_equal(i.numpy(), wi)
    np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                  wv.view(np.uint32))
    assert (i.numpy() >= 0).all()


@pytest.mark.parametrize("C,k,pool", [
    (3000, 8, "all"), (1025, 1025, "all"), (1100, 200, "all"),
    (2100, 64, "-inf and -nan"), (1030, 40, "-nan")])
def test_candidate_scorer_merge_orders_non_finite_scores(C, k, pool, rng):
    """The kernel path's cross-block merge on -inf / NaN / signed-zero
    scores: each block's winners as the kernel writes them (its ordered
    top-k, a block of fewer than k rows padded with (-inf, -1)), merged,
    equal to lax.top_k over every score index for index. A padded slot
    ranks below every row, -NaN rows included, so no -1 comes back."""
    pools = {"all": _SPECIAL_BITS,
             "-inf and -nan": np.array([0xff800000, 0xffc00000], np.uint32),
             "-nan": np.array([0xffc00000], np.uint32)}
    cands, q = _special_cands(rng, C, pools[pool])
    scores = torch.as_tensor(cands) @ torch.as_tensor(q)
    vals, idx = [], []
    for b0 in range(0, C, BLOCK_C):
        v, i = ordered_topk(scores[b0:b0 + BLOCK_C], min(k, scores[b0:b0 + BLOCK_C].numel()))
        pad = k - v.numel()
        vals.append(torch.cat((v, torch.full((pad,), -torch.inf))))
        idx.append(torch.cat((i + b0, torch.full((pad,), -1))))
    got = _merge(vals, idx, k)
    wv, wi = _lax(scores.numpy(), k)
    np.testing.assert_array_equal(got[1].numpy(), wi)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  wv.view(np.uint32))
    assert (got[1].numpy() >= 0).all()


# ---------------------------------------------------------- the rankings

def _to_jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(
        a.astype(np.int32) if a.dtype.kind in "iu" else a), tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return torch.as_tensor(a, dtype=torch.int64 if a.dtype.kind in "iu"
                           else torch.float32)


def _reduced(arch_id):
    arch = registry.get(arch_id)
    return arch.reduced(arch.config)


def _din_paper_vocab_1024():
    return dataclasses.replace(
        DIN, user_fields=tuple(dataclasses.replace(f, vocab=1024)
                               for f in DIN.user_fields),
        item_fields=tuple(dataclasses.replace(f, vocab=1024)
                          for f in DIN.item_fields))


#: (reference module, port module, ranking function, config)
MODELS = {
    "din-reduced": (jax_din, din, "score_candidates",
                    lambda: _reduced("din")),
    "din-paper_vocab1024": (jax_din, din, "score_candidates",
                            _din_paper_vocab_1024),
    "dien-reduced": (jax_dien, dien, "score_candidates",
                     lambda: _reduced("dien")),
    "mind-reduced": (jax_mind, mind, "retrieve", lambda: _reduced("mind")),
    "two_tower-reduced": (jax_towers, towers, "retrieve",
                          lambda: _reduced("two-tower-retrieval")),
}


@functools.lru_cache(maxsize=None)
def _model(name):
    """(cfg, reference module, port module, ranking function, reference
    params, port params): the same weights in both."""
    jmod, tmod, fn, make = MODELS[name]
    cfg = make()
    ref = jmod.init(jax.random.PRNGKey(0), cfg)
    port = params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    return cfg, jmod, tmod, fn, ref, port


def _tied_request(cfg, rng, C, rows=8):
    """One user and C candidates drawn from ``rows`` distinct candidate
    rows (every item field repeated together), so that repeated rows
    score bit for bit alike."""
    user = {"fields": {f.name: rng.integers(0, f.vocab, (1,) if f.bag == 1
                                            else (1, f.bag))
                       for f in cfg.user_fields}}
    if cfg.seq_len:
        hist = np.full(cfg.seq_len, -1, np.int64)
        n = max(1, cfg.seq_len - 3)
        hist[:n] = rng.integers(0, cfg.item_fields[0].vocab, n)
        user["hist"] = compact_history(
            hist, ShapeBucketer(step_buckets(cfg.seq_len)))[None]
    distinct = {"item_id": rng.permutation(cfg.item_fields[0].vocab)[:rows]}
    for f in cfg.item_fields[1:]:
        distinct[f.name] = rng.integers(0, f.vocab, (rows,) if f.bag == 1
                                        else (rows, f.bag))
    pick = rng.integers(0, rows, C)
    return user, {k: v[pick] for k, v in distinct.items()}


def _rank(mod, fn, params, user, cand, cfg, k, to, **kw):
    u = user["fields"] if cfg.model == "two_tower" else user
    return getattr(mod, fn)(params, to(u), to(cand), cfg, top_k=k, **kw)


@pytest.mark.parametrize("name,path", [(n, "default") for n in sorted(MODELS)]
                         + [("din-reduced", "jnp"),
                            ("din-paper_vocab1024", "jnp")])
def test_rankings_keep_the_reference_tie_order(name, path, rng):
    """The full ranking and a top-k cut inside a run of equal scores,
    index for index with the reference (values within 2e-5); DIN also on
    its broadcast path."""
    cfg, jmod, tmod, fn, ref, port = _model(name)
    kw = {} if path == "default" else {"path": "jnp"}
    C = 64
    user, cand = _tied_request(cfg, rng, C)
    v_ref, i_ref = (np.asarray(a) for a in _rank(
        jmod, fn, ref, user, cand, cfg, C, _to_jax, **kw))
    v, i = _rank(tmod, fn, port, user, cand, cfg, C, _to_torch, **kw)
    k = _tie_cut(v_ref)
    assert len(set(v_ref[k - 2:k + 1].tolist())) == 1   # the cut's power
    np.testing.assert_array_equal(i.numpy(), i_ref)
    np.testing.assert_allclose(v.numpy(), v_ref, rtol=2e-5, atol=2e-5)
    vk, ik = _rank(tmod, fn, port, user, cand, cfg, k, _to_torch, **kw)
    _, ik_ref = _rank(jmod, fn, ref, user, cand, cfg, k, _to_jax, **kw)
    np.testing.assert_array_equal(ik.numpy(), np.asarray(ik_ref))
    np.testing.assert_array_equal(vk.numpy(), v.numpy()[:k])


# ------------------------------------------------------ candidate scorer

def _integer_cands(rng, C, D, rows):
    """C candidates drawn from ``rows`` distinct integer rows and an
    integer query: every score is an integer, exact in any order."""
    base = rng.integers(-2, 3, (rows, D)).astype(np.float32)
    return base[rng.integers(0, rows, C)], \
        rng.integers(-2, 3, D).astype(np.float32)


@pytest.mark.parametrize("C,k", [(64, 10), (300, 8), (300, 300)])
def test_candidate_scorer_plain_version_keeps_the_tie_order(C, k, rng):
    """The CPU path (the plain version) against the reference kernel
    (interpret mode) and lax.top_k over the scores."""
    cands, q = _integer_cands(rng, C, 16, rows=6)
    got = candidate_scorer(torch.as_tensor(cands), torch.as_tensor(q), k)
    want = _lax(cands @ q, k)
    _same(got, want)
    _same(got, jax_candidate_scorer(jnp.asarray(cands), jnp.asarray(q), k=k,
                                    interpret=True))


def _block_rank(vals, idx):
    """The kernel's rank of each block winner (``rank_of`` in
    candidate_scorer.cu): the score's total-order key in the high 32 bits,
    the index's complement in the low 32; an empty slot (index -1) the
    least int64."""
    key = total_order_key(vals.float()).long()
    return ((key << 32) | ((~idx) & 0xFFFFFFFF)).masked_fill(
        idx < 0, torch.iinfo(torch.int64).min)


def _merge(vals, idx, k):
    vals, idx = torch.cat(vals), torch.cat(idx)
    return merge_blocks(_block_rank(vals, idx), vals, idx, k)


@pytest.mark.parametrize("C,k", [(2048, 64), (4096, 200), (3000, 8)])
def test_candidate_scorer_merge_keeps_the_tie_order(C, k, rng):
    """The kernel path's cross-block merge: each block's winners as the
    kernel writes them (its own top-k in lax order, block by block), merged,
    index for index with lax.top_k over every score and with the
    reference's blocked kernel and merge (interpret mode)."""
    cands, q = _integer_cands(rng, C, 8, rows=5)
    scores = torch.as_tensor(cands @ q)
    vals, idx = [], []
    for b0 in range(0, C, BLOCK_C):
        v, i = ordered_topk(scores[b0:b0 + BLOCK_C], k)
        v = torch.cat((v, torch.full((k - v.numel(),), -torch.inf)))
        i = torch.cat((i + b0, torch.zeros(k - i.numel(), dtype=i.dtype)))
        vals.append(v)
        idx.append(i)
    got = _merge(vals, idx, k)
    _same(got, _lax(cands @ q, k))
    _same(got, jax_candidate_scorer(jnp.asarray(cands), jnp.asarray(q), k=k,
                                    interpret=True))


# ------------------------------------------------------------------- MoE

def test_moe_routing_keeps_the_tie_order(rng):
    """Router columns repeated and integer tokens: experts tie exactly in
    every token's probabilities; the port routes each token to the same
    experts in the same order as the reference, and the layer's output
    agrees (a different routing would move it by O(1))."""
    cfg = _reduced("deepseek-v2-lite-16b").moe
    ref = jax_moe.moe_expert_init(jax.random.PRNGKey(3), 32, cfg, jnp.float32)
    cols = rng.integers(-1, 2, (32, 3)).astype(np.float32)
    router = cols[:, rng.integers(0, 3, cfg.n_routed)]
    ref = dict(ref, router=jnp.asarray(router))
    port = params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    x = rng.integers(-1, 2, (40, 32)).astype(np.float32)
    gate_ref, idx_ref, _ = jax_moe._route(jnp.asarray(x), ref["router"],
                                          cfg.top_k)
    gate, idx, _ = moe._route(torch.as_tensor(x), port["router"], cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(gate.numpy(), np.asarray(gate_ref),
                               rtol=2e-6, atol=2e-6)
    got, _ = moe.moe_apply(port, torch.as_tensor(x[None]), cfg, "silu")
    want, _ = jax_moe.moe_apply(ref, jnp.asarray(x[None]), cfg, "silu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# ------------------------------------------------------------ short k

def test_rankings_refuse_more_places_than_candidates(rng):
    """A ranking asked for more places than it has candidates raises, on
    the reference and on the port's CPU path alike."""
    cfg, jmod, tmod, fn, ref, port = _model("din-reduced")
    user, cand = _tied_request(cfg, rng, 16)
    with pytest.raises(Exception):
        _rank(jmod, fn, ref, user, cand, cfg, 17, _to_jax)
    with pytest.raises(ValueError, match="must lie in"):
        _rank(tmod, fn, port, user, cand, cfg, 17, _to_torch)
    cands, q = _integer_cands(rng, 16, 8, rows=4)
    with pytest.raises(ValueError, match="must lie in"):
        candidate_scorer(torch.as_tensor(cands), torch.as_tensor(q), 17)


# ------------------------------------------- the cross-rank merge (C-1's)

#: the special values every merge case draws among ordinary ties: ±0,
#: ±NaN (quiet, sign bit set and clear) and ±inf, as float32 bit patterns
SPECIAL_F32 = np.array([0x00000000, 0x80000000, 0x7FC00000, 0xFFC00000,
                        0x7F800000, 0xFF800000], np.uint32)
SPECIAL_BF16 = np.array([0x0000, 0x8000, 0x7FC0, 0xFFC0, 0x7F80, 0xFF80],
                        np.uint16)


def _merge_draw(rng, n, dtype):
    """n scores as bit patterns of ``dtype`` (float32 or bfloat16): a few
    ordinary values repeated (ties), the special ones among them."""
    if dtype == "float32":
        plain = np.array([1.5, -2.0, 0.25, 3.0], np.float32).view(np.uint32)
        pool = np.concatenate([SPECIAL_F32, plain])
    else:
        plain = np.array([0x3FC0, 0xC000, 0x3E80, 0x4040], np.uint16)
        pool = np.concatenate([SPECIAL_BF16, plain])
    return pool[rng.integers(0, len(pool), n)]


def _as_jax(bits, dtype):
    import ml_dtypes
    if dtype == "float32":
        return jnp.asarray(bits.view(np.float32))
    return jnp.asarray(bits.view(ml_dtypes.bfloat16))


def _as_torch(bits, dtype):
    if dtype == "float32":
        return torch.from_numpy(bits.view(np.int32).copy()).view(torch.float32)
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_blocks", range(1, 9))
def test_merge_over_blocks_equals_lax_top_k_on_special_values(dtype,
                                                              n_blocks):
    """``topk.merge_topk`` over a vector split into 1-8 blocks as
    ``merge_over_mesh`` splits and pads it (``runtime.block``'s equal
    blocks of the length padded to a multiple; each block's own
    ``ordered_topk`` of its valid part, padded to k with index -1 and its
    indices made global): index for index, and bit for bit in value, the
    reference's ``lax.top_k`` of the whole vector, on ±0, ±NaN, ±inf and
    ties, in float32 and in bfloat16 built from the same bits."""
    from repro_torch.topk import merge_topk
    rng = np.random.default_rng(100 + n_blocks)
    for _ in range(12):
        n = int(rng.integers(1, 61))
        k = int(rng.integers(1, n + 1))
        bits = _merge_draw(rng, n, dtype)
        want_v, want_i = jax.lax.top_k(_as_jax(bits, dtype), k)
        x = _as_torch(bits, dtype)
        per = -(-n // n_blocks)
        vals, idxs = [], []
        for b in range(n_blocks):
            start = b * per
            valid = max(0, min(per, n - start))
            v, i = ordered_topk(x[start:start + valid], min(k, valid))
            pad = k - v.shape[-1]
            vals.append(torch.nn.functional.pad(v, (0, pad)))
            idxs.append(torch.nn.functional.pad(i + start, (0, pad),
                                                value=-1))
        got_v, got_i = merge_topk(torch.cat(vals), torch.cat(idxs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        want_bits = np.asarray(want_v).view(
            np.uint32 if dtype == "float32" else np.uint16)
        np.testing.assert_array_equal(_bits(got_v), want_bits)
