"""The grouped embedding bag: all of one model call's table lookups in one
call (``embedding_bag_group``; on the card one launch).

  * its plain version against the reference's per-field lookups
    (``repro.sparse.sharded.sharded_embedding_bag_2d``, concatenated as
    ``repro``'s ``embed_fields`` concatenates them) on mixed bag widths,
    combiners, weights and bag counts, zero bags and the most groups a
    launch takes included, in float32 (2e-5) and bfloat16 (2e-2);
  * ``embed_fields`` against the reference's on the same tables and ids;
  * every model call of the port makes exactly one grouped lookup: DIN and
    DIEN ``logits_fn`` / ``score_candidates``, MIND ``serve_scores`` /
    ``retrieve``, two-tower ``user_vec`` / ``item_vec``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry
from repro.models.recsys import common as jax_common
from repro.sparse.sharded import sharded_embedding_bag_2d as jax_bag_2d
from repro_torch.configs import registry as torch_registry
from repro_torch.convert import params_from_numpy
from repro_torch.data import synthetic
from repro_torch.kernels.embedding_bag import (embedding_bag_group,
                                               embedding_bag_group_ref)
from repro_torch.kernels.embedding_bag.ops import MAX_GROUPS
from repro_torch.models.recsys import common, dien, din, mind, towers
from repro_torch.sparse import sharded

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: groups as (vocab, bags, bag width, weighted, combiner), split into
#: blocks of equal bag counts
CASES = {
    "din micro-batch": ([(1000, 16 * 20, 1, False, "sum"),
                         (1000, 16, 1, False, "sum"),
                         (700, 16, 1, False, "sum"),
                         (300, 16, 4, False, "sum"),
                         (300, 16, 1, False, "sum")], (1, 4)),
    "re-rank": ([(1000, 20, 1, False, "sum"), (700, 1, 1, False, "sum"),
                 (300, 1, 4, True, "sum"), (300, 64, 1, False, "sum")],
                (1, 2, 1)),
    "two-tower user": ([(900, 3, 1, False, "sum"), (800, 3, 50, False, "mean"),
                        (50, 3, 1, False, "sum"), (600, 3, 8, True, "sum")],
                       (4,)),
    "zero bags": ([(100, 5, 3, True, "mean"), (100, 0, 2, False, "sum"),
                   (100, 7, 1, False, "mean")], None),
    "most groups": ([(200 + j, 9, 1 + j, j % 2 == 1, ("sum", "mean")[j % 2])
                     for j in range(MAX_GROUPS)], (3, 5)),
    "all-zero weights": ([(64, 4, 3, "zero", "mean"), (64, 4, 3, "zero",
                                                      "sum")], (2,)),
}


def _case(name, D, dtype, rng):
    """The same tables, ids and weights for the port (torch) and the
    reference (JAX), with ids past either end of the table (clipped)."""
    groups, blocks = CASES[name]
    port, ref = [], []
    for vocab, bags, width, weighted, comb in groups:
        table = (rng.normal(size=(vocab, D)) * 0.5).astype(np.float32)
        ids = rng.integers(-3, vocab + 3, (bags, width))
        w = None
        if weighted == "zero":
            w = np.zeros((bags, width), np.float32)
        elif weighted:
            w = (rng.random((bags, width))
                 * (rng.random((bags, width)) > 0.2)).astype(np.float32)
        port.append((torch.as_tensor(table).to(_TORCH[dtype]),
                     torch.as_tensor(ids),
                     None if w is None else torch.as_tensor(w), comb))
        ref.append((jnp.asarray(table).astype(_JAX[dtype]),
                    jnp.asarray(ids.astype(np.int32)),
                    None if w is None else jnp.asarray(w), comb))
    return port, ref, blocks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [18, 256])
@pytest.mark.parametrize("name", list(CASES))
def test_group_plain_version_matches_the_reference_per_field(name, D, dtype,
                                                             rng):
    """Each returned block equals the reference's per-field lookups of its
    groups, concatenated along columns."""
    port, ref, blocks = _case(name, D, dtype, rng)
    got = embedding_bag_group(port, blocks)
    want = [jax_bag_2d(t, i, w, combiner=c) for t, i, w, c in ref]
    blocks = (1,) * len(port) if blocks is None else blocks
    assert len(got) == len(blocks)
    at = 0
    for out, n in zip(got, blocks):
        cat = jnp.concatenate(want[at:at + n], axis=-1)
        assert out.dtype == _TORCH[dtype]
        assert tuple(out.shape) == cat.shape
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(cat.astype(jnp.float32)),
                                   **TOL[dtype])
        at += n
    for out, ref_out in zip(got, embedding_bag_group_ref(port, blocks)):
        torch.testing.assert_close(out, ref_out, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["din", "dien", "mind",
                                  "two-tower-retrieval"])
def test_embed_fields_matches_the_reference(arch, rng):
    """The port's embed_fields (one grouped lookup) against the
    reference's (one lookup per field, concatenated) on a reduced config's
    tables and ids, user and item fields."""
    a = registry.get(arch)
    cfg = a.reduced(a.config)
    tables = jax_common.tables_init(jax.random.PRNGKey(1), cfg)
    port_tables = params_from_numpy(jax.tree.map(np.asarray, tables), "cpu")
    for fields in (cfg.user_fields, cfg.item_fields):
        ids = synthetic_ids(rng, fields, 6)
        want = jax_common.embed_fields(tables, fields, {
            k: jnp.asarray(v.astype(np.int32)) for k, v in ids.items()})
        got = common.embed_fields(port_tables, fields, {
            k: torch.as_tensor(v) for k, v in ids.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL["float32"])


def synthetic_ids(rng, fields, B):
    return {f.name: rng.integers(0, f.vocab, (B,) if f.bag == 1
                                 else (B, f.bag)) for f in fields}


# ------------------------------------------------ one lookup per model call

def _to(tree):
    if isinstance(tree, dict):
        return {k: _to(v) for k, v in tree.items()}
    t = torch.as_tensor(np.asarray(tree))
    return t if t.is_floating_point() else t.long()


def _setup(arch):
    a = torch_registry.get(arch)
    cfg = a.reduced(a.config)
    mod = {"din": din, "dien": dien, "mind": mind,
           "two_tower": towers}[cfg.model]
    params = mod.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = _to(synthetic.recsys_batch(rng, cfg, 4))
    user = {"fields": {k: v[:1] for k, v in batch["user"]["fields"].items()}}
    if cfg.seq_len:
        user["hist"] = batch["user"]["hist"][:1]
    cand = _to({f.name: rng.integers(0, f.vocab, (8,) if f.bag == 1
                                     else (8, f.bag))
                for f in cfg.item_fields})
    return cfg, mod, params, batch, user, cand


CALLS = {
    "din.logits_fn": ("din", lambda m, p, b, u, c, cfg:
                      m.logits_fn(p, b, cfg), 1),
    "din.score_candidates": ("din", lambda m, p, b, u, c, cfg:
                             m.score_candidates(p, u, c, cfg, top_k=4), 1),
    "din.score_candidates jnp path": (
        "din", lambda m, p, b, u, c, cfg:
        m.score_candidates(p, u, c, cfg, top_k=4, path="jnp"), 1),
    "dien.logits_fn": ("dien", lambda m, p, b, u, c, cfg:
                       m.logits_fn(p, b, cfg), 1),
    "dien.score_candidates": ("dien", lambda m, p, b, u, c, cfg:
                              m.score_candidates(p, u, c, cfg, top_k=4), 1),
    "mind.serve_scores": ("mind", lambda m, p, b, u, c, cfg:
                          m.serve_scores(p, b, cfg), 1),
    "mind.retrieve": ("mind", lambda m, p, b, u, c, cfg:
                      m.retrieve(p, u, c, cfg, top_k=4), 1),
    "towers.user_vec": ("two-tower-retrieval", lambda m, p, b, u, c, cfg:
                        m.user_vec(p, u["fields"], cfg), 1),
    "towers.item_vec": ("two-tower-retrieval", lambda m, p, b, u, c, cfg:
                        m.item_vec(p, b["item"], cfg), 1),
    "towers.retrieve": ("two-tower-retrieval", lambda m, p, b, u, c, cfg:
                        m.retrieve(p, u["fields"], c, cfg, top_k=4), 1),
    "towers.serve_scores": ("two-tower-retrieval", lambda m, p, b, u, c, cfg:
                            m.serve_scores(p, b, cfg), 2),
}


@pytest.mark.parametrize("call", list(CALLS))
def test_each_model_call_makes_one_grouped_lookup(call, monkeypatch):
    """One grouped lookup per model call (two for two-tower's paired
    serve_scores: its user and its item tower), and no per-field lookup:
    on the card, one embedding_bag launch where the reference's per-field
    lookups made up to five."""
    arch, fn, want = CALLS[call]
    cfg, mod, params, batch, user, cand = _setup(arch)
    calls, per_field = [], []

    def grouped(lookups, blocks=None):
        calls.append(len(lookups))
        return embedding_bag_group(lookups, blocks)

    def single(*a, **k):
        per_field.append(a)
        raise AssertionError("a per-field lookup on a model path")
    monkeypatch.setattr(sharded, "embedding_bag_group", grouped)
    monkeypatch.setattr(sharded, "embedding_bag_padded", single)
    fn(mod, params, batch, user, cand, cfg)
    assert len(calls) == want and not per_field
    assert all(1 <= n <= MAX_GROUPS for n in calls)


def test_sharded_group_takes_single_ids_and_refuses_a_mesh(rng):
    """``sharded_embedding_bag_group`` reads (B,) ids as bags of one, as
    ``sharded_embedding_bag_2d`` does, on one device and on a 2x2 mesh of
    gloo ranks (its collective path; it no longer refuses a mesh): there
    ``embed_fields`` over single-id and multi-hot sum / mean fields equals
    the reference's ``embed_fields`` on one device, in one all_gather, one
    reduce_scatter and one all_reduce."""
    from repro_torch.launch.mesh import Job, run_jobs
    from repro_torch.launch.sharding import P, Table
    table = torch.as_tensor(rng.normal(size=(10, 4)).astype(np.float32))
    ids = torch.as_tensor(rng.integers(0, 10, 6))
    got, = sharded.sharded_embedding_bag_group([(table, ids, None, "sum")])
    torch.testing.assert_close(got, sharded.sharded_embedding_bag_2d(table,
                                                                     ids))
    cfg, port_cfg = (reg.get("din").reduced(reg.get("din").config)
                     for reg in (registry, torch_registry))
    fields = cfg.user_fields + cfg.item_fields
    tables = {f.name: rng.normal(size=(f.vocab, cfg.embed_dim)).astype(
        np.float32) for f in fields}
    ids = synthetic.recsys_ids(rng, fields, 8)
    want = np.asarray(jax_common.embed_fields(
        {k: jnp.asarray(v) for k, v in tables.items()}, fields,
        {k: jnp.asarray(v.astype(np.int32)) for k, v in ids.items()}))
    big = ("data", "model")
    job = Job("repro_torch.models.recsys.common:embed_fields", tables,
              {k: Table(big, None) for k in tables},
              (port_cfg.user_fields + port_cfg.item_fields, ids),
              (None, {k: P("data") if v.ndim == 1 else P("data", None)
                      for k, v in ids.items()}),
              out_specs=P("data", None))
    for rank in run_jobs([job], (2, 2), timeout=150):
        np.testing.assert_allclose(rank[0]["out"], want, **TOL["float32"])
        assert {k: n for (k, _), (n, _) in rank[0]["collectives"].items()} \
            == {"all_gather": 1, "reduce_scatter": 1, "all_reduce": 1}