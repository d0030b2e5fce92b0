"""The port's device mesh against the reference's, on the CPU:

  * every cell's ``in_specs`` / ``out_specs`` (``param_specs``,
    ``zero_specs``, ``opt_state_specs``, ``kv_cache_specs``,
    ``batched_spec``, ``edge_spec`` as the cells use them) and its
    ``model_bytes_per_device``, leaf for leaf, for every registered arch ×
    shape at the meshes (2, 4), (16, 16) and (2, 16, 16) — the
    reference's on an abstract mesh, nothing allocated;
  * the sparse collectives on gloo ranks (``launch.mesh.run_jobs``: one
    launch per mesh serves many cases) at (2, 2), (2, 4) and (1, 4)
    against the reference's own mesh run (a subprocess with 8 forced host
    devices, as ``tests/test_distributed.py`` runs it): ``sharded_lookup``,
    ``sharded_gather_a2a`` with its overflow zeros,
    ``sharded_embedding_bag_2d`` (sum, mean, weights, a bf16 comm_dtype, a
    batch that does not scatter, single ids), ``sharded_row_update`` with
    ids on every shard edge (no wraparound), at the reference's
    tolerances (rtol 1e-5 / 1e-6; 2e-2 for the bf16 collective);
  * DIN (serve_scores, both score_candidates paths), DIEN, MIND and
    two-tower at reduced widths on a 2×2 mesh against the reference on one
    device with the same weights: 2e-5, rankings index for index; the
    grouped lookup of a model call is one all_gather, one reduce_scatter
    and one all_reduce;
  * every kernel call of a rank's model call, recorded and replayed
    (``Job.check_kernels``): on the rank's own table shards, the
    wrapper's outputs equal the plain version's;
  * ``run_cell("din", "serve_p99", mesh=(2, 2), device="cpu",
    reduced=True)`` records ``ok`` and its collectives, and its output
    equals the cell run whole (the counterpart of
    ``test_dryrun_reduced_mesh_cells``); with ``check_kernels`` each
    rank's kernel calls come back replayed;
  * the retrieval cells keep the reference's specs and draw their
    candidates whole on a rank.
"""
import contextlib
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import registry as jax_registry
from repro.launch import specs as jax_specs
from repro.models.recsys import dien as jax_dien
from repro.models.recsys import din as jax_din
from repro.models.recsys import mind as jax_mind
from repro.models.recsys import towers as jax_towers
from repro.data import synthetic as jax_synthetic
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.launch import dryrun, sharding, specs
from repro_torch.launch.mesh import Job, abstract_mesh, run_jobs
from repro_torch.launch.sharding import P, Table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_MESHES = {"2x4": ((2, 4), ("data", "model")),
               "16x16": ((16, 16), ("data", "model")),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ALL_CELLS = [(a.arch_id, s.name) for a in jax_registry.ARCHS.values()
             for s in a.shapes]
TOL = dict(rtol=2e-5, atol=2e-5)
BIG = ("data", "model")


# ------------------------------------------------------------ spec rules

def _canon(entry):
    """A spec entry with one-name tuples read as the name (JAX treats
    ``("data",)`` and ``"data"`` alike)."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = {}
    for path, spec in flat:
        names = [str(getattr(k, "key", getattr(k, "name",
                                                 getattr(k, "idx", k))))
                 for k in path]
        out["/".join(names)] = tuple(_canon(e) for e in spec)
    return out


def _port_flat(tree, prefix=()):
    if isinstance(tree, P):
        return {"/".join(prefix): tuple(_canon(e) for e in tree)}
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    else:
        items = [(str(i), v) for i, v in enumerate(tree)]
    out = {}
    for k, v in items:
        out.update(_port_flat(v, prefix + (k,)))
    return out


@pytest.mark.parametrize("mesh_name", sorted(SPEC_MESHES))
@pytest.mark.parametrize("arch_id,shape_name", ALL_CELLS)
def test_cell_specs_equal_reference(arch_id, shape_name, mesh_name):
    shape, axes = SPEC_MESHES[mesh_name]
    ref = jax_specs.build_cell(arch_id, shape_name, AbstractMesh(shape, axes))
    port = specs.build_cell(arch_id, shape_name,
                            mesh=abstract_mesh(shape, axes))
    ref_in, port_in = list(ref.in_specs), list(port.in_specs)
    if (arch_id, shape_name) == ("two-tower-retrieval", "retrieval_cand"):
        # the port's retrieval cell hands two-tower {"fields": ...}, as it
        # hands every recsys model its user batch
        port_in[1] = port_in[1]["fields"]
    for got, want in zip(port_in + [port.out_specs],
                         ref_in + [ref.out_specs]):
        assert _port_flat(got) == _ref_flat(want)
    assert port.meta["model_bytes_per_device"] == pytest.approx(
        ref.meta["model_bytes_per_device"], rel=1e-12)


@pytest.mark.parametrize("mesh_name", sorted(SPEC_MESHES))
def test_input_rules_equal_reference(mesh_name):
    from repro.launch import sharding as jax_shr
    shape, axes = SPEC_MESHES[mesh_name]
    ref_mesh, mesh = AbstractMesh(shape, axes), abstract_mesh(shape, axes)
    for dims in [(1,), (7, 3), (16,), (32, 4), (512, 100), (1, 1)]:
        for extra in (None, 0, 1):
            assert tuple(map(_canon, sharding.batched_spec(mesh, dims, extra))) \
                == tuple(map(_canon, jax_shr.batched_spec(ref_mesh, dims, extra)))
    for ndim in (1, 2, 3):
        assert tuple(map(_canon, sharding.edge_spec(mesh, ndim))) == \
            tuple(map(_canon, jax_shr.edge_spec(ref_mesh, ndim)))
    assert sharding.data_size(mesh) == jax_shr.data_size(ref_mesh)
    assert sharding.batch_axes_of(mesh) == jax_shr.batch_axes_of(ref_mesh)
    for arch_id in ("smollm-135m", "deepseek-v3-671b", "qwen3-8b"):
        cfg = registry.get(arch_id).config
        ref_cfg = jax_registry.get(arch_id).config
        for batch in (1, 3, 32, 128):
            got = sharding.kv_cache_specs(cfg, batch, mesh)
            want = jax_shr.kv_cache_specs(ref_cfg, batch, ref_mesh)
            assert [tuple(map(_canon, s)) for s in got] == \
                [tuple(map(_canon, s)) for s in want]


@pytest.mark.parametrize("mesh_name", [None, "1x1", "2x4", "16x16", "2x16x16"])
def test_runtime_helpers_equal_reference(mesh_name):
    """``axis_size``, ``has_axis``, ``batch_axes``, ``data_axis_size``,
    ``pad_to_multiple`` and ``divides`` give the reference's values with
    no mesh and under each mesh (the reference's rules read only
    ``mesh.shape``, so its stack holds an abstract mesh here)."""
    from repro import runtime as jax_runtime
    from repro_torch import runtime
    from repro_torch.launch.mesh import make_production_mesh
    shape, axes = SPEC_MESHES.get(mesh_name, ((1, 1), BIG))
    port_mesh = None if mesh_name is None else abstract_mesh(shape, axes)
    ref_mesh = None if mesh_name is None else AbstractMesh(shape, axes)
    if mesh_name in ("16x16", "2x16x16"):
        prod = make_production_mesh(multi_pod=mesh_name == "2x16x16")
        assert prod.shape == port_mesh.shape and prod.abstract
    if ref_mesh is not None:
        jax_runtime._MESH_STACK.append(ref_mesh)
    try:
        with runtime.use_mesh(port_mesh) if port_mesh is not None \
                else contextlib.nullcontext():
            for name in ("pod", "data", "model", "other"):
                assert runtime.axis_size(name) == jax_runtime.axis_size(name)
                assert runtime.has_axis(name) == jax_runtime.has_axis(name)
                for n in (1, 6, 16, 256, 512):
                    assert runtime.divides(n, name) == \
                        jax_runtime.divides(n, name)
            assert runtime.batch_axes() == jax_runtime.batch_axes()
            assert runtime.data_axis_size() == jax_runtime.data_axis_size()
            for n, m in ((7, 4), (8, 4), (0, 3), (513, 256)):
                assert runtime.pad_to_multiple(n, m) == \
                    jax_runtime.pad_to_multiple(n, m)
    finally:
        if ref_mesh is not None:
            jax_runtime._MESH_STACK.pop()


def test_local_part_and_gather_full_are_inverse_on_an_abstract_layout():
    """``local_part`` over every rank of a (2, 2) mesh tiles the whole,
    in the reference's flat-index order."""
    from repro_torch.launch.mesh import Mesh
    x = torch.arange(8 * 6).reshape(8, 6)
    for spec in (P(BIG, None), P("data", "model"), P(None, "model"),
                 P(("data",), None)):
        blocks = {}
        for rank in range(4):
            part = sharding.local_part(x, spec, Mesh((2, 2), BIG, rank=rank))
            blocks[rank] = part
        if spec == P(BIG, None):
            assert torch.equal(torch.cat([blocks[r] for r in range(4)]), x)
        if spec == P("data", "model"):
            top = torch.cat([blocks[0], blocks[1]], 1)
            bottom = torch.cat([blocks[2], blocks[3]], 1)
            assert torch.equal(torch.cat([top, bottom]), x)
    with pytest.raises(ValueError):
        sharding.local_part(torch.zeros(6, 2), P(BIG, None),
                            Mesh((2, 2), BIG, rank=0))


# ------------------------------------------------- the reference on a mesh

REF_SCRIPT = """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from repro import runtime
    from repro.launch.mesh import make_mesh
    from repro.sparse.sharded import (sharded_lookup, sharded_gather_a2a,
                                      sharded_embedding_bag_2d,
                                      sharded_row_update)
    d = dict(np.load(sys.argv[1]))
    out = {}
    for name, shape in (("2x2", (2, 2)), ("2x4", (2, 4))):
        mesh = make_mesh(shape, ("data", "model"))
        t = jnp.asarray(d["table"])
        with runtime.use_mesh(mesh):
            out[name + "/lookup"] = jax.jit(sharded_lookup)(
                t, jnp.asarray(d["ids2"]))
            out[name + "/a2a"] = jax.jit(sharded_gather_a2a)(
                t, jnp.asarray(d["flat"]))
            out[name + "/a2a_overflow"] = jax.jit(
                lambda t, i: sharded_gather_a2a(t, i, cap_factor=1.0))(
                t, jnp.asarray(d["over_" + name]))
            for comb in ("sum", "mean"):
                out[name + "/bag_" + comb] = jax.jit(
                    lambda t, i, w: sharded_embedding_bag_2d(
                        t, i, w, comb))(t, jnp.asarray(d["bag_ids"]),
                                        jnp.asarray(d["bag_w"]))
            out[name + "/bag_bf16"] = jax.jit(
                lambda t, i: sharded_embedding_bag_2d(
                    t, i, None, "mean", comm_dtype=jnp.bfloat16))(
                t, jnp.asarray(d["bag_ids"]))
            out[name + "/bag_noscatter"] = jax.jit(
                lambda t, i: sharded_embedding_bag_2d(t, i))(
                t, jnp.asarray(d["odd_ids"]))
            out[name + "/bag_1d"] = jax.jit(sharded_embedding_bag_2d)(
                t, jnp.asarray(d["flat"]))
    mesh = make_mesh((1, 4), ("data", "model"))
    with runtime.use_mesh(mesh):
        out["1x4/row_update"] = sharded_row_update(
            jnp.asarray(d["base"]), d["up_ids"], d["up_rows"])
        out["1x4/lookup"] = jax.jit(sharded_lookup)(
            jnp.asarray(d["table"]), jnp.asarray(d["ids2"]))
    np.savez(sys.argv[2], **{k: np.asarray(v, np.float32)
                              for k, v in out.items()})
    print("REF-MESH-OK")
"""


def _inputs():
    rng = np.random.default_rng(0)
    V = 64
    overflow = {}
    for name, g in (("2x2", 4), ("2x4", 8)):
        # the first position block (128 / g ids) all owned by shard 0:
        # more than cap = 8 rows to one bucket
        per = 128 // g
        rows = V // g
        overflow["over_" + name] = np.concatenate(
            [rng.integers(0, rows, per), rng.integers(0, V, 128 - per)]
        ).astype(np.int32)
    return {"table": rng.normal(size=(V, 16)).astype(np.float32),
            "ids2": rng.integers(0, V, (8, 3)).astype(np.int32),
            "flat": (rng.zipf(1.3, 32) % V).astype(np.int32),
            "bag_ids": rng.integers(0, V, (8, 5)).astype(np.int32),
            "bag_w": (rng.uniform(0, 1, (8, 5)) *
                      (rng.uniform(0, 1, (8, 5)) > 0.3)).astype(np.float32),
            "odd_ids": rng.integers(0, V, (3, 4)).astype(np.int32),
            "base": rng.normal(size=(32, 8)).astype(np.float32),
            "up_ids": np.array([0, 7, 8, 15, 16, 23, 24, 31], np.int32),
            "up_rows": rng.normal(size=(8, 8)).astype(np.float32),
            **overflow}


@pytest.fixture(scope="module")
def ref_mesh_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_mesh")
    data = _inputs()
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_SCRIPT),
                        str(tmp / "in.npz"), str(tmp / "out.npz")],
                       capture_output=True, text=True, timeout=170, env=env)
    assert p.returncode == 0 and "REF-MESH-OK" in p.stdout, \
        p.stdout[-2000:] + p.stderr[-2000:]
    return data, dict(np.load(tmp / "out.npz"))


def _sparse_jobs(data, g):
    """The sparse cases of one (data, model) mesh of ``g`` shards."""
    S = "repro_torch.sparse.sharded:"
    table, rows_big = data["table"], Table(BIG, None)
    over = data["over_2x2" if g == 4 else "over_2x4"]
    return {
        "lookup": Job(S + "sharded_lookup", table, Table("model", None),
                      (data["ids2"],), (P("data", None),),
                      out_specs=P("data", None, None)),
        "a2a": Job(S + "sharded_gather_a2a", table, rows_big,
                   (data["flat"],), (P(BIG),), out_specs=P(BIG, None)),
        "a2a_overflow": Job(S + "sharded_gather_a2a", table, rows_big,
                            (over,), (P(BIG),), {"cap_factor": 1.0},
                            out_specs=P(BIG, None)),
        "bag_sum": Job(S + "sharded_embedding_bag_2d", table, rows_big,
                       (data["bag_ids"], data["bag_w"], "sum"),
                       (P("data", None), P("data", None), None),
                       out_specs=P("data", None)),
        "bag_mean": Job(S + "sharded_embedding_bag_2d", table, rows_big,
                        (data["bag_ids"], data["bag_w"], "mean"),
                        (P("data", None), P("data", None), None),
                        out_specs=P("data", None)),
        "bag_bf16": Job(S + "sharded_embedding_bag_2d", table, rows_big,
                        (data["bag_ids"], None, "mean"),
                        (P("data", None), None, None),
                        {"comm_dtype": torch.bfloat16},
                        out_specs=P("data", None)),
        # B=3 does not split over data=2: every rank holds it whole
        "bag_noscatter": Job(S + "sharded_embedding_bag_2d", table, rows_big,
                             (data["odd_ids"],), (None,),
                             {"batch_axes": ()}),
        "bag_1d": Job(S + "sharded_embedding_bag_2d", table, rows_big,
                      (data["flat"],), (P("data"),), out_specs=P("data", None)),
    }


SPARSE_TOL = {"lookup": dict(rtol=1e-6), "a2a": dict(rtol=1e-6),
              "a2a_overflow": dict(rtol=1e-6), "bag_sum": dict(rtol=1e-5, atol=1e-6),
              "bag_mean": dict(rtol=1e-5, atol=1e-6),
              "bag_bf16": dict(rtol=2e-2, atol=2e-2),
              "bag_noscatter": dict(rtol=1e-5, atol=1e-6),
              "bag_1d": dict(rtol=1e-5, atol=1e-6)}


@pytest.fixture(scope="module")
def sparse_2x4(ref_mesh_run):
    data, _ = ref_mesh_run
    jobs = _sparse_jobs(data, 8)
    ranks = run_jobs(list(jobs.values()), (2, 4), timeout=150)
    return {k: [r[i] for r in ranks] for i, k in enumerate(jobs)}


@pytest.fixture(scope="module")
def mesh_1x4(ref_mesh_run):
    data, _ = ref_mesh_run
    S = "repro_torch.sparse.sharded:"
    jobs = {"row_update": Job(S + "sharded_row_update", data["base"],
                              Table("model", None),
                              (data["up_ids"], data["up_rows"]), (None, None),
                              out_specs=P("model", None)),
            "lookup": Job(S + "sharded_lookup", data["table"],
                          Table("model", None), (data["ids2"],), (None,))}
    ranks = run_jobs(list(jobs.values()), (1, 4), timeout=150)
    return {k: [r[i] for r in ranks] for i, k in enumerate(jobs)}


# ------------------------------------------------ models on a 2x2 mesh

REC_ARCHS = {"din": (jax_din, "din"), "dien": (jax_dien, "dien"),
             "mind": (jax_mind, "mind"),
             "two-tower-retrieval": (jax_towers, "towers")}
N_CAND, TOP_K, BATCH = 37, 10, 8


def _reduced(reg, arch_id):
    arch = reg.get(arch_id)
    return arch.reduced(arch.config)


def _distinct_cands(rng, cfg, C):
    """C candidates whose item ids are distinct (no exact score ties)."""
    cands = jax_synthetic.recsys_ids(rng, cfg.item_fields, C)
    item = next(f for f in cfg.item_fields if f.name == "item_id")
    cands["item_id"] = rng.permutation(item.vocab)[:C].astype(np.int32)
    return cands


def _model_cases():
    """(name, arch, reference call on the reference params, port function,
    args, their specs, kwargs, out_specs) of every model case, and each
    arch's (reference params, numpy params, port param specs)."""
    rng = np.random.default_rng(1)
    mesh = abstract_mesh((2, 2), BIG)
    cases, weights = [], {}
    for arch_id, (ref_mod, port_mod) in REC_ARCHS.items():
        cfg = _reduced(jax_registry, arch_id)
        port_cfg = _reduced(registry, arch_id)
        ref_params = ref_mod.init(jax.random.PRNGKey(0), cfg)
        params = jax.tree.map(np.asarray, ref_params)
        pspecs = sharding.recsys_param_specs(
            params_from_numpy(params, "cpu"), port_cfg, mesh)
        weights[arch_id] = (ref_params, params, pspecs)
        fn = f"repro_torch.models.recsys.{port_mod}:"
        for label, B in (("serve_scores", BATCH),
                         ("serve_scores_whole_odd_batch", 7)):
            batch = jax_synthetic.recsys_batch(rng, cfg, B)
            batch.pop("label")
            # B=8 splits over data as the cells' batched_spec splits it;
            # B=7 does not, and every rank holds it whole
            bspec = (jax.tree.map(lambda a: sharding.batched_spec(
                mesh, a.shape), batch) if B == BATCH else None)
            cases.append((f"{arch_id}/{label}", arch_id,
                          lambda p, m=ref_mod, b=_to_jax(batch), c=cfg:
                          m.serve_scores(p, b, c),
                          fn + "serve_scores", (batch, port_cfg),
                          (bspec, None), {}, P("data") if bspec else None))
        user = jax_synthetic.recsys_batch(rng, cfg, 1)["user"]
        cands = _distinct_cands(rng, cfg, N_CAND)
        u, c = _to_jax(user), _to_jax(cands)
        if arch_id == "two-tower-retrieval":
            user = user["fields"]
            rank_cases = [("retrieve", lambda p, m=ref_mod, g=cfg, u=u, c=c:
                           m.retrieve(p, u["fields"], c, g, top_k=TOP_K), {})]
        elif arch_id == "mind":
            rank_cases = [("retrieve", lambda p, m=ref_mod, g=cfg, u=u, c=c:
                           m.retrieve(p, u, c, g, top_k=TOP_K), {})]
        elif arch_id == "din":
            rank_cases = [(f"score_candidates_{path}",
                           lambda p, m=ref_mod, g=cfg, u=u, c=c, path=path:
                           m.score_candidates(p, u, c, g, top_k=TOP_K,
                                              path=path), {"path": path})
                          for path in ("fused", "jnp")]
        else:
            rank_cases = [("score_candidates", lambda p, m=ref_mod, g=cfg,
                           u=u, c=c: m.score_candidates(p, u, c, g,
                                                        top_k=TOP_K), {})]
        for name, ref_call, kw in rank_cases:
            port_fn = fn + name.split("_jnp")[0].split("_fused")[0]
            cases.append((f"{arch_id}/{name}", arch_id, ref_call, port_fn,
                          (user, cands, port_cfg), (None, None, None),
                          {"top_k": TOP_K, **kw}, None))
    return cases, weights


def _to_jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(a), tree)


@pytest.fixture(scope="module")
def mesh_2x2(ref_mesh_run):
    """One launch of 4 gloo ranks: the sparse cases and every model case."""
    data, _ = ref_mesh_run
    sparse = _sparse_jobs(data, 4)
    cases, weights = _model_cases()
    jobs = list(sparse.values())
    for name, arch_id, _, port_fn, args, arg_specs, kw, out in cases:
        _, params, pspecs = weights[arch_id]
        jobs.append(Job(port_fn, params, pspecs, args, arg_specs, kw, out,
                        check_kernels=True))
    ranks = run_jobs(jobs, (2, 2), timeout=170)
    by_name = list(sparse) + [c[0] for c in cases]
    got = {k: [r[i] for r in ranks] for i, k in enumerate(by_name)}
    want = {name: jax.tree.map(np.asarray, ref_call(weights[arch_id][0]))
            for name, arch_id, ref_call, *_ in cases}
    return got, want


def _case_names():
    names = []
    for arch_id in REC_ARCHS:
        names += [f"{arch_id}/serve_scores",
                  f"{arch_id}/serve_scores_whole_odd_batch"]
        names += {"din": ["din/score_candidates_fused",
                          "din/score_candidates_jnp"],
                  "dien": ["dien/score_candidates"],
                  "mind": ["mind/retrieve"],
                  "two-tower-retrieval": ["two-tower-retrieval/retrieve"]
                  }[arch_id]
    return names


@pytest.mark.parametrize("case", sorted(SPARSE_TOL))
def test_sparse_collectives_2x2_equal_reference_mesh(case, mesh_2x2,
                                                     ref_mesh_run):
    got, _ = mesh_2x2
    _, ref = ref_mesh_run
    for rank in got[case]:
        np.testing.assert_allclose(rank["out"], ref["2x2/" + case],
                                   **SPARSE_TOL[case])


@pytest.mark.parametrize("case", sorted(SPARSE_TOL))
def test_sparse_collectives_2x4_equal_reference_mesh(case, sparse_2x4,
                                                     ref_mesh_run):
    _, ref = ref_mesh_run
    for rank in sparse_2x4[case]:
        np.testing.assert_allclose(rank["out"], ref["2x4/" + case],
                                   **SPARSE_TOL[case])


@pytest.mark.parametrize("mesh", ["2x2", "2x4"])
def test_a2a_overflow_zeros_fall_where_the_reference_s_do(mesh, mesh_2x2,
                                                          sparse_2x4,
                                                          ref_mesh_run):
    data, ref = ref_mesh_run
    got = (mesh_2x2[0] if mesh == "2x2" else sparse_2x4)["a2a_overflow"]
    want = ref[mesh + "/a2a_overflow"]
    zeros = ~want.any(-1)
    # the overflow happened (the bucket of the first block is full) and the
    # port's zero rows are the reference's, the rest the table's rows
    assert zeros.sum() > 0
    np.testing.assert_array_equal(~got[0]["out"].any(-1), zeros)
    ids = data["over_" + mesh]
    np.testing.assert_array_equal(got[0]["out"][~zeros],
                                  data["table"][ids][~zeros])


@pytest.mark.parametrize("case", ["row_update", "lookup"])
def test_model_axis_paths_1x4_equal_reference_mesh(case, mesh_1x4,
                                                   ref_mesh_run):
    data, ref = ref_mesh_run
    for rank in mesh_1x4[case]:
        if case == "row_update":
            # every shard edge: no row wraps into another shard's tail
            want = data["base"].copy()
            want[data["up_ids"]] = data["up_rows"]
            np.testing.assert_array_equal(ref["1x4/row_update"], want)
            np.testing.assert_array_equal(rank["out"], want)
        else:
            np.testing.assert_allclose(rank["out"], ref["1x4/lookup"],
                                       rtol=1e-6)
            assert set(rank["collectives"]) == {("all_reduce", 4)}


@pytest.mark.parametrize("case", _case_names())
def test_recsys_models_on_a_2x2_mesh_equal_reference(case, mesh_2x2):
    got, want = mesh_2x2
    for rank in got[case]:
        out = rank["out"]
        if isinstance(want[case], (tuple, list)):
            np.testing.assert_allclose(out[0], want[case][0], **TOL)
            assert out[1].tolist() == want[case][1].tolist()
        else:
            np.testing.assert_allclose(out, want[case], **TOL)


@pytest.mark.parametrize("arch_id", sorted(REC_ARCHS))
def test_grouped_lookup_of_a_model_call_is_three_collectives(arch_id,
                                                            mesh_2x2):
    """serve_scores on a split batch: the grouped lookup's one all_gather
    (every group's ids), one reduce_scatter and one all_reduce carry all
    the fields of the call."""
    got, _ = mesh_2x2
    for rank in got[f"{arch_id}/serve_scores"]:
        calls = {kind: n for (kind, _), (n, _) in
                 rank["collectives"].items()}
        want = {"all_gather": 1, "reduce_scatter": 1, "all_reduce": 1}
        if arch_id == "two-tower-retrieval":     # user_vec and item_vec
            want = {k: 2 * v for k, v in want.items()}
        assert calls == want
        assert all(nbytes > 0 for (_, nbytes) in
                   rank["collectives"].values())


#: the kernels each model case reaches at the reduced widths
CASE_KERNELS = {
    "din/serve_scores": {"embedding_bag", "din_attention"},
    "din/score_candidates_fused": {"embedding_bag", "rerank_score"},
    "din/score_candidates_jnp": {"embedding_bag", "din_attention"},
    "dien/serve_scores": {"embedding_bag", "augru"},
    "dien/score_candidates": {"embedding_bag", "augru"},
    "mind/serve_scores": {"embedding_bag"},
    "mind/retrieve": {"embedding_bag"},
    "two-tower-retrieval/serve_scores": {"embedding_bag"},
    "two-tower-retrieval/retrieve": {"embedding_bag", "candidate_scorer"},
}


@pytest.mark.parametrize("case", _case_names())
def test_kernel_checks_replay_each_rank_s_own_calls(case, mesh_2x2):
    """Each rank's recorded kernel calls are its own: the embedding bags
    read the rank's 256-row shard of every 1024-row table (never a whole
    table), and the replayed wrapper equals the plain version."""
    got, _ = mesh_2x2
    want_kernels = CASE_KERNELS[case.replace("_whole_odd_batch", "")]
    for rank in got[case]:
        checks = rank["kernel_checks"]
        assert {c["kernel"] for c in checks} == want_kernels
        for c in checks:
            assert len(c["got"]) == len(c["want"]) > 0
            for g, w in zip(c["got"], c["want"]):
                np.testing.assert_array_equal(g, w)
            if c["kernel"] == "embedding_bag":
                assert (256, 16) in c["shapes"]
                assert (1024, 16) not in c["shapes"]


def test_kernel_recording_keeps_calls_with_their_defaults():
    from repro_torch import kernels as K
    from repro_torch.kernels.candidate_scorer import candidate_scorer
    from repro_torch.kernels.din_attention import din_attention
    g = torch.Generator().manual_seed(0)
    cands, query = torch.randn(50, 8, generator=g), torch.randn(8, generator=g)
    D, H1, H2 = 4, 6, 5
    attn = (torch.randn(3, 7, D, generator=g), torch.ones(3, 7),
            torch.randn(3, D, generator=g),
            torch.randn(4 * D, H1, generator=g), torch.zeros(H1),
            torch.randn(H1, H2, generator=g), torch.zeros(H2),
            torch.randn(H2, 1, generator=g), torch.zeros(1))
    with K.recording() as outer:
        candidate_scorer(cands, query)
        with K.recording() as inner:
            din_attention(*attn)
        candidate_scorer(cands, query, k=3)
    candidate_scorer(cands, query)                  # not recorded
    assert [c[0] for c in outer] == ["candidate_scorer", "candidate_scorer"]
    assert [c[0] for c in inner] == ["din_attention"]
    assert [c[3][2] for c in outer] == [8, 3]       # k, default applied
    rows = K.replay(outer + inner)
    assert [r[0] for r in rows] == ["candidate_scorer", "candidate_scorer",
                                    "din_attention"]
    assert rows[0][1] == [(50, 8), (8,)]
    for _, _, got, want in rows:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("arch_id", sorted(REC_ARCHS))
def test_retrieval_cells_draw_their_candidates_whole_on_a_rank(arch_id):
    """The reference's specs split the candidates over data; the port's
    ranking calls take them whole (and slice them where the reference's
    model code shards them), so a rank draws them whole and its fit check
    counts them whole."""
    mesh = abstract_mesh((2, 2), BIG)
    cell = specs.build_cell(arch_id, "retrieval_cand", mesh=mesh)
    cand = cell.args[2]
    assert all(_canon(sp[0]) == "data" for sp in
               jax.tree.leaves(cell.in_specs[2],
                               is_leaf=lambda x: isinstance(x, P)))
    local = jax.tree.leaves(cell.local_specs[2],
                            is_leaf=lambda x: isinstance(x, P))
    assert local and all(all(e is None for e in sp) for sp in local)
    cand_bytes = sum(t.numel() * t.element_size()
                     for t in jax.tree.leaves(cand))
    split = specs.Cell(**{**cell.__dict__, "local_specs": None})
    assert (cell.arg_bytes_per_device() - split.arg_bytes_per_device()
            == cand_bytes - cand_bytes // 2)


def test_run_cell_on_a_2x2_mesh_records_collectives(tmp_path):
    rec = dryrun.run_cell("din", "serve_p99", str(tmp_path), device="cpu",
                          reduced=True, mesh=(2, 2), steps=1, warmup=1)
    assert rec["ok"], rec.get("traceback")
    assert (tmp_path / "din__serve_p99__2x2@cpu.json").exists()
    assert rec["n_devices"] == 4 and rec["backend"] == "gloo"
    assert len(rec["ranks"]) == 4
    for r in rec["ranks"]:
        assert r["host_step_ms"] > 0
        by_kind = r["collectives_per_step"]
        assert {"all_gather", "reduce_scatter", "all_reduce"} <= set(by_kind)
        assert all(row["bytes"] > 0 for row in by_kind.values())
        assert r["ops"]["collective_bytes_per_device"] > 0
    cell = specs.build_cell("din", "serve_p99", device="cpu", reduced=True)
    with torch.no_grad():
        want = cell.fn(*cell.materialize("cpu",
                                         torch.Generator().manual_seed(0)))
    np.testing.assert_allclose(rec["output"], want.numpy(), **TOL)


def test_run_cell_on_a_mesh_checks_each_rank_s_kernels(tmp_path):
    rec = dryrun.run_cell("dien", "serve_p99", str(tmp_path), device="cpu",
                          reduced=True, mesh=(2, 2), steps=1, warmup=1,
                          check_kernels=True)
    assert rec["ok"], rec.get("traceback")
    assert len(rec["kernel_checks"]) == 4
    for r, checks in zip(rec["ranks"], rec["kernel_checks"]):
        assert {c["kernel"] for c in checks} == {"embedding_bag", "augru"}
        assert set(r["launches_per_step"]) == set()  # no launch on the CPU
        for c in checks:
            for g, w in zip(c["got"], c["want"]):
                np.testing.assert_array_equal(g, w)
    written = (tmp_path / "dien__serve_p99__2x2@cpu.json").read_text()
    assert "kernel_checks" not in written and '"output"' not in written


def test_moe_refuses_an_installed_model_axis():
    """The expert-parallel MoE is ported: on an installed mesh with a
    ``model`` axis it no longer refuses but splits its experts by
    ``moe_param_specs``, which equal the reference's (and the MoE leaves
    of ``lm_param_specs``) on abstract meshes, d_ff split over ``data`` or
    not; a (2, 1) mesh keeps the single-device path."""
    from repro.models import moe as jax_moe
    from repro_torch import runtime
    from repro_torch.models import moe
    for f_sharded in (True, False):
        got = moe.moe_param_specs(None, f_sharded)
        want = jax_moe.moe_param_specs(None, f_sharded)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
    cfg = registry.get("deepseek-v2-lite-16b").config
    for shape, f_sharded in (((2, 4), True), ((16, 16), True),
                             ((3, 2), False)):
        mesh = abstract_mesh(shape, BIG)
        specs_ = sharding.lm_param_specs(
            specs.build_cell("deepseek-v2-lite-16b", "decode_32k").args[0],
            cfg, mesh)["layers"]["moe"]
        want = moe.moe_param_specs(None, cfg.moe.d_ff_expert % shape[0] == 0)
        assert f_sharded == (cfg.moe.d_ff_expert % shape[0] == 0)
        assert {k: tuple(v)[1:] for k, v in specs_.items()} == \
            {k: tuple(v) for k, v in want.items()}
    p = moe.moe_expert_init(torch.Generator().manual_seed(0), 16,
                            _reduced(registry, "deepseek-v2-lite-16b").moe,
                            "float32", device="cpu")
    x = torch.randn(5, 16, generator=torch.Generator().manual_seed(1))
    cfg = _reduced(registry, "deepseek-v2-lite-16b").moe
    want, _ = moe.moe_apply(p, x, cfg)
    with runtime.use_mesh(abstract_mesh((2, 1), BIG)):
        torch.testing.assert_close(moe.moe_apply(p, x, cfg)[0], want)
