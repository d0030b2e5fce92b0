"""The port's LM on a device mesh against the reference, on the CPU:

  * the five reduced LM archs on gloo ranks at (2, 2) and (2, 4)
    (``launch.mesh.run_jobs``; one launch per mesh serves every case):
    ``prefill`` of 9 tokens into a 16-slot cache, then three teacher-forced
    ``decode_step``s (``transformer.teacher_forced``), with the batch split
    over ``data`` (B = 2: the sequence over ``model``) and whole (B = 1:
    the sequence over every axis); the logits of every step within the
    reduced LM's 2e-5 of the reference's single-device run on the same
    weights, and the cache rows the run wrote equal to the reference's.
    Every decode step has sequence shards that hold no valid row yet;
    their B6 calls give 0 and an lse of -1e30, and each rank's replayed
    B6 calls (with their lse) equal the plain version's;
  * the masked cache write on a shard boundary and on the last row of the
    last shard, rank by rank, against ``dynamic_update_slice``;
  * the reference's ``hidden_states`` with ``shard_carry=True``
    (deepseek-v3): the port on a (2, 2) mesh in a training forward, whose
    residual between blocks is each rank's block of d_model, gives its
    values;
  * the port's expert-parallel ``moe_apply`` on (2, 4) against the
    reference's ``moe_apply`` on a forced 8-device CPU mesh in a
    subprocess (as ``tests/test_distributed.py`` runs it), at
    ``capacity_factor`` 8.0 and 1.25 (pairs dropped), tokens split over
    ``data``, whole and splittable, and whole and not (the replicated
    branch), at that test's tolerance (rtol 5e-4, atol 5e-5); the chunked
    branch, with ``CHUNK_ELEMS`` cut in the ranks, against the un-chunked
    one where nothing drops;
  * the same serving run in bf16 (qwen3-8b, deepseek-v2-lite-16b) on a
    (2, 2) mesh, its TP and expert partials summed in bf16 as GSPMD sums
    them: its error against the float32 run of the same weights at most
    1.5 times the bf16 single-device run's;
  * ``run_cell`` of smollm-135m and deepseek-v2-lite-16b × long_500k at
    reduced widths on a (2, 2) mesh: ``ok``, collectives recorded, and the
    logits of the cell run whole (the counterpart of
    ``test_dryrun_reduced_mesh_cells``).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import transformer as jax_tf
from repro_torch.configs import registry
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import params_from_numpy
from repro_torch.launch import dryrun, sharding, specs
from repro_torch.launch.mesh import Job, ModelDraw, abstract_mesh, run_jobs
from repro_torch.launch.sharding import P
from repro_torch.models import attention, moe, transformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("data", "model")
LM_ARCHS = ["qwen3-8b", "smollm-135m", "starcoder2-7b",
            "deepseek-v2-lite-16b", "deepseek-v3-671b"]
GQA_ARCHS = ["qwen3-8b", "smollm-135m", "starcoder2-7b"]
TOL = dict(rtol=2e-5, atol=2e-5)                 # tests/test_torch_lm.py
MOE_TOL = dict(rtol=5e-4, atol=5e-5)             # tests/test_distributed.py
N_PROMPT, N_TOKENS, SMAX = 9, 12, 16
MESHES = {"2x2": (2, 2), "2x4": (2, 4)}
#: the batch sizes run on each mesh: the whole batch (B = 1, the sequence
#: over every axis) on the 4-rank mesh only, to keep the 8 ranks short
BATCHES = {"2x2": (2, 1), "2x4": (2,)}
#: the archs also run in bf16 on (2, 2), and how far their error against
#: float32 may exceed the single-device bf16 run's (chip_smoke.py's
#: BF16_ERR_RATIO)
BF16_ARCHS = ["qwen3-8b", "deepseek-v2-lite-16b"]
BF16_ERR_RATIO = 1.5
BF16_SEED = 3
ref_prefill = jax.jit(jax_tf.prefill, static_argnums=(2, 3))
ref_decode_step = jax.jit(jax_tf.decode_step, static_argnums=(3,))


def _reduced(reg, arch_id):
    arch = reg.get(arch_id)
    return arch.reduced(arch.config)


# ------------------------------------------------------ the reference

@pytest.fixture(scope="module")
def lm_cases():
    """Per arch: the reference's weights as numpy, and per batch size its
    single-device run (logits of the prefill and of each step, the final
    cache) on the same tokens."""
    rng = np.random.default_rng(21)
    cases = {}
    for arch_id in LM_ARCHS:
        cfg = _reduced(jax_registry, arch_id)
        ref = jax_tf.init(jax.random.PRNGKey(0), cfg)
        runs = {}
        for B in (2, 1):
            toks = rng.integers(0, cfg.vocab, (B, N_TOKENS))
            logits, cache = ref_prefill(
                ref, jnp.asarray(toks[:, :N_PROMPT], jnp.int32), cfg, SMAX)
            out = [logits]
            for t in range(N_PROMPT, N_TOKENS):
                logits, cache = ref_decode_step(
                    ref, cache, jnp.asarray(toks[:, t:t + 1], jnp.int32), cfg)
                out.append(logits)
            runs[B] = (toks, np.stack([np.asarray(x) for x in out]),
                       jax.tree.map(np.asarray, cache))
        cases[arch_id] = (jax.tree.map(np.asarray, ref), runs)
    return cases


def _bf16(arch_id):
    return dataclasses.replace(_reduced(registry, arch_id),
                               param_dtype="bfloat16")


def _lm_jobs(cases, shape, batches):
    """One ``teacher_forced`` job per arch and batch size on a mesh of
    ``shape``: the batch of 2 split over ``data``, the batch of 1 whole."""
    mesh = abstract_mesh(shape, AXES)
    jobs, names = [], []
    for arch_id, (weights, runs) in cases.items():
        cfg = _reduced(registry, arch_id)
        pspecs = sharding.lm_param_specs(params_from_numpy(weights, "cpu"),
                                         cfg, mesh)
        for B in batches:
            toks = runs[B][0]
            split = sharding.batched_spec(mesh, (B,))[0] is not None
            if split:
                job = Job("repro_torch.models.transformer:teacher_forced",
                          weights, pspecs, (toks, cfg, SMAX, N_PROMPT),
                          (P("data", None), None, None, None),
                          out_specs=(P(None, "data", None), transformer.KVCache(
                              a=P(None, "data"), b=P(None, "data"),
                              length=P())), check_kernels=True)
            else:
                job = Job("repro_torch.models.transformer:teacher_forced",
                          weights, pspecs, (toks, cfg, SMAX, N_PROMPT),
                          (None,) * 4, {"batch_axes": ()},
                          check_kernels=True)
            jobs.append(job)
            names.append((arch_id, B))
    return jobs, names


# ------------------------------------------------------------------ MoE

MOE_REF_SCRIPT = """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from repro import runtime
    from repro.configs.base import MoEConfig
    from repro.launch.mesh import make_mesh
    from repro.models.moe import moe_apply
    d = dict(np.load(sys.argv[1]))
    p = {k: jnp.asarray(d["p_" + k]) for k in ("router", "w1", "w3", "w2")}
    out = {}
    mesh = make_mesh((2, 4), ("data", "model"))
    for cf in (8.0, 1.25):
        cfg = MoEConfig(n_routed=8, top_k=2, d_ff_expert=16,
                        capacity_factor=cf)
        for name in ("x32", "x128", "x7"):
            x = jnp.asarray(d[name])
            out[f"{cf}/{name}/single"] = moe_apply(p, x, cfg)[0]
            with runtime.use_mesh(mesh):
                got, aux = jax.jit(lambda p, x: moe_apply(p, x, cfg))(p, x)
            out[f"{cf}/{name}"], out[f"{cf}/{name}/aux"] = got, aux
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
    print("MOE-MESH-OK")
"""

#: a module the ranks import: the port's moe_apply with CHUNK_ELEMS cut,
#: so that the chunked branch runs at a test's size (a monkeypatch in the
#: test process does not reach spawned ranks)
CHUNKED_MODULE = """
from repro_torch.models import moe

moe.CHUNK_ELEMS = 256


def moe_apply(*args, **kwargs):
    return moe.moe_apply(*args, **kwargs)
"""

#: a rank-side function (its own module: the one above cuts CHUNK_ELEMS
#: for every job after its import)
CARRY_MODULE = """
import torch

from repro_torch import tree as tree_lib
from repro_torch.models import transformer


def carry_forward(params, tokens, cfg):
    \"\"\"hidden_states in a training forward (autograd on, every float
    parameter requiring its gradient), with the shape of the residual
    each block hands the next, one row a block.\"\"\"
    block, shapes = transformer._block, []

    def recorded(*args, **kwargs):
        out = block(*args, **kwargs)
        shapes.append(tuple(out[0].shape))
        return out
    transformer._block = recorded
    try:
        with torch.enable_grad():
            live = tree_lib.tree_map(
                lambda t: t.detach().requires_grad_(t.is_floating_point()),
                params)
            x, _ = transformer.hidden_states(live, tokens, cfg)
    finally:
        transformer._block = block
    return x.detach(), torch.tensor(shapes)
"""


def _moe_inputs():
    rng = np.random.default_rng(5)
    d, E, f = 16, 8, 16
    return {"p_router": (rng.normal(size=(d, E)) / 4).astype(np.float32),
            "p_w1": (rng.normal(size=(E, d, f)) / 4).astype(np.float32),
            "p_w3": (rng.normal(size=(E, d, f)) / 4).astype(np.float32),
            "p_w2": (rng.normal(size=(E, f, d)) / 4).astype(np.float32),
            "x32": rng.normal(size=(32, d)).astype(np.float32),
            # shifted: the routing leans on a few experts, which then
            # take more pairs than a capacity of 1.25 holds
            "x128": (rng.normal(size=(128, d)) + 0.5).astype(np.float32),
            "x7": rng.normal(size=(7, d)).astype(np.float32)}


@pytest.fixture(scope="module")
def moe_ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ref")
    data = _moe_inputs()
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(MOE_REF_SCRIPT),
                        str(tmp / "in.npz"), str(tmp / "out.npz")],
                       capture_output=True, text=True, timeout=170, env=env)
    assert p.returncode == 0 and "MOE-MESH-OK" in p.stdout, \
        p.stdout[-2000:] + p.stderr[-2000:]
    return data, dict(np.load(tmp / "out.npz"))


#: (case, capacity factor, tokens, layout): "split" over data, "whole"
MOE_CASES = [("cf8_split", 8.0, "x32", "split"),
             ("cf8_whole_splittable", 8.0, "x32", "whole"),
             ("cf8_replicated", 8.0, "x7", "whole"),
             ("cf125_drops", 1.25, "x128", "split"),
             ("cf125_replicated", 1.25, "x7", "whole")]


def _moe_jobs(data, fn="repro_torch.models.moe:moe_apply", cases=MOE_CASES):
    params = {k: data["p_" + k] for k in ("router", "w1", "w3", "w2")}
    pspecs = moe.moe_param_specs(None, f_sharded=True)
    jobs = []
    for _, cf, x, layout in cases:
        cfg = MoEConfig(n_routed=8, top_k=2, d_ff_expert=16,
                        capacity_factor=cf)
        if layout == "split":
            jobs.append(Job(fn, params, pspecs, (data[x], cfg),
                            (P("data", None), None),
                            out_specs=(P("data", None), None)))
        else:
            jobs.append(Job(fn, params, pspecs, (data[x], cfg), (None, None),
                            {"batch_axes": ()}))
    return jobs


# ---------------------------------------------------------- the launches

@pytest.fixture(scope="module")
def mesh_runs(lm_cases, moe_ref, tmp_path_factory):
    """One launch per mesh: (2, 2) the LM cases and deepseek-v3's
    hidden_states; (2, 4) the LM cases, the MoE cases and the chunked
    branch (its module on the ranks' path)."""
    data, _ = moe_ref
    helper = tmp_path_factory.mktemp("chunked")
    (helper / "chunked_moe.py").write_text(CHUNKED_MODULE)
    (helper / "carry_lm.py").write_text(CARRY_MODULE)
    out = {}
    for name, shape in MESHES.items():
        jobs, names = _lm_jobs(lm_cases, shape, BATCHES[name])
        extra = {}
        if name == "2x2":
            cfg = _reduced(registry, "deepseek-v3-671b")
            weights, runs = lm_cases["deepseek-v3-671b"]
            pspecs = sharding.lm_param_specs(
                params_from_numpy(weights, "cpu"), cfg,
                abstract_mesh(shape, AXES))
            extra["shard_carry"] = Job(
                "carry_lm:carry_forward", weights,
                pspecs, (runs[2][0], cfg), (P("data", None), None),
                out_specs=(P("data", None, None), None))
            for arch_id in BF16_ARCHS:
                cfg = _bf16(arch_id)
                extra[f"bf16/{arch_id}"] = Job(
                    "repro_torch.models.transformer:teacher_forced",
                    ModelDraw("repro_torch.models.transformer", cfg,
                              BF16_SEED), None,
                    (lm_cases[arch_id][1][2][0], cfg, SMAX, N_PROMPT),
                    (P("data", None), None, None, None),
                    out_specs=(P(None, "data", None), transformer.KVCache(
                        a=P(None, "data"), b=P(None, "data"), length=P())))
        else:
            for (case, *_), job in zip(MOE_CASES, _moe_jobs(data)):
                extra[case] = job
            extra["chunked"] = _moe_jobs(data, "chunked_moe:moe_apply",
                                         [MOE_CASES[0]])[0]
        sys.path.insert(0, str(helper))
        try:
            ranks = run_jobs(jobs + list(extra.values()), shape, timeout=170)
        finally:
            sys.path.remove(str(helper))
        keys = names + list(extra)
        out[name] = {k: [r[i] for r in ranks] for i, k in enumerate(keys)}
    return out


# ---------------------------------------------------------------- the LM

@pytest.mark.parametrize("mesh,B", [(m, B) for m in sorted(MESHES)
                                    for B in BATCHES[m]])
@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_prefill_and_decode_on_a_mesh_equal_reference(arch_id, mesh, B,
                                                        mesh_runs, lm_cases):
    """Every rank's logits (prefill and three decode steps) within 2e-5 of
    the reference's single-device run, and the cache rows the steps wrote
    equal to the reference's cache (2e-5)."""
    _, runs = lm_cases[arch_id]
    _, want_logits, want_cache = runs[B]
    for rank in mesh_runs[mesh][(arch_id, B)]:
        logits, cache = rank["out"]
        np.testing.assert_allclose(logits, want_logits, **TOL)
        np.testing.assert_allclose(cache.a, want_cache.a[:, :, :N_TOKENS],
                                   **TOL)
        np.testing.assert_allclose(cache.b, want_cache.b[:, :, :N_TOKENS],
                                   **TOL)
        assert int(cache.length) == N_TOKENS


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch_id", GQA_ARCHS)
def test_decode_runs_b6_with_lse_on_every_shard(arch_id, mesh, mesh_runs):
    """Each rank's B6 calls are its decode steps' (one per layer and step,
    with ``return_lse``), replayed equal to the plain version; a shard that
    holds no valid row yet gives out 0 and lse -1e30."""
    cfg = _reduced(registry, arch_id)
    empty = 0
    for B in BATCHES[mesh]:
        for rank in mesh_runs[mesh][(arch_id, B)]:
            checks = rank["kernel_checks"]
            assert len(checks) == cfg.n_layers * (N_TOKENS - N_PROMPT)
            for c in checks:
                assert c["kernel"] == "flash_decode" and len(c["got"]) == 2
                for g, w in zip(c["got"], c["want"]):
                    np.testing.assert_array_equal(g, w)
                out, lse = c["got"]
                assert lse.shape == out.shape[:3] and np.isfinite(lse).all()
                if (lse == np.float32(-1e30)).all():
                    assert not out.any()
                    empty += 1
    assert empty > 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_decode_collectives_by_kind(mesh, mesh_runs):
    """A GQA decode on a sequence-sharded cache meets the other shards by
    max and sum all_reduces (two per layer and step) and gathers the
    vocab-split logits; the collectives carry bytes."""
    for rank in mesh_runs[mesh][("qwen3-8b", BATCHES[mesh][-1])]:
        kinds = {k for (k, _g) in rank["collectives"]}
        assert {"all_reduce", "all_gather"} <= kinds
        assert all(b > 0 for (_n, b) in rank["collectives"].values())


@pytest.mark.parametrize("position", ["boundary", "last_row", "full"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_masked_cache_write_lands_on_the_owner_only(position, n_shards):
    """Rank by rank, the one new row goes into the shard that owns its
    position (on a shard boundary, the last row of the last shard, and
    past a full cache, where it clamps onto the last row as
    dynamic_update_slice does); every other shard is unchanged."""
    smax, D = 16, 3
    rows = smax // n_shards
    pos = {"boundary": rows, "last_row": smax - 1, "full": smax}[position]
    base = np.arange(2 * smax * D, dtype=np.float32).reshape(2, smax, D)
    new = -np.ones((2, 1, D), np.float32)
    want = np.asarray(jax.lax.dynamic_update_slice_in_dim(
        jnp.asarray(base), jnp.asarray(new), pos, 1))
    got = []
    for r in range(n_shards):
        shard = torch.as_tensor(base[:, r * rows:(r + 1) * rows].copy())
        seq = attention.SeqShard(("model",), r * rows, rows, smax)
        attention._write_cache(shard, torch.as_tensor(new),
                               torch.tensor(pos, dtype=torch.int32), seq)
        got.append(shard.numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1), want)


def test_shard_carry_changes_no_value(mesh_runs, lm_cases):
    """deepseek-v3's ``shard_carry=True`` splits the residual over
    ``model`` on d_model (the reference's layout pin): in a training
    forward on a (2, 2) mesh the carry every block hands the next is the
    rank's (B_local, S, d / 2) block, and hidden_states, gathered whole
    before the final norm, equals the reference's (single device) within
    2e-5."""
    cfg = _reduced(jax_registry, "deepseek-v3-671b")
    assert cfg.shard_carry
    weights, runs = lm_cases["deepseek-v3-671b"]
    toks = runs[2][0]
    want, _ = jax.jit(jax_tf.hidden_states, static_argnums=(2,))(
        jax.tree.map(jnp.asarray, weights), jnp.asarray(toks, jnp.int32), cfg)
    B, S = np.shape(toks)
    for rank in mesh_runs["2x2"]["shard_carry"]:
        hidden, carries = rank["out"]
        assert [tuple(int(n) for n in c) for c in carries] == \
            [(B // 2, S, cfg.d_model // 2)] * cfg.n_layers
        np.testing.assert_allclose(hidden, np.asarray(want), **TOL)


@pytest.mark.parametrize("arch_id", BF16_ARCHS)
def test_bf16_mesh_run_rounds_no_worse_than_whole(arch_id, mesh_runs,
                                                  lm_cases):
    """bf16 on (2, 2): every rank's logits equal, and their RMS error
    against the float32 run of the same (bf16-drawn) weights at most
    BF16_ERR_RATIO times the bf16 single-device run's: the mesh rounds its
    partial sums in other places, not more coarsely."""
    cfg = _bf16(arch_id)
    toks = torch.as_tensor(lm_cases[arch_id][1][2][0])
    params = transformer.init(torch.Generator().manual_seed(BF16_SEED), cfg,
                              "cpu")
    whole, _ = transformer.teacher_forced(params, toks, cfg, SMAX, N_PROMPT)
    ref, _ = transformer.teacher_forced(
        _float(params), toks,
        dataclasses.replace(cfg, param_dtype="float32"), SMAX, N_PROMPT)
    ref = ref.numpy()

    def err(x):
        return float(np.sqrt(np.mean((x - ref) ** 2) / np.mean(ref ** 2)))
    ranks = [r["out"][0] for r in mesh_runs["2x2"][f"bf16/{arch_id}"]]
    for got in ranks:
        np.testing.assert_array_equal(got, ranks[0])
    assert err(ranks[0]) <= BF16_ERR_RATIO * err(whole.float().numpy())


def _float(tree):
    if isinstance(tree, dict):
        return {k: _float(v) for k, v in tree.items()}
    return tree.float()


# ------------------------------------------------------------------- MoE

@pytest.mark.parametrize("case", [c[0] for c in MOE_CASES])
def test_moe_on_2x4_equals_reference_mesh(case, mesh_runs, moe_ref):
    """The port's expert-parallel moe_apply on (2, 4) against the
    reference's on its (2, 4) mesh: every rank's tokens (split over data
    or whole), and the aux averaged over the mesh."""
    _, ref = moe_ref
    _, cf, x, _ = next(c for c in MOE_CASES if c[0] == case)
    for rank in mesh_runs["2x4"][case]:
        out, aux = rank["out"]
        np.testing.assert_allclose(out, ref[f"{cf}/{x}"], **MOE_TOL)
        np.testing.assert_allclose(aux, ref[f"{cf}/{x}/aux"], **MOE_TOL)
    if case == "cf125_drops":
        # capacity drops happened: the mesh result differs from an
        # undropped dispatch of the same tokens
        assert not np.allclose(ref["1.25/x128"], ref["8.0/x128"], **MOE_TOL)


def test_moe_branches_collectives(mesh_runs):
    """Token-sharded rows that split over both axes: one all_gather each
    of tokens, gates and ids over data, then a reduce_scatter over (data,
    model) and an all_gather over model; replicated tokens: one
    all_reduce of the output over (data, model) (d_ff split), plus the
    aux's."""
    split = mesh_runs["2x4"]["cf8_split"][0]["collectives"]
    assert split[("all_gather", 2)][0] == 3
    assert split[("reduce_scatter", 8)][0] == 1
    assert split[("all_gather", 4)][0] == 1
    rep = mesh_runs["2x4"]["cf8_replicated"][0]["collectives"]
    assert rep[("all_reduce", 8)][0] == 2
    assert ("all_gather", 2) not in rep and ("reduce_scatter", 8) not in rep


def test_moe_chunked_branch_equals_unchunked(mesh_runs, moe_ref):
    """With CHUNK_ELEMS cut to 256 the gathered 32-token row (32 x 16
    elements) dispatches in 2 chunks, each gathered on its own; nothing
    drops at capacity 8.0, so it equals the un-chunked branch and the
    reference's mesh run."""
    _, ref = moe_ref
    chunked = mesh_runs["2x4"]["chunked"]
    whole = mesh_runs["2x4"]["cf8_split"]
    for a, b in zip(chunked, whole):
        np.testing.assert_allclose(a["out"][0], b["out"][0], **MOE_TOL)
        np.testing.assert_allclose(a["out"][0], ref["8.0/x32"], **MOE_TOL)
        # each chunk gathers its tokens, gates and ids over data
        assert a["collectives"][("all_gather", 2)][0] == 3 * 2


# -------------------------------------------------------------- the cells

@pytest.mark.parametrize("arch_id", ["smollm-135m", "deepseek-v2-lite-16b"])
def test_run_cell_long_500k_on_a_2x2_mesh(arch_id, tmp_path):
    """``run_cell`` of the LM's batch-1 long-context decode at reduced
    widths on 4 gloo ranks: ``ok``, every rank's collectives recorded and
    the op count's collective bytes, the record named for the mesh, and
    the logits equal to the cell run whole (same layerwise draw)."""
    rec = dryrun.run_cell(arch_id, "long_500k", str(tmp_path), device="cpu",
                          reduced=True, mesh=(2, 2), steps=1, warmup=1)
    assert rec["ok"], rec.get("traceback")
    assert (tmp_path / f"{arch_id}__long_500k__2x2@cpu.json").exists()
    assert len(rec["ranks"]) == 4
    for r in rec["ranks"]:
        by_kind = r["collectives_per_step"]
        assert {"all_gather", "all_reduce"} <= set(by_kind)
        assert r["ops"]["collective_bytes_per_device"] > 0
    cell = specs.build_cell(arch_id, "long_500k", device="cpu", reduced=True)
    with torch.no_grad():
        want, _ = cell.fn(*cell.materialize(
            "cpu", torch.Generator().manual_seed(0)))
    assert rec["output"][0].shape == tuple(want.shape)
    np.testing.assert_allclose(rec["output"][0], want.numpy(), **TOL)
