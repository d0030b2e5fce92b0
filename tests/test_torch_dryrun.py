"""The production-mesh dry run (``launch/dryrun.py::dry_run_cell``) on the
CPU: one rank's step on torch's ``meta`` device, on its dry mesh (its
coordinates, no process group), through the code a live rank runs.

  * every collective of ``runtime`` on a dry mesh, forward and backward,
    gives the output shapes and the counts (kind, group, bytes) of the
    same call on live gloo ranks (``run_jobs``); a dry mesh refuses a
    tensor not on ``meta`` and a reduce_scatter whose rows do not split;
  * each of the six kernel wrappers on ``meta`` gives its plain version's
    output shapes and dtypes at ``chip_smoke.py`` [3]'s shapes, adds no
    launch, and hands an active counter the cost the CPU inputs give, or
    its bound where the cost reads data (the bound is the cost of the
    worst data: an all-ones mask, every id a distinct row, every cache
    row valid); mixed ``meta`` / CPU inputs raise;
  * the MoE's static dispatch (scatter-add counts, every pair written, a
    dropped one to the sentinel slot) equals the reference's
    ``moe_apply`` with the capacity overflowing;
  * at (2, 2) every rank's dry count equals a live gloo run of the same
    cell: its arguments' shapes and bytes (``arg_bytes_per_device``), the
    flops, the ops moving the most bytes, the collectives by kind and by
    group, the kernel calls exactly; bytes and flops exactly outside the
    kernels whose dry cost is a bound, those at least the live count;
    the peak of the call's own storages equal on the cells without a
    kernel. On the kernel cells the live ranks take the kernels' path on
    CPU tensors (``on_cpu`` says no, a C entry that launches nothing), as
    ``tests/test_torch_isolation.py::_plain_card`` arranges it;
  * at (2, 4), reduced widths, the flops per device against the
    reference's ``analyze_hlo`` of its compiled cell on 8 forced host
    devices (one subprocess, ``REPRO_DRYRUN_DEVICES=8``): within 0.1%
    where both count the same products, else within a bound stated here
    whose ops are named (``ROADMAP.md`` §C);
  * one cell a family on (16, 16) and (2, 16, 16) to an ``ok`` record
    whose argument bytes are ``arg_bytes_per_device``, read by
    ``roofline --mesh``; the CLI writes one; a cell whose kernel refuses
    its shape is recorded and the sweep goes on.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch import runtime
from repro_torch import tree as tree_lib
from repro_torch.kernels.augru import ops as augru_ops
from repro_torch.kernels.augru.ref import augru_ref
from repro_torch.kernels.candidate_scorer import ops as scorer_ops
from repro_torch.kernels.candidate_scorer.ref import candidate_scorer_ref
from repro_torch.kernels.din_attention import ops as din_ops
from repro_torch.kernels.din_attention.ref import din_attention_ref
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_group_ref,
                                                   embedding_bag_ref)
from repro_torch.kernels.flash_decode import ops as decode_ops
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.rerank_score import ops as rerank_ops
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.launch import sharding as sharding_lib
from repro_torch.launch.mesh import (Job, abstract_mesh, dry_mesh,
                                     make_production_mesh, run_jobs)
from repro_torch.launch.op_analysis import OpCounter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("data", "model")
META = torch.device("meta")

#: the rank-side module (written to a temporary directory on sys.path;
#: it imports nothing of jax): the collectives' calls and a cell's live
#: count, through the kernels' path where asked
HELPER = '''
import contextlib
import ctypes
import functools
import types

import torch

from repro_torch import runtime
from repro_torch.runtime import CollectiveCounts

#: (kind, axes) of the collective calls, each forward and backward
CALLS = (("all_gather", "data"), ("all_gather", ("data", "model")),
         ("all_gather_partial", "model"), ("reduce_scatter", "data"),
         ("reduce_scatter", ("data", "model")), ("all_reduce", "model"),
         ("all_reduce_max", ("data", "model")), ("all_to_all", "model"),
         ("enter", ("data", "model")))


def collective_calls(params=None, device="cpu"):
    """Each call of CALLS on the current mesh: (kind, axes, output shape,
    the input's gradient shape), and the mesh's counts of them."""
    mesh = runtime.current_mesh()
    before = mesh.counts.snapshot()
    out = []
    with torch.enable_grad():
        for kind, axes in CALLS:
            grad = kind != "all_reduce_max"
            x = torch.ones((8, 3), device=device, requires_grad=grad)
            if kind == "all_gather_partial":
                y = runtime.all_gather(x, axes, partial=True)
            elif kind == "all_reduce_max":
                y = runtime.all_reduce(x, axes, op="max")
            else:
                y = getattr(runtime, kind)(x, axes)
            if grad:
                (y * 2).sum().backward()
            out.append((kind, str(axes), tuple(y.shape),
                        tuple(x.grad.shape) if grad else None))
    counts = CollectiveCounts.since(mesh.counts.snapshot(), before)
    return out, {f"{k}|{g}": list(v) for (k, g), v in counts.items()}


def fake_card():
    """The kernels' path on CPU tensors: ``on_cpu`` says no, and every C
    entry launches nothing (the counts read shapes and, live, the data
    the costs read); B6's residency query answers 132 x 1."""
    from repro_torch import kernels as K
    from repro_torch.kernels.augru import ops as a
    from repro_torch.kernels.candidate_scorer import ops as c
    from repro_torch.kernels.din_attention import ops as d
    from repro_torch.kernels.embedding_bag import ops as e
    from repro_torch.kernels.flash_decode import ops as f
    from repro_torch.kernels.rerank_score import ops as r

    def residency(bf16, G, D, res, stream):
        got = (ctypes.c_int * 2).from_address(res)
        got[0], got[1] = 132, 1
        return 0
    K.kernel = lambda name, device: (residency if name ==
                                     "flash_decode_residency"
                                     else (lambda *args: 0))
    torch.cuda.device = lambda dev: contextlib.nullcontext()
    torch.cuda.current_stream = lambda dev=None: types.SimpleNamespace(
        cuda_stream=0)
    torch.cuda.current_device = lambda: 0
    for mod in (a, c, d, e, f, r):
        mod.on_cpu = lambda *t: False


def build(arch_id, shape, reduced, mesh, zero_min=None, remat=None):
    """The cell of ``arch_id`` at ``shape`` (a registry name or a
    (name, kind, dims) tuple) on ``mesh``; ``zero_min`` the ZeRO
    split's minimum leaf size (the reduced leaves are far below the
    published one); ``remat`` the config's, where given."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import sharding, specs
    if not hasattr(sharding, "published_zero_specs"):
        sharding.published_zero_specs = sharding.zero_specs
    sharding.zero_specs = (sharding.published_zero_specs if zero_min is None
                           else functools.partial(
                               sharding.published_zero_specs,
                               min_size=zero_min))
    arch = registry.get(arch_id)
    if reduced:
        arch = registry.ArchDef(arch.arch_id, arch.family,
                                arch.reduced(arch.config), arch.shapes,
                                arch.reduced)
    if remat is not None:
        arch = registry.ArchDef(arch.arch_id, arch.family,
                                dataclasses.replace(arch.config, remat=remat),
                                arch.shapes, arch.reduced)
    spec = (ShapeSpec(shape[0], shape[1], dict(shape[2]))
            if isinstance(shape, (tuple, list))
            else registry.get_shape(arch, shape))
    builder = {"lm": specs.build_lm_cell, "gnn": specs.build_gnn_cell,
               "recsys": specs.build_rec_cell}[arch.family]
    return builder(arch, spec, "cpu", mesh=mesh)


def live_count(params=None, arch_id=None, shape=None, reduced=True,
               kernels=False, zero_min=None, remat=None):
    """This rank's cell drawn on the CPU and its call counted twice (the
    second count guards the peak against gloo's worker thread, which may
    let a collective's tensors go a moment after the call returns), with
    its arguments' shapes and bytes."""
    from repro_torch import tree
    from repro_torch.launch.mesh import cell_call
    from repro_torch.launch.op_analysis import count_ops
    if kernels:
        fake_card()
    mesh = runtime.current_mesh()
    cell = build(arch_id, shape, reduced, mesh, zero_min, remat)
    args = cell.materialize("cpu", torch.Generator().manual_seed(0),
                            mesh=mesh)
    leaves = [t for t in tree.leaves(args) if isinstance(t, torch.Tensor)]
    shapes = [list(t.shape) for t in leaves]
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    del leaves
    call, _ = cell_call(cell, args)
    del args
    counts = [count_ops(call)[1] for _ in range(2)]
    return {"counts": counts, "shapes": shapes, "argument_bytes": nbytes}
'''


@pytest.fixture(scope="module")
def helper(tmp_path_factory):
    d = tmp_path_factory.mktemp("dry_helper")
    (d / "dry_helper.py").write_text(HELPER)
    sys.path.insert(0, str(d))
    import dry_helper
    yield dry_helper
    sys.path.remove(str(d))
    sys.modules.pop("dry_helper", None)


# ------------------------------------------------------------ the dry mesh

def test_a_dry_mesh_holds_a_rank_s_coordinates_and_no_group():
    from repro_torch.launch import sharding
    mesh = make_production_mesh(multi_pod=True, rank=300)
    assert mesh.dry and not mesh.abstract and mesh.name == "2x16x16"
    assert mesh.coords == {"pod": 1, "data": 2, "model": 12}
    assert make_production_mesh().abstract
    with pytest.raises(RuntimeError, match="no process groups"):
        mesh.group(("model",))
    with pytest.raises(ValueError):
        dry_mesh((2, 2), AXES, 4)
    with runtime.use_mesh(mesh):
        assert runtime.axis_index("data") == 2
        assert runtime.block(1000, ("data", "model")) == (44 * 4, 4)
        x = torch.empty((64, 32), device=META)
        part = sharding.local_part(x, sharding.P("data", "model"), mesh)
        assert tuple(part.shape) == (4, 2)
        whole = sharding.gather_full(part, sharding.P("data", "model"), mesh)
        assert tuple(whole.shape) == (64, 32) and whole.is_meta


def test_a_dry_mesh_refuses_a_tensor_off_meta_and_rows_that_do_not_split():
    with runtime.use_mesh(dry_mesh((2, 2), AXES, 1)):
        with pytest.raises(RuntimeError, match="not on meta"):
            runtime.all_gather(torch.ones(2, 3), "data")
        with pytest.raises(ValueError, match="does not split"):
            runtime.reduce_scatter(torch.empty((3, 2), device=META), "data")
        with pytest.raises(ValueError, match="does not split"):
            runtime.all_to_all(torch.empty((3, 2), device=META), "model")


def test_dry_collectives_equal_live_ranks_forward_and_backward(helper):
    live = run_jobs([Job("dry_helper:collective_calls",
                         kwargs={"device": "cpu"})], (2, 2), AXES)
    for r in range(4):
        with runtime.use_mesh(dry_mesh((2, 2), AXES, r)):
            dry = helper.collective_calls(device="meta")
        calls, counts = live[r][0]["out"]
        assert [tuple(map(_tuple, c)) for c in calls] == \
            [tuple(map(_tuple, c)) for c in dry[0]]
        assert counts == dry[1], r
        assert any(k.endswith("/bwd|4") for k in counts)


def _tuple(x):
    return tuple(x) if isinstance(x, (list, np.ndarray)) else x


# -------------------------------------------------------- kernels on meta

def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _wrapper_cases():
    """(name, wrapper, plain, meta args, CPU args of the worst data the
    bound takes) at chip_smoke [3]'s shapes (the kernel table's)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)
    B, T, D, H1, H2 = 16, 100, 18, 80, 40
    din = [(B, T, D), (B, T), (B, D), (4 * D, H1), (H1,), (H1, H2), (H2,),
           (H2, 1), (1,)]
    din_cpu = [r(*s) for s in din]
    din_cpu[1] = torch.ones(B, T)                     # every step active
    C, dU, dI, M1, M2 = 64, 18, 18, 80, 40
    towers = [({"w": (4 * D, H1), "b": (H1,)}, {"w": (H1, H2), "b": (H2,)},
               {"w": (H2, 1), "b": (1,)}),
              ({"w": (2 * D + dU + dI, M1), "b": (M1,)},
               {"w": (M1, M2), "b": (M2,)}, {"w": (M2, 1), "b": (1,)})]

    def tower(dev):
        return [[{k: (_m(*v) if dev == "meta" else r(*v))
                  for k, v in layer.items()} for layer in t] for t in towers]
    rerank = [(T, D), (T,), (C, D), (dU,), (C, dI)]
    rerank_cpu = [r(*s) for s in rerank]
    rerank_cpu[1] = torch.ones(T)
    # B3: a DIN micro-batch's lookups, every id a distinct row
    bags = [((1 << 26, 18), (1600, 1)), ((1 << 26, 18), (16, 1)),
            ((1 << 20, 18), (16, 4)), ((1 << 26, 18), (16, 1)),
            ((1 << 20, 18), (16, 1))]
    groups_meta = [(_m(*t), _m(*i, dtype=torch.int64), None, "sum")
                   for t, i in bags]
    groups_cpu = [(_m(*t), torch.arange(int(np.prod(i))).reshape(i), None,
                   "sum") for t, i in bags]
    Bd, S, Hd, Gd, Dd = 4, 64, 3, 3, 64
    return [
        ("din_attention", din_ops.din_attention, din_attention_ref,
         [_m(*s) for s in din], din_cpu),
        ("rerank_score", rerank_ops.rerank_score, rerank_ops.rerank_score_plain,
         [_m(*s) for s in rerank] + tower("meta"), rerank_cpu + tower("cpu")),
        ("embedding_bag", bag_ops.embedding_bag, embedding_bag_ref,
         [_m(1 << 26, 18), _m(1600, 1, dtype=torch.int64)],
         [_m(1 << 26, 18), torch.arange(1600).reshape(1600, 1)]),
        ("embedding_bag", bag_ops.embedding_bag_group, embedding_bag_group_ref,
         [groups_meta], [groups_cpu]),
        ("augru", augru_ops.augru, augru_ref,
         [_m(64, 100, 36), _m(64, 100), _m(36, 324), _m(108, 324), _m(324)],
         [_m(64, 100, 36), _m(64, 100), _m(36, 324), _m(108, 324), _m(324)]),
        ("candidate_scorer", scorer_ops.candidate_scorer, candidate_scorer_ref,
         [_m(1_000_000, 256), _m(256), 64], [_m(1_000_000, 256), _m(256), 64]),
        ("flash_decode", decode_ops.flash_decode, flash_decode_ref,
         [_m(Bd, Hd, Gd, Dd), _m(Bd, S, Hd, Dd), _m(Bd, S, Hd, Dd),
          torch.empty((), dtype=torch.int32, device=META)],
         [_m(Bd, Hd, Gd, Dd), _m(Bd, S, Hd, Dd), _m(Bd, S, Hd, Dd),
          torch.tensor(S, dtype=torch.int32)]),
    ]


@pytest.mark.parametrize("case", range(7), ids=[
    "din_attention", "rerank_score", "embedding_bag", "embedding_bag_group",
    "augru", "candidate_scorer", "flash_decode"])
def test_a_wrapper_on_meta_gives_the_plain_shapes_and_hands_its_cost(case):
    name, wrapper, plain, args, worst = _wrapper_cases()[case]
    want = K._outputs(plain(*args))
    K.reset_launches()
    with OpCounter() as counter:
        got = K._outputs(wrapper(*args))
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.is_meta for t in got)
    assert sum(K.launch_counts().values()) == 0
    kernels = counter.summary()["kernels"]
    assert kernels[name]["launches"] == 1
    ops = {"din_attention": din_ops, "rerank_score": rerank_ops,
           "embedding_bag": bag_ops, "augru": augru_ops,
           "candidate_scorer": scorer_ops, "flash_decode": decode_ops}[name]
    if name == "embedding_bag":
        lookups = ([tuple(worst[:2]) + (None,)] if wrapper is
                   bag_ops.embedding_bag else worst[0])
        want_cost = ops.cost(lookups)
    elif name == "flash_decode":
        want_cost = ops.cost(*worst[:3], int(worst[3]))
    elif name == "rerank_score":
        want_cost = ops.cost(*worst[:5], *rerank_ops._weights(*worst[5:]))
    else:
        want_cost = ops.cost(*worst)
    assert (kernels[name]["flops"], kernels[name]["bytes"]) == want_cost
    bounded = counter.summary()["bounded_kernels"]
    assert (name in bounded) == (name in ("din_attention", "rerank_score",
                                          "embedding_bag", "flash_decode"))


def test_a_wrapper_refuses_mixed_meta_and_cpu_inputs():
    args = _wrapper_cases()[0][3]
    args[2] = torch.zeros(16, 18)
    with pytest.raises(ValueError, match="unsupported devices"):
        din_ops.din_attention(*args)
    assert K.on_cpu(_m(2)) is False and K.on_cpu(torch.ones(1)) is True
    with pytest.raises(ValueError):
        K.on_cpu(_m(2), torch.ones(1))


# -------------------------------------------------------------------- MoE

def test_moe_static_dispatch_equals_reference_with_capacity_overflowing():
    """64 tokens x top-2 over 8 experts at capacity factor 0.5: 128 pairs
    for 8 x 8 slots, so at least half the pairs drop."""
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig as JaxMoE
    from repro.models.moe import moe_apply as jax_moe_apply
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import _capacity, moe_apply
    rng = np.random.default_rng(3)
    d, E, f = 16, 8, 24
    p = {"router": rng.normal(size=(d, E)).astype(np.float32),
         "w1": rng.normal(size=(E, d, f)).astype(np.float32) / 4,
         "w3": rng.normal(size=(E, d, f)).astype(np.float32) / 4,
         "w2": rng.normal(size=(E, f, d)).astype(np.float32) / 5}
    x = rng.normal(size=(4, 16, d)).astype(np.float32)
    kw = dict(n_routed=E, top_k=2, d_ff_expert=f, capacity_factor=0.5)
    assert E * _capacity(64, MoEConfig(**kw)) < 64 * 2
    want, want_aux = jax_moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), JaxMoE(**kw))
    got, aux = moe_apply({k: torch.as_tensor(v) for k, v in p.items()},
                         torch.as_tensor(x), MoEConfig(**kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=2e-5)


# ------------------------------------------------------ dry = live, (2, 2)

#: (id, arch, shape, reduced, kernels' path, ZeRO-2 minimum leaf size)
LIVE_CELLS = [
    ("din_serve_p99", "din", "serve_p99", True, True, None),
    ("dien_serve_p99", "dien", "serve_p99", True, True, None),
    ("din_train", "din", ("train_small", "rec_train", {"batch": 512}), True,
     True, None),
    ("schnet_molecule", "schnet", "molecule", True, False, None),
    ("smollm_decode", "smollm-135m",
     ("decode_small", "decode", {"seq_len": 256, "global_batch": 4}), True,
     True, None),
    ("smollm_train_zero2", "smollm-135m",
     ("train_small", "train", {"seq_len": 64, "global_batch": 8}), True,
     False, 64),
    ("deepseek_prefill_ep", "deepseek-v2-lite-16b",
     ("prefill_small", "prefill", {"seq_len": 32, "global_batch": 4}), True,
     False, None),
    ("deepseek_train_zero3", "deepseek-v3-671b",
     ("train_small", "train", {"seq_len": 16, "global_batch": 8}), True,
     False, 64),
]
#: the ZeRO-3 live cell (``fsdp_params``, the split carry) trains as
#: published, remat on (the reduced config turns it off)
ZERO3_LIVE = {"deepseek_train_zero3"}


@pytest.fixture(scope="module")
def live_2x2(helper):
    jobs = [Job("dry_helper:live_count",
                kwargs={"arch_id": a, "shape": s, "reduced": red,
                        "kernels": kern, "zero_min": zm,
                        "remat": True if name in ZERO3_LIVE else None})
            for name, a, s, red, kern, zm in LIVE_CELLS]
    ranks = run_jobs(jobs, (2, 2), AXES, timeout=400)
    return {c[0]: [rank[i]["out"] for rank in ranks]
            for i, c in enumerate(LIVE_CELLS)}


def _outside(summary, bounded):
    kern = {k: (v["flops"], v["bytes"]) for k, v in summary["kernels"].items()
            if k in bounded}
    return (summary["flops_per_device"] - sum(f for f, _ in kern.values()),
            summary["bytes_per_device"] - sum(b for _, b in kern.values()),
            kern)


@pytest.mark.parametrize("cell", [c[0] for c in LIVE_CELLS])
def test_every_rank_s_dry_count_equals_a_live_run(cell, helper, live_2x2):
    _, arch, shape, reduced, kernels, zero_min = next(
        c for c in LIVE_CELLS if c[0] == cell)
    built = helper.build(arch, shape, reduced, abstract_mesh((2, 2), AXES),
                         zero_min, True if cell in ZERO3_LIVE else None)
    try:
        for r, live in enumerate(live_2x2[cell]):
            mesh = dry_mesh((2, 2), AXES, r)
            shapes = [list(t.shape) for t in tree_lib.leaves(
                built.local_args(mesh)) if isinstance(t, torch.Tensor)]
            assert shapes == [list(s) for s in live["shapes"]], r
            assert built.arg_bytes_per_device() == live["argument_bytes"]
            dry = dryrun.dry_count(built, mesh)
            assert dry["argument_bytes"] == live["argument_bytes"]
            first = live["counts"][0]
            bounded = set(dry["bounded_kernels"])
            assert bounded <= {"embedding_bag", "din_attention",
                               "rerank_score", "flash_decode"}
            assert dry["collectives_by_kind"] == first["collectives_by_kind"]
            assert dry["collectives_by_group"] == first["collectives_by_group"]
            assert dry["top_ops"] == first["top_ops"]
            assert ({k: v["launches"] for k, v in dry["kernels"].items()} ==
                    {k: v["launches"] for k, v in first["kernels"].items()})
            assert bool(dry["kernels"]) == kernels
            df, db, dk = _outside(dry, bounded)
            lf, lb, lk = _outside(first, bounded)
            assert (df, db) == (lf, lb), r
            for k, (f, b) in dk.items():
                assert f >= lk[k][0] and b >= lk[k][1], (k, (f, b), lk[k])
            if zero_min is not None:        # the ZeRO shards over data:
                # ZeRO-2's gradients reduce-scattered by the step, ZeRO-3's
                # by its gathers' backward
                kind = ("reduce_scatter/bwd" if cell in ZERO3_LIVE
                        else "reduce_scatter")
                assert any(g["kind"] == kind and g["axes"] == ["data"]
                           for g in dry["collectives_by_group"])
            if not kernels:
                assert dry["flops_per_device"] == first["flops_per_device"]
                assert dry["peak_bytes"] == min(
                    c["peak_bytes"] for c in live["counts"]), r
    finally:
        from repro_torch.launch import sharding
        sharding.zero_specs = sharding.published_zero_specs


# ------------------------------------------- flops against the reference

#: (id, arch, shape, the bound on dry / reference - 1, the ops it names)
REF_CELLS = [
    ("smollm_prefill", "smollm-135m",
     ("p", "prefill", {"seq_len": 64, "global_batch": 4}), 0.2717),
    ("qwen3_prefill", "qwen3-8b",
     ("p", "prefill", {"seq_len": 64, "global_batch": 4}), 0.2717),
    ("deepseek_prefill", "deepseek-v2-lite-16b",
     ("p", "prefill", {"seq_len": 64, "global_batch": 4}), 0.0605),
    ("smollm_train", "smollm-135m",
     ("t", "train", {"seq_len": 64, "global_batch": 8}), 0.0694),
    ("schnet_molecule", "schnet", "molecule", 0.0014),
    ("deepseek_train", "deepseek-v3-671b",
     ("t", "train", {"seq_len": 64, "global_batch": 8}), 0.0825),
]
#: the cells built other than as the registry's reduced config: the
#: reduced deepseek-v3 as published trains, remat on (the reduced config
#: turns it off), ZeRO-3 and the split carry as published, ZeRO at
#: ZERO_MIN elements so that its reduced leaves do shard
ZERO_MIN = 64
REF_OPTS = {"deepseek_train": {"remat": True, "zero_min": ZERO_MIN}}
#: Why each bound (ROADMAP.md §C): the port computes a projection whose
#: weight is replicated over ``model`` for every token of the rank on
#: every model rank, where GSPMD splits those tokens over ``model`` and
#: gathers the result: GQA's ``wk`` / ``wv`` where the kv heads (2 at
#: reduced widths) do not split over a model axis of 4 (the port's
#: 2 x (128, 64) @ (64, 32) products a layer against the reference's
#: 2 x (32, 64) @ (64, 32)), and MLA's ``wkv_a`` (the port's (128, 64)
#: @ (64, 40) against the reference's (32, 64) @ (64, 40)), in the
#: backward too where the step trains. SchNet: the readout's (3840, 1) @
#: (1, 8) product, which XLA turns into a broadcast multiply (no dot).
#: deepseek_train (ZeRO-3, the split carry, remat): the same for every
#: projection whose weight is replicated over ``model`` (MLA's ``wkv_a``
#: and ``wq_a``, the MoE router, the MTP's ``proj``), in the forward, the
#: remat's recompute and the backward: 0.08243 at rank 0.

REF_SCRIPT = r"""
import dataclasses, functools, json, sys
import numpy as np
import repro.launch.dryrun                  # REPRO_DRYRUN_DEVICES=8 first
import jax
from jax.sharding import NamedSharding, PartitionSpec
from repro import runtime
from repro.configs import registry
from repro.configs.base import ShapeSpec
from repro.launch import sharding, specs
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_mesh
mesh = make_mesh((2, 4), ("data", "model"))
published = sharding.zero_specs
out = {}
for name, arch_id, shape, opts in json.loads(sys.argv[1]):
    a = registry.get(arch_id)
    cfg = a.reduced(a.config)
    if "remat" in opts:
        cfg = dataclasses.replace(cfg, remat=opts["remat"])
    a = registry.ArchDef(a.arch_id, a.family, cfg, a.shapes, a.reduced)
    sh = (ShapeSpec(shape[0], shape[1], dict(shape[2]))
          if isinstance(shape, list) else registry.get_shape(a, shape))
    build = {"lm": specs.build_lm_cell, "gnn": specs.build_gnn_cell,
             "recsys": specs.build_rec_cell}[a.family]
    sharding.zero_specs = (functools.partial(published,
                                             min_size=opts["zero_min"])
                           if "zero_min" in opts else published)
    with runtime.use_mesh(mesh):
        cell = build(a, sh, mesh)
        text = cell.jitted(mesh).lower(*cell.args).compile().as_text()
    out[name] = {"flops": analyze_hlo(text, 8)["flops_per_device"]}
    if opts:                  # each argument's shard shapes on a device
        is_spec = lambda x: isinstance(x, PartitionSpec)
        shards = [[list(NamedSharding(mesh, sp).shard_shape(leaf.shape))
                   for leaf, sp in zip(jax.tree.leaves(arg), jax.tree.leaves(
                       spec, is_leaf=is_spec))]
                  for arg, spec in zip(cell.args, cell.in_specs)]
        out[name]["shards"] = shards
        # AdamW's state: the step, then m and v in the parameters' order;
        # True where opt_state_specs gave a leaf its own parameter's spec
        # (it infers them by shape)
        ps = jax.tree.leaves(cell.in_specs[0], is_leaf=is_spec)
        st = jax.tree.leaves(cell.in_specs[1], is_leaf=is_spec)[1:]
        out[name]["state_own"] = [a == b for a, b in zip(st, ps + ps)]
print("REF" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_2x4():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", REPRO_DRYRUN_DEVICES="8")
    p = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REF_SCRIPT),
         json.dumps([[n, a, s, REF_OPTS.get(n, {})]
                     for n, a, s, _ in REF_CELLS])],
        capture_output=True, text=True, env=env, timeout=400, cwd=ROOT)
    assert p.returncode == 0 and "REF" in p.stdout, p.stderr[-3000:]
    return json.loads(p.stdout.split("REF")[-1])


@pytest.mark.parametrize("cell", [c[0] for c in REF_CELLS])
def test_flops_per_device_at_2x4_against_the_reference_hlo(cell, helper,
                                                           ref_2x4):
    _, arch, shape, bound = next(c for c in REF_CELLS if c[0] == cell)
    built = helper.build(arch, shape, True, abstract_mesh((2, 4), AXES),
                         **REF_OPTS.get(cell, {}))
    want = ref_2x4[cell]["flops"]
    try:
        for r in (0, 7):
            got = dryrun.dry_count(built, dry_mesh((2, 4), AXES, r))
            ratio = got["flops_per_device"] / want - 1
            # the port never counts less than the reference: it drops no
            # work
            assert 0 <= ratio <= bound, (r, got["flops_per_device"], want)
    finally:
        from repro_torch.launch import sharding
        sharding.zero_specs = sharding.published_zero_specs


def test_zero3_argument_bytes_at_2x4_are_the_reference_shards(helper,
                                                             ref_2x4):
    """The reduced deepseek-v3 training cell in the reference's ZeRO-3
    layout at (2, 4): every rank's parameters hold the reference's shard
    shapes (``NamedSharding(mesh, spec).shard_shape`` of each leaf by the
    cell's ``in_specs``), leaf by leaf, and so their bytes; its tokens
    the reference's shard (the port's ids are int64); and its AdamW
    state the reference's shards wherever the reference's
    ``opt_state_specs``, which infers a state leaf's spec by its shape,
    gave it its own parameter's spec. At reduced widths leaves of one
    shape take another's (the norms' (3, 64) scales a (3, 64) leaf's
    split over ``model``, 64 x 64 squares each other's): a layout GSPMD
    reshards to and no rank of the port holds (its state is drawn on its
    own blocks, ``Cell.init_local``)."""
    ref = ref_2x4["deepseek_train"]
    params_ref, state_ref, tokens_ref = ref["shards"]
    built = helper.build("deepseek-v3-671b", REF_CELLS[-1][2], True,
                         abstract_mesh((2, 4), AXES), **REF_OPTS[
                             "deepseek_train"])
    own = [True] + ref["state_own"]                  # the step: a scalar
    assert 0 < sum(own) < len(own)
    try:
        for r in range(8):
            params, state, tokens = built.local_args(dry_mesh((2, 4), AXES, r))
            leaves = tree_lib.leaves(params)
            assert [list(t.shape) for t in leaves] == params_ref, r
            assert specs.tree_bytes(params) == sum(
                int(np.prod(s)) * t.element_size()
                for s, t in zip(params_ref, leaves))
            got = [list(t.shape) for t in tree_lib.leaves(state)]
            assert len(got) == len(state_ref)
            assert [g for g, o in zip(got, own) if o] == \
                [w for w, o in zip(state_ref, own) if o], r
            assert [list(tokens.shape)] == tokens_ref, r
    finally:
        from repro_torch.launch import sharding
        sharding.zero_specs = sharding.published_zero_specs


def test_doubling_the_data_axis_halves_a_rank_s_zero3_bytes(helper):
    """A dry rank of the reduced deepseek-v3 training cell (ZeRO-3) at
    (4, 2) holds half the bytes of each ZeRO-3 leaf it holds at (2, 2),
    for every leaf whose chosen dim divides 4 (the same dim is chosen on
    both meshes); the leaves whose spec names no ``data`` hold the
    same."""
    shape = REF_CELLS[-1][2]
    held = {}
    try:
        for dims in ((2, 2), (4, 2)):
            built = helper.build("deepseek-v3-671b", shape, True,
                                 abstract_mesh(dims, AXES), zero_min=ZERO_MIN,
                                 remat=True)
            nodes = []
            tree_lib.tree_map(lambda _l, sp: nodes.append(sp), built.args[0],
                              built.in_specs[0])
            local = built.local_args(dry_mesh(dims, AXES, 0))[0]
            held[dims] = [(sp, t.numel() * t.element_size()) for sp, t in
                          zip(nodes, tree_lib.leaves(local))]
    finally:
        from repro_torch.launch import sharding
        sharding.zero_specs = sharding.published_zero_specs
    halved = 0
    whole = [t.shape for t in tree_lib.leaves(built.args[0])]
    for (sp2, b2), (sp4, b4), full in zip(held[(2, 2)], held[(4, 2)], whole):
        if isinstance(sp2, sharding_lib.Gathered):
            if full[sp2.data_dim] % 4 == 0:
                assert isinstance(sp4, sharding_lib.Gathered)
                assert sp4.data_dim == sp2.data_dim
                assert 2 * b4 == b2, (sp2, sp4)
                halved += 1
        elif not any("data" in sharding_lib.entry_axes(e) for e in sp2):
            assert not isinstance(sp4, sharding_lib.Gathered)
            assert b4 == b2, sp2
    assert halved > 0


# ------------------------------------------------------ production records

@pytest.mark.parametrize("arch,shape", [("din", "serve_p99"),
                                        ("schnet", "molecule"),
                                        ("smollm-135m", "decode_32k")])
def test_one_cell_a_family_on_both_production_meshes(arch, shape, tmp_path):
    for multi_pod, mesh in ((False, "16x16"), (True, "2x16x16")):
        rec = dryrun.dry_run_cell(arch, shape, multi_pod, str(tmp_path))
        assert rec["ok"], rec.get("traceback")
        assert rec["mesh"] == mesh and rec["device"] == "meta"
        assert [r["rank"] for r in rec["ranks"]] == [0, rec["n_devices"] - 1]
        mem = rec["memory"]
        assert mem["argument_bytes_per_device"] == rec["arg_bytes_per_device"]
        assert mem["peak_bytes_per_device"] > mem["argument_bytes_per_device"]
        assert mem["fits_h100"] is True
        assert rec["ops"]["flops_per_device"] > 0
        assert rec["ops"]["collective_bytes_per_device"] > 0
        with open(tmp_path / f"{arch}__{shape}__{mesh}@meta.json") as f:
            assert json.load(f)["ok"]
        rows = [roofline.analyze_row(r) for r in roofline.load(
            str(tmp_path), roofline.PRODUCTION[mesh])]
        assert len(rows) == 1 and rows[0]["modelled"]
        assert rows[0]["collective_s"] > 0 and rows[0]["step_s"] is None
        assert rows[0]["dominant"] in ("compute", "memory", "collective")
        table = roofline.production_table(rows).splitlines()
        assert len(table) == 3 and table[2].startswith(f"| {arch} | {shape} |")
        assert " NO " not in table[2] and rows[0]["dominant"] in table[2]


def test_the_cli_writes_a_production_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "schnet", "--shape", "molecule",
                        "--production", "--multi-pod", "--out",
                        str(tmp_path)], capture_output=True, text=True,
                       env=env, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    with open(tmp_path / "schnet__molecule__2x16x16@meta.json") as f:
        rec = json.load(f)
    assert rec["ok"] and rec["n_devices"] == 512


def test_a_refused_kernel_shape_is_recorded_and_the_sweep_goes_on(
        tmp_path, monkeypatch):
    monkeypatch.setattr(din_ops, "MAX_H1", 8)
    rec = dryrun.dry_run_cell("din", "serve_p99", out_dir=str(tmp_path),
                              mesh=(2, 2), reduced=True)
    assert not rec["ok"] and "exceeds the kernel's tiles" in rec["error"]
    with open(tmp_path / "din__serve_p99__2x2@meta.json") as f:
        assert "traceback" in json.load(f)
    nxt = dryrun.dry_run_cell("schnet", "molecule", out_dir=str(tmp_path),
                              mesh=(2, 2), reduced=True)
    assert nxt["ok"]


def test_a_group_crosses_nodes_where_its_ranks_span_eight():
    assert roofline.crosses_nodes((16, 16), AXES, ("model",))
    assert roofline.crosses_nodes((16, 16), AXES, ("data",))
    assert not roofline.crosses_nodes((2, 4), AXES, ("model",))
    assert not roofline.crosses_nodes((2, 4), AXES, ("data", "model"))
    assert roofline.crosses_nodes((4, 4), AXES, ("data", "model"))
    rec = {"mesh": "16x16", "axes": list(AXES), "ops": {
        "collectives_by_group": [
            {"axes": ["model"], "traffic_bytes": 50e9},
            {"axes": ["data", "model"], "traffic_bytes": 100e9}]}}
    assert roofline.collective_s(rec) == pytest.approx(3.0)
