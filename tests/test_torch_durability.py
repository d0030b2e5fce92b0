"""The port's update, durability and scale-out planes against the reference.

  * ``HBMHead`` (device table in torch, membership in host numpy) and
    ``sparse.sharded.sharded_row_update`` give the reference's tables,
    maps, free lists and stats, exactly;
  * snapshots written by either package load in the other with equal rows
    and meta; torn ones are skipped; a sharded (mesh) snapshot makes the
    round trip;
  * the DIN ``InferenceService`` with an HBM head, live updates from one
    delta log, snapshots, a graceful shutdown and two recoveries (with and
    without a delta suffix) gives the reference's scores (2e-5), update
    and head stats, recovered cube rows and replay counts, and so does a
    recovered ``MultiScenarioService``;
  * the mesh cube tier returns the reference's rows and tiers;
  * the recsys launcher gives the reference's figures and metric names;
  * the IRM offline tuner finds the reference's plan over a history the
    port recorded.

Everything is driven without wall-clock waits: watchers by
``check_once()``, services on the SimExecutor. Both packages run on the
CPU; the reference's weights are carried into the port through numpy.
"""
import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import signal

import jax
import numpy as np
import pytest
import torch

import repro.core.service as jax_service_mod
from repro import faults as jax_faults
from repro.core.executors import SimExecutor as JaxSimExecutor
from repro.core.irm import offline as jax_offline
from repro.core.service import InferenceService as JaxInferenceService
from repro.core.service import MultiScenarioService as JaxMultiService
from repro.core.service import MultiServiceConfig as JaxMultiServiceConfig
from repro.core.service import ServiceConfig as JaxServiceConfig
from repro.core.service_model import SERVICES as JAX_SERVICES
from repro.launch import serve as jax_serve
from repro.obs import get_registry as jax_get_registry
from repro.serve.scenario import ServingSubstrate as JaxSubstrate
from repro.serve.scenario import SubstrateDeltaWatcher as JaxWatcher
from repro.serve.scenario import get_scenario as jax_get_scenario
from repro.sparse.hashing import signature_np as jax_signature_np
from repro.sparse.sharded import sharded_row_update as jax_row_update
from repro.update import CubeSnapshotter as JaxSnapshotter
from repro.update import DeltaBatch as JaxDeltaBatch
from repro.update import DeltaEmitter as JaxDeltaEmitter
from repro.update import GroupDelta as JaxGroupDelta
from repro.update import HBMHead as JaxHead
from repro.update import snapshot as jax_snapshot
from repro_torch import faults
from repro_torch.convert import params_from_numpy
from repro_torch.core.executors import SimExecutor
from repro_torch.core.irm import offline
from repro_torch.core.irm.shedding import PruningDNN
from repro_torch.core.service import (InferenceService, MultiScenarioService,
                                      MultiServiceConfig, ServiceConfig)
from repro_torch.core.service_model import SERVICES
from repro_torch.launch import serve
from repro_torch.obs import get_registry
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.scenario import (ServingSubstrate,
                                        SubstrateDeltaWatcher, get_scenario)
from repro_torch.sparse.hashing import signature_np
from repro_torch.sparse.sharded import sharded_row_update
from repro_torch.update import (CubeSnapshotter, DeltaBatch, DeltaEmitter,
                                GroupDelta, HBMHead)
from repro_torch.update import snapshot

TOL = dict(rel=2e-5, abs=2e-5)          # tests/test_rerank_fused.py
DIM = 8
HEAD_STATS = ("promotions", "demotions", "inplace_updates", "hits", "misses",
              "scatters")


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------- HBM head

def _head_state(head) -> dict:
    return {"table": _np(head.table), "sigs": head._map[0].copy(),
            "slots": head._map[1].copy(), "free": list(head._free),
            "stats": {k: getattr(head.stats, k) for k in HEAD_STATS}}


def _assert_heads_equal(ref, port, loose_slots=()):
    """Equal membership and stats, and equal table rows but at the slots
    one call scattered twice, where the reference promises no order."""
    want, got = _head_state(ref), _head_state(port)
    np.testing.assert_array_equal(got["sigs"], want["sigs"])
    np.testing.assert_array_equal(got["slots"], want["slots"])
    assert got["free"] == want["free"]
    assert got["stats"] == want["stats"]
    exact = np.setdiff1d(np.arange(ref.n_slots), list(loose_slots))
    np.testing.assert_array_equal(got["table"][exact], want["table"][exact])


def _twice_scattered(ref, group, ids, rows) -> dict:
    """Slots a ``promote`` of (ids, rows) scatters more than once (an id
    resident and repeated): slot -> the candidate rows."""
    slots, found = ref._resolve(np.asarray(jax_signature_np(group, ids)))
    out: dict = {}
    for s, r in zip(slots[found], rows[found]):
        out.setdefault(int(s), []).append(r)
    return {s: rs for s, rs in out.items() if len(rs) > 1}


@pytest.mark.parametrize("seed", range(6))
def test_hbm_head_matches_reference_on_random_sequences(seed):
    """Random promote / update_rows / demote / lookup over three groups,
    with repeated ids and the head driven to capacity: every call returns
    the reference's answer and leaves its table, map, free list and stats.
    A slot that one promote scatters twice may hold any of its rows (the
    reference's scatter promises no order): it must hold one of them, and
    the port's copy is then set to the reference's before going on."""
    rng = np.random.default_rng(seed)
    n_slots = int(rng.integers(8, 40))
    ref = JaxHead(n_slots, DIM)
    port = HBMHead(n_slots, DIM, device="cpu")
    assert port.table.device.type == "cpu"
    for _step in range(60):
        op = rng.choice(["promote", "update", "demote", "lookup"],
                        p=[0.35, 0.25, 0.15, 0.25])
        group = int(rng.integers(0, 3))
        ids = rng.integers(0, 48, int(rng.integers(0, 24)))
        rows = rng.standard_normal((ids.size, DIM)).astype(np.float32)
        loose = {}
        if op == "promote":
            loose = _twice_scattered(ref, group, ids, rows)
            assert port.promote(group, ids, rows) == \
                ref.promote(group, ids, rows)
        elif op == "update":
            assert port.update_rows(group, ids, rows) == \
                ref.update_rows(group, ids, rows)
        elif op == "demote":
            assert port.demote(group, ids) == ref.demote(group, ids)
        else:
            got, gf = port.lookup(group, ids)
            want, wf = ref.lookup(group, ids)
            np.testing.assert_array_equal(gf, wf)
            np.testing.assert_array_equal(got, want)
        _assert_heads_equal(ref, port, loose)
        want = np.asarray(ref.table)
        for s, cands in loose.items():
            assert any((port.table[s].numpy() == c).all() for c in cands)
            port.table[s] = torch.from_numpy(want[s].copy())
    assert port.stats.promotions > 0 and port.stats.inplace_updates > 0


def test_hbm_head_update_rows_is_last_wins():
    """A repeated id in one delta lands its last row, in both packages."""
    ref, port = JaxHead(4, DIM), HBMHead(4, DIM, device="cpu")
    ids = np.array([3, 7])
    rows = np.zeros((2, DIM), np.float32)
    for h in (ref, port):
        h.promote(0, ids, rows)
    upd = np.arange(4 * DIM, dtype=np.float32).reshape(4, DIM)
    rep = np.array([7, 3, 7, 7])
    assert port.update_rows(0, rep, upd) == ref.update_rows(0, rep, upd) == 2
    _assert_heads_equal(ref, port)
    got, _ = port.lookup(0, ids)
    np.testing.assert_array_equal(got, [upd[1], upd[3]])


# the reference's own cases (tests/test_update_stream.py), on the port

def test_hbm_head_promote_lookup_update_demote(rng):
    head = HBMHead(n_slots=8, dim=DIM, device="cpu")
    ids = np.array([3, 5, 9])
    rows = rng.normal(size=(3, DIM)).astype(np.float32)
    assert head.promote(0, ids, rows) == 3
    got, found = head.lookup(0, np.array([3, 5, 9, 11]))
    assert found.tolist() == [True, True, True, False]
    np.testing.assert_allclose(got[:3], rows, rtol=1e-6)
    assert (got[3] == 0).all()
    upd = np.full((2, DIM), 4.0, np.float32)
    assert head.update_rows(0, np.array([5, 77]), np.stack([upd[0], upd[1]])) == 1
    got, _ = head.lookup(0, np.array([5]))
    np.testing.assert_array_equal(got[0], upd[0])
    assert head.demote(0, np.array([3])) == 1
    assert not head.resident(0, np.array([3]))[0]
    assert head.promote(0, np.array([21]), rows[:1]) == 1
    assert head.resident_count == 3


def test_hbm_head_capacity_bounded(rng):
    head = HBMHead(n_slots=4, dim=DIM, device="cpu")
    rows = rng.normal(size=(6, DIM)).astype(np.float32)
    assert head.promote(0, np.arange(6), rows) == 4
    assert head.resident_count == 4


def test_hbm_head_groups_do_not_collide():
    head = HBMHead(n_slots=8, dim=DIM, device="cpu")
    head.promote(0, np.array([1]), np.full((1, DIM), 1.0, np.float32))
    assert head.resident(0, np.array([1]))[0]
    assert not head.resident(1, np.array([1]))[0]


def test_hbm_head_lookup_holds_the_writer_lock():
    """A lookup resolves and gathers under the writer lock: with the lock
    held by a writer, it does not get past the resolve."""
    head = HBMHead(n_slots=4, dim=DIM, device="cpu")
    head.promote(0, np.array([1]), np.ones((1, DIM), np.float32))
    calls = []
    real = head._resolve

    def resolve(sigs):
        calls.append(head._lock.locked())
        return real(sigs)

    head._resolve = resolve
    head.lookup(0, np.array([1]))
    assert calls == [True]


# -------------------------------------------------------- row update

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_row_update_matches_reference(dtype, rng):
    """In-place scatter on one device: negative ids count from the end,
    ids outside [-n, n) drop (the reference's ``mode="drop"``), rows take
    the table's dtype, and empty ids leave the table as it was."""
    n = 16
    base = rng.standard_normal((n, DIM)).astype(np.float32)
    ids = np.array([0, 5, -1, 16, -17, 40, 9, -3])
    rows = rng.standard_normal((ids.size, DIM))            # float64 rows
    jt = jax.numpy.asarray(base, dtype)
    tt = torch.from_numpy(base).to(getattr(torch, dtype))
    want = np.asarray(jax_row_update(jt, ids, rows), np.float32)
    out = sharded_row_update(tt, ids, rows)
    assert out is tt and out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(out.float().numpy(), want)
    before = tt.clone()
    assert sharded_row_update(tt, np.empty(0, np.int64),
                              np.empty((0, DIM))) is tt
    assert torch.equal(tt, before)


def test_sharded_row_update_refuses_a_mesh(rng):
    """On a (1, 4) mesh of gloo ranks (the table's rows over ``model``; it
    no longer refuses a mesh) each rank writes only the rows it owns: ids
    on every shard edge land where the reference's one-device scatter puts
    them, none wraps into another shard's tail, and an id past the table
    is dropped."""
    from repro_torch.launch.mesh import Job, run_jobs
    from repro_torch.launch.sharding import P, Table
    base = rng.standard_normal((32, DIM)).astype(np.float32)
    ids = np.array([0, 7, 8, 15, 16, 23, 24, 31, 40])
    rows = rng.standard_normal((ids.size, DIM)).astype(np.float32)
    want = np.asarray(jax_row_update(jax.numpy.asarray(base), ids, rows))
    job = Job("repro_torch.sparse.sharded:sharded_row_update", base,
              Table("model", None), (ids, rows), (None, None),
              out_specs=P("model", None))
    for rank in run_jobs([job], (1, 4), timeout=150):
        np.testing.assert_array_equal(rank[0]["out"], want)


# -------------------------------------------------------------- snapshots

GROUPS = [("item_id", 200), ("cat", 100)]
NODE_KW = dict(cube_cache_ratio=0.05, tail_dim=4, n_servers=4,
               replication=2, block_rows=64, compact_after_blocks=2, seed=3)


def _node(pkg):
    sub = (JaxSubstrate if pkg == "ref" else ServingSubstrate)(**NODE_KW)
    for name, vocab in GROUPS:
        sub.group_for(name, vocab)
    return sub


def _delta_groups(rng, group_cls, upserts=48, deletes=4):
    return [group_cls(
        group=gid, ids=rng.choice(vocab, upserts, replace=False),
        rows=rng.standard_normal((upserts, 4)).astype(np.float32),
        delete_ids=rng.choice(vocab, deletes, replace=False))
        for gid, (_n, vocab) in enumerate(GROUPS)]


def _cube_state(cube, groups=GROUPS) -> list:
    return [cube.lookup_ex(gid, np.arange(vocab))
            for gid, (_n, vocab) in enumerate(groups)]


def _assert_cube_states_equal(x, y):
    for (rx, tx), (ry, ty) in zip(x, y):
        np.testing.assert_array_equal(rx, ry)
        np.testing.assert_array_equal(tx, ty)


def _streamed_node(pkg, root, seed=0, n=4):
    """A substrate with a snapshotter that applied ``n`` seeded deltas
    through its watcher, then snapshotted. Returns (sub, path)."""
    emit_cls, group_cls, snap_cls, watch_cls = (
        (JaxDeltaEmitter, JaxGroupDelta, JaxSnapshotter, JaxWatcher)
        if pkg == "ref" else
        (DeltaEmitter, GroupDelta, CubeSnapshotter, SubstrateDeltaWatcher))
    sub = _node(pkg)
    log, sd = str(root / f"{pkg}_log"), str(root / f"{pkg}_snaps")
    snap = snap_cls(sub, sd, every_deltas=100, delta_log_dir=log)
    w = watch_cls(sub, log, snapshotter=snap)
    em, rng = emit_cls(log), np.random.default_rng(seed)
    for _ in range(n):
        em.emit(_delta_groups(rng, group_cls))
        w.check_once()
    sub.cube.compact()
    return sub, snap.snapshot(force=True)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_snapshot_loads_in_the_other_package(writer, tmp_path):
    """A snapshot written by one package verifies and loads in both, with
    the writer's rows and tiers for every id and equal meta and aux."""
    sub, path = _streamed_node(writer, tmp_path)
    want = _cube_state(sub.cube)
    metas = []
    for mod in (snapshot, jax_snapshot):
        assert mod.verify_snapshot(path)
        assert mod.latest_valid_snapshot(str(tmp_path / f"{writer}_snaps")) \
            == path
        cube, meta = mod.load_cube_snapshot(path)
        _assert_cube_states_equal(_cube_state(cube), want)
        metas.append(meta)
        aux = mod.load_aux_state(path)
        assert aux is not None and aux["touched_floor"] >= -1
    assert metas[0] == metas[1] and metas[0]["delta_version"] == 3


def test_snapshots_of_both_packages_are_equal(tmp_path):
    """The same node streamed the same deltas snapshots to equal meta and
    to cubes with equal rows in both packages."""
    (rsub, rpath), (psub, ppath) = (_streamed_node(p, tmp_path)
                                    for p in ("ref", "port"))
    _assert_cube_states_equal(_cube_state(psub.cube), _cube_state(rsub.cube))
    rc, rmeta = jax_snapshot.load_cube_snapshot(rpath)
    pc, pmeta = snapshot.load_cube_snapshot(ppath)
    assert pmeta == rmeta
    _assert_cube_states_equal(_cube_state(pc), _cube_state(rc))


@pytest.fixture()
def _disarm():
    yield
    faults.disarm_all()
    jax_faults.disarm_all()


def test_crash_before_aux_leaves_a_valid_snapshot_with_cold_caches(
        tmp_path, _disarm):
    """tests/test_recovery.py's crash between publish and aux, on the
    port: the snapshot is valid in both packages, its aux state is torn,
    and a recovery from it replays nothing and equals the node."""
    sub = _node("port")
    log, sd = str(tmp_path / "log"), str(tmp_path / "snaps")
    snap = CubeSnapshotter(sub, sd, every_deltas=100, delta_log_dir=log)
    w = SubstrateDeltaWatcher(sub, log, snapshotter=snap)
    em, rng = DeltaEmitter(log), np.random.default_rng(0)
    for _ in range(4):
        em.emit(_delta_groups(rng, GroupDelta))
        w.check_once()
    faults.arm("snapshot.pre_aux")
    with pytest.raises(faults.SimulatedCrash):
        snap.snapshot(force=True)
    faults.disarm_all()
    for mod in (snapshot, jax_snapshot):
        path = mod.latest_valid_snapshot(sd)
        assert path is not None and mod.verify_snapshot(path)
        assert mod.load_aux_state(path) is None
    rec = ServingSubstrate.recover(sd, update_dir=log, **NODE_KW)
    assert not rec.recovering and rec.updates.stats.last_version == 3
    _assert_cube_states_equal(_cube_state(rec.cube), _cube_state(sub.cube))


def test_torn_snapshot_rewrite_is_skipped(tmp_path, _disarm):
    """tests/test_recovery.py's crashed same-cursor rewrite, on the port:
    the old markers are gone, so neither package takes the directory."""
    sub = _node("port")
    log, sd = str(tmp_path / "log"), str(tmp_path / "snaps")
    snap = CubeSnapshotter(sub, sd, every_deltas=100)
    w = SubstrateDeltaWatcher(sub, log, snapshotter=snap)
    em, rng = DeltaEmitter(log), np.random.default_rng(1)
    for _ in range(2):
        em.emit(_delta_groups(rng, GroupDelta))
        w.check_once()
    p = snap.snapshot(force=True)
    faults.arm("snapshot.pre_manifest")
    with pytest.raises(faults.SimulatedCrash):
        snap.snapshot(force=True)
    faults.disarm_all()
    assert not os.path.exists(os.path.join(p, "DONE"))
    assert snapshot.latest_valid_snapshot(sd) is None
    assert jax_snapshot.latest_valid_snapshot(sd) is None


# ------------------------------------------------------------ mesh tier

MESH_KW = dict(mesh_shards=4, block_rows=64, tail_dim=4, seed=5)


def _mesh_node(pkg):
    sub = (JaxSubstrate if pkg == "ref" else ServingSubstrate)(**MESH_KW)
    for name, vocab in GROUPS:
        sub.group_for(name, vocab)
    return sub


def test_mesh_tier_matches_reference(tmp_path):
    """``ServingSubstrate(mesh_shards=4)`` in both packages, given the same
    delta batches: equal rows and tiers for every id, at every version;
    then a sharded snapshot of the port's mesh loads in both packages with
    every shard's rows."""
    subs = {p: _mesh_node(p) for p in ("ref", "port")}
    try:
        assert getattr(subs["port"].cube, "is_mesh", False)
        rng = np.random.default_rng(7)
        for v in range(3):
            gs = _delta_groups(rng, GroupDelta)
            subs["port"].updates.apply(DeltaBatch(v, gs))
            subs["ref"].updates.apply(JaxDeltaBatch(v, [
                JaxGroupDelta(group=g.group, ids=g.ids, rows=g.rows,
                              delete_ids=g.delete_ids) for g in gs]))
            _assert_cube_states_equal(_cube_state(subs["port"].cube),
                                      _cube_state(subs["ref"].cube))
        sd = str(tmp_path / "snaps")
        path = CubeSnapshotter(subs["port"], sd).snapshot()
        assert os.path.basename(path) == "snap_000000000002"
        assert snapshot.latest_valid_snapshot(sd) is None   # not single-cube
        mesh = subs["port"].cube
        for mod in (snapshot, jax_snapshot):
            assert mod.latest_valid_sharded_snapshot(sd) == path
            shards, meta = mod.load_sharded_snapshot(path)
            assert meta["n_shards"] == 4 and meta["delta_version"] == 2
            assert sorted(map(tuple, meta["groups"])) == sorted(
                (f, v, g) for (f, v), g in subs["port"].groups.items())
            for gid, (_n, vocab) in enumerate(GROUPS):
                ids = np.arange(vocab)
                sigs = signature_np(gid, ids)
                for s, idx in mesh.router.split(sigs):
                    live = mesh.shards[s].contains(gid, ids[idx])
                    np.testing.assert_array_equal(
                        shards[s].contains(gid, ids[idx]), live)
                    np.testing.assert_array_equal(
                        shards[s].lookup(gid, ids[idx][live]),
                        mesh.shards[s].lookup(gid, ids[idx][live]))
    finally:
        for sub in subs.values():
            sub.cube.shutdown()


# ------------------------------------------------------------ services

N_WAVE = 24
HEAD_SLOTS = 64


def _carry_dnn(ref_dnn) -> PruningDNN:
    dnn = PruningDNN(device="cpu")
    dnn.params = params_from_numpy(jax.tree.map(np.asarray, ref_dnn.params),
                                   "cpu")
    dnn.x_mean = params_from_numpy(np.asarray(ref_dnn.x_mean), "cpu")
    dnn.x_std = params_from_numpy(np.asarray(ref_dnn.x_std), "cpu")
    return dnn


def _carry(rt) -> dict:
    """A reference runtime's config and weights (and its pruning DNN, when
    it sheds) as the port's injection keywords."""
    kw = dict(model_cfg=rt.model_cfg, params=params_from_numpy(
        jax.tree.map(np.asarray, rt.buffer.active.payload), "cpu"))
    if rt.shedder is not None:
        kw["pruning_dnn"] = _carry_dnn(rt.shedder.dnn)
    return kw


def _sim(svc, executor_cls, seed) -> dict:
    """One wave of N_WAVE requests on the virtual clock, numbered 0..N-1
    (each package numbers events from its own counter); req id -> the
    response."""
    reqs = svc.make_requests(N_WAVE, seed=seed)
    for i, ev in enumerate(reqs):
        ev.req_id = i
    ex = executor_cls(svc.plan, overflow_policy=svc._overflow_policy())
    rep = ex.run([(i / 500.0, ev) for i, ev in enumerate(reqs)])
    assert rep.errors == 0 and len(rep.results) == N_WAVE
    return {ev.req_id: ev for ev in rep.results}


def _assert_answers_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for rid, w in want.items():
        g, w = got[rid].meta["response"], w.meta["response"]
        assert (g.user_id, g.item_id, g.from_cache, g.cube_version,
                g.degraded_tier) == (w.user_id, w.item_id, w.from_cache,
                                     w.cube_version, w.degraded_tier)
        assert g.score == pytest.approx(w.score, **TOL)
        if w.topk is not None:
            assert [i for i, _ in g.topk] == [i for i, _ in w.topk]


def _update_stats(svc) -> dict:
    st = svc.updates.stats
    return {k: getattr(st, k) for k in (
        "deltas_applied", "deltas_skipped", "rows_upserted", "rows_deleted",
        "head_rows_updated", "cube_keys_invalidated",
        "query_entries_invalidated", "promotions", "demotions",
        "compactions", "generation_swaps", "last_version")}


def _head_stats(svc) -> dict:
    return {k: getattr(svc.updates.head.stats, k) for k in HEAD_STATS}


def _emit(emitters, rng, keys, group_cls_of, n_rows=12, delete=1):
    """One delta version, the same in every log: upserts on ``keys`` (the
    items the last wave asked for) in group 0 and on random ids of group
    1, and ``delete`` deletions in group 0."""
    ids0 = rng.choice(keys, min(n_rows, len(keys)), replace=False)
    rows0 = rng.standard_normal((ids0.size, 4)).astype(np.float32)
    ids1 = rng.choice(1024, n_rows, replace=False)
    rows1 = rng.standard_normal((n_rows, 4)).astype(np.float32)
    dels = rng.choice(np.setdiff1d(keys, ids0), delete, replace=False)
    for pkg, em in emitters.items():
        g = group_cls_of[pkg]
        em.emit([g(group=0, ids=ids0, rows=rows0, delete_ids=dels),
                 g(group=1, ids=ids1, rows=rows1)])


def _cfg(pkg, root, **kw):
    cls = JaxServiceConfig if pkg == "ref" else ServiceConfig
    return cls(arch_id="din", batch_size=8, shed=False, seed=0,
               head_slots=HEAD_SLOTS, live_updates=True,
               update_dir=str(root / f"{pkg}_log"),
               snapshot_dir=str(root / f"{pkg}_snaps"),
               snapshot_every_deltas=2, **kw)


def _service(pkg, root, carry, **kw):
    if pkg == "ref":
        return JaxInferenceService(_cfg(pkg, root, **kw))
    return InferenceService(_cfg(pkg, root, **kw), device="cpu", **carry)


SIM = {"ref": JaxSimExecutor, "port": SimExecutor}
GROUP_CLS = {"ref": JaxGroupDelta, "port": GroupDelta}


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory):
    """Both packages through one life: serve, three deltas (the head
    promotes, then updates in place), serve, graceful shutdown; recover
    with no suffix; two more deltas; recover with them as the suffix.
    Every phase's observations, keyed by package."""
    root = tmp_path_factory.mktemp("lifecycle")
    for pkg in SIM:
        os.makedirs(root / f"{pkg}_log")
    ref = _service("ref", root, None)
    carry = _carry(ref._rt)
    svcs = {"ref": ref, "port": _service("port", root, carry)}
    emitters = {"ref": JaxDeltaEmitter(str(root / "ref_log")),
                "port": DeltaEmitter(str(root / "port_log"))}
    obs: dict = {p: {} for p in SIM}
    rng = np.random.default_rng(11)

    def wave(name, seed, group=None):
        for p, svc in (group or svcs).items():
            obs[p][name] = _sim(svc, SIM[p], seed)

    def check(name, group=None):
        for p, svc in (group or svcs).items():
            obs[p][name] = svc.update_watcher.check_once()
            obs[p][name + "_head"] = _head_stats(svc)

    wave("wave0", 0)
    keys = np.asarray(sorted({int(ev.payload["hashed"]["item_id"])
                              for ev in obs["port"]["wave0"].values()}))
    for _ in range(2):
        _emit(emitters, rng, keys, GROUP_CLS)
    check("apply01")
    wave("wave1", 1)
    resident = svcs["port"].updates._resident_ids.get(0, set())
    hot = np.asarray(sorted(resident & set(keys.tolist())))
    _emit(emitters, rng, hot if hot.size > 2 else keys, GROUP_CLS)
    check("apply2")
    wave("wave2", 2)
    for p, svc in svcs.items():
        head = svc.updates.head
        sigs, slots = head._map
        obs[p]["head_table"] = _np(head.table)[slots]
        obs[p]["head_sigs"] = sigs.copy()
        obs[p]["update_stats"] = _update_stats(svc)
        obs[p]["served_head"] = _head_stats(svc)
        obs[p]["snapshots_taken"] = svc.snapshotter.snapshots_taken
        obs[p]["final_snapshot"] = svc.shutdown()
        obs[p]["cube"] = _cube_state(svc.cube, [("item_id", 1024),
                                                ("item_cat", 1024)])
        obs[p]["head_resident"] = {
            g: sorted(ids) for g, ids in svc.updates._resident_ids.items()}
        # each resident row in the head against the cube's at this version
        pairs = []
        for g, ids in obs[p]["head_resident"].items():
            ids = np.asarray(ids, np.int64)
            slots, found = head._resolve(signature_np(g, ids))
            pairs.append((_np(head.table)[slots[found]],
                          svc.cube.lookup_ex(g, ids[found])[0]))
        obs[p]["head_vs_cube"] = pairs
        obs[p]["device"] = getattr(head.table, "device", None)

    # recovery with no suffix: the final snapshot is the log head
    rec = {"ref": _service("ref", root, None, recover=True),
           "port": _service("port", root, carry, recover=True)}
    for p, svc in rec.items():
        sub = svc.substrate
        obs[p]["rec0"] = dict(
            recovering=sub.recovering, target=sub.recovery_target,
            applied=svc.updates.stats.deltas_applied,
            last=svc.updates.stats.last_version,
            cube=_cube_state(svc.cube, [("item_id", 1024),
                                        ("item_cat", 1024)]))
    wave("rec0_wave", 2, rec)
    for svc in rec.values():
        svc.stop_updates()

    # two more versions: the next boot replays exactly them
    for _ in range(2):
        _emit(emitters, rng, keys, GROUP_CLS)
    rec = {"ref": _service("ref", root, None, recover=True),
           "port": _service("port", root, carry, recover=True)}
    for p, svc in rec.items():
        sub = svc.substrate
        obs[p]["rec1_before"] = dict(recovering=sub.recovering,
                                     target=sub.recovery_target,
                                     last=svc.updates.stats.last_version)
    check("rec1_apply", rec)
    for p, svc in rec.items():
        sub = svc.substrate
        obs[p]["rec1_after"] = dict(recovering=sub.recovering,
                                    target=sub.recovery_target,
                                    applied=svc.updates.stats.deltas_applied,
                                    last=svc.updates.stats.last_version)
        obs[p]["rec1_update_stats"] = _update_stats(svc)
    wave("rec1_wave", 3, rec)
    for svc in rec.values():
        svc.shutdown()
    return obs


def test_service_head_lives_on_the_asked_device(lifecycle):
    assert lifecycle["port"]["device"].type == "cpu"


def test_service_waves_match_reference(lifecycle):
    """Scores within 2e-5 and equal stamps before the deltas, after the
    head promoted, after an in-place update, and after each recovery."""
    ref, port = lifecycle["ref"], lifecycle["port"]
    for name in ("wave0", "wave1", "wave2", "rec0_wave", "rec1_wave"):
        _assert_answers_equal(port[name], ref[name])


def test_service_head_matches_reference(lifecycle):
    """The head promoted, hit and updated in place; its stats after each
    apply, its membership and its resident rows equal the reference's,
    and each resident row equals the cube's row bit for bit."""
    ref, port = lifecycle["ref"], lifecycle["port"]
    for name in ("apply01_head", "apply2_head", "served_head"):
        assert port[name] == ref[name]
    assert port["apply01_head"]["promotions"] > 0
    assert port["served_head"]["hits"] > 0
    assert port["apply2_head"]["inplace_updates"] > 0
    np.testing.assert_array_equal(port["head_sigs"], ref["head_sigs"])
    np.testing.assert_array_equal(port["head_table"], ref["head_table"])
    assert port["head_resident"] == ref["head_resident"]
    n = 0
    for got, want in port["head_vs_cube"]:
        np.testing.assert_array_equal(got, want)
        n += len(got)
    assert n > 0


def test_service_update_stats_and_snapshots_match_reference(lifecycle):
    ref, port = lifecycle["ref"], lifecycle["port"]
    assert port["update_stats"] == ref["update_stats"]
    assert port["update_stats"]["head_rows_updated"] > 0
    assert port["snapshots_taken"] == ref["snapshots_taken"] >= 1
    # the final snapshot is the log head (v2): the periodic one took v1
    assert os.path.basename(port["final_snapshot"]) == \
        os.path.basename(ref["final_snapshot"]) == "snap_000000000002"
    _assert_cube_states_equal(port["cube"], ref["cube"])


def test_recovery_without_suffix_matches_reference(lifecycle):
    """From the final snapshot: zero deltas replayed, caught up at once,
    and every cube row equal to the node that shut down."""
    ref, port = lifecycle["ref"], lifecycle["port"]
    for obs in (ref, port):
        r = obs["rec0"]
        assert (r["recovering"], r["target"], r["applied"], r["last"]) == \
            (False, 2, 0, 2)
    _assert_cube_states_equal(port["rec0"]["cube"], port["cube"])
    _assert_cube_states_equal(port["rec0"]["cube"], ref["rec0"]["cube"])


def test_recovery_with_suffix_matches_reference(lifecycle):
    """Two versions past the final snapshot: the boot targets the log head
    and serves degraded until the watcher replays exactly those two."""
    ref, port = lifecycle["ref"], lifecycle["port"]
    for obs in (ref, port):
        assert obs["rec1_before"] == dict(recovering=True, target=4, last=2)
        assert obs["rec1_after"] == dict(recovering=False, target=4,
                                         applied=2, last=4)
    assert port["rec1_update_stats"] == ref["rec1_update_stats"]
    assert port["rec1_apply_head"] == ref["rec1_apply_head"]


def test_service_sigterm_hook_takes_final_snapshot(tmp_path):
    """``install_shutdown_hook``: SIGTERM quiesces the watcher and writes a
    final snapshot at its cursor, as the reference's does; without a
    snapshot directory there is no hook to install."""
    cfg = dict(arch_id="din", batch_size=8, shed=False, live_updates=True,
               update_dir=str(tmp_path / "log"))
    os.makedirs(cfg["update_dir"])
    bare = InferenceService(ServiceConfig(**cfg), device="cpu")
    with pytest.raises(RuntimeError, match="no snapshotter"):
        bare.install_shutdown_hook()
    svc = InferenceService(ServiceConfig(
        snapshot_dir=str(tmp_path / "snaps"), **cfg), device="cpu")
    DeltaEmitter(cfg["update_dir"]).emit([GroupDelta(
        group=0, ids=np.arange(8), rows=np.ones((8, 4), np.float32))])
    assert svc.update_watcher.check_once()
    with _sigterm_restored():
        handler = svc.install_shutdown_hook(chain=False)
        assert signal.getsignal(signal.SIGTERM) is handler
        handler(signal.SIGTERM, None)
    path = snapshot.latest_valid_snapshot(str(tmp_path / "snaps"))
    assert os.path.basename(path) == "snap_000000000000"
    assert svc.snapshotter.last_snapshot_version == 0


def test_multi_scenario_service_recovers_like_reference(tmp_path):
    """A MultiScenarioService (DIN re-rank, no shedding) with a head, live
    updates and snapshots in both packages: a delta, a shutdown, then
    ``recover=True`` replays nothing and both serve equal answers from
    equal cubes."""
    def cfg(pkg, **kw):
        cls, get = ((JaxMultiServiceConfig, jax_get_scenario) if pkg == "ref"
                    else (MultiServiceConfig, get_scenario))
        spec = dataclasses.replace(get("din-rerank"), shed=False)
        return cls(scenarios=(spec,), head_slots=HEAD_SLOTS,
                   live_updates=True, update_dir=str(tmp_path / pkg / "log"),
                   snapshot_dir=str(tmp_path / pkg / "snaps"),
                   snapshot_every_deltas=4, **kw)

    def build(pkg, carry, **kw):
        if pkg == "ref":
            return JaxMultiService(cfg(pkg, **kw))
        return MultiScenarioService(cfg(pkg, **kw), device="cpu", **carry)

    for pkg in SIM:
        os.makedirs(tmp_path / pkg / "log")
    ref = build("ref", None)
    rt = ref.runtimes["din-rerank"]
    one = _carry(rt)
    carry = dict(model_cfgs={"din-rerank": one["model_cfg"]},
                 params={"din-rerank": one["params"]})
    svcs = {"ref": ref, "port": build("port", carry)}
    waves = {p: _sim(svc, SIM[p], 0) for p, svc in svcs.items()}
    keys = np.asarray(sorted({int(ev.payload["hashed"]["item_id"])
                              for ev in waves["port"].values()}))
    rng = np.random.default_rng(3)
    _emit({"ref": JaxDeltaEmitter(str(tmp_path / "ref" / "log")),
           "port": DeltaEmitter(str(tmp_path / "port" / "log"))},
          rng, keys, GROUP_CLS)
    paths = {}
    for p, svc in svcs.items():
        assert svc.update_watcher.check_once()
        paths[p] = svc.shutdown()
    assert os.path.basename(paths["port"]) == \
        os.path.basename(paths["ref"]) == "snap_000000000000"
    rec = {"ref": build("ref", None, recover=True),
           "port": build("port", carry, recover=True)}
    try:
        groups = [("item_id", 1024), ("item_cat", 1024)]
        states = {p: _cube_state(svc.cube, groups) for p, svc in rec.items()}
        _assert_cube_states_equal(states["port"], states["ref"])
        _assert_cube_states_equal(states["port"],
                                  _cube_state(svcs["port"].cube, groups))
        for svc in rec.values():
            assert not svc.substrate.recovering
            assert svc.updates.stats.deltas_applied == 0
            assert svc.updates.stats.last_version == 0
        _assert_answers_equal(_sim(rec["port"], SimExecutor, 1),
                              _sim(rec["ref"], JaxSimExecutor, 1))
    finally:
        for svc in rec.values():
            svc.stop_updates()


# ------------------------------------------------------------ launcher

def _args(root, **kw) -> argparse.Namespace:
    a = dict(mode="recsys", arch="smollm-135m", requests=12, reduced=True,
             snapshot_dir=str(root / "snaps"), recover=False,
             update_dir=str(root / "log"), metrics_port=0,
             metrics_out=str(root / "metrics"),
             history_dir=str(root / "history"), history_interval_s=3600.0,
             trace_out=str(root / "trace.json"))
    a.update(kw)
    return argparse.Namespace(**a)


def _prepare_launch_dir(root, pkg):
    """A delta log of two versions and a snapshot at its head, written by a
    service driven with check_once — so the launcher's --recover boot has
    a snapshot to find and no suffix left to race its watcher."""
    os.makedirs(root / "log")
    (JaxDeltaEmitter if pkg == "ref" else DeltaEmitter)(
        str(root / "log")).emit([(GROUP_CLS[pkg])(
            group=0, ids=np.arange(16),
            rows=np.full((16, 4), 0.5, np.float32))])
    cls = JaxServiceConfig if pkg == "ref" else ServiceConfig
    cfg = cls(arch_id="din", shed=False, live_updates=True,
              update_dir=str(root / "log"), snapshot_dir=str(root / "snaps"))
    svc = (JaxInferenceService(cfg) if pkg == "ref"
           else InferenceService(cfg, device="cpu"))
    assert svc.update_watcher.check_once()
    assert svc.shutdown() is not None


@contextlib.contextmanager
def _sigterm_restored():
    prev = signal.getsignal(signal.SIGTERM)
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev)


def _metric_names(text: str) -> set:
    return {m.group(1) for m in re.finditer(r"^([a-zA-Z_:][\w:]*)[{ ]",
                                             text, re.M)}


def test_serve_recsys_matches_reference(tmp_path, monkeypatch):
    """``--recover`` and every other recsys flag, same weights: the port's
    launcher serves every request, boots from the same snapshot, answers
    from the query cache as often, keeps as many traces and history
    windows, and writes metrics files that parse and name the reference's
    metrics (request latency and the snapshot gauges among them)."""
    built = []

    class Capture(JaxInferenceService):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(jax_service_mod, "InferenceService", Capture)
    figs, names = {}, {}
    for pkg in ("ref", "port"):
        root = tmp_path / pkg
        _prepare_launch_dir(root, pkg)
        args = _args(root, recover=True)
        (jax_get_registry if pkg == "ref" else get_registry)().clear()
        out = io.StringIO()
        with _sigterm_restored(), contextlib.redirect_stdout(out):
            if pkg == "ref":
                jax_serve.serve_recsys(args)
            else:
                fig = serve.serve_recsys(args, device="cpu",
                                         **_carry(built[0]._rt))
        text = out.getvalue()
        m = re.search(r"served (\d+) requests; avg [\d.]+ ms, p99 [\d.]+ ms; "
                      r"query-cache hit ([\d.]+)%", text)
        assert m, text
        figs[pkg] = dict(
            served=int(m.group(1)), hit=m.group(2),
            history=int(re.search(r"history: (\d+) window", text).group(1)),
            traces=int(re.search(r"traces: (\d+) retained", text).group(1)),
            final="final snapshot" in text)
        prom = (root / "metrics" / "metrics.prom").read_text()
        js = json.loads((root / "metrics" / "metrics.json").read_text())
        names[pkg] = (_metric_names(prom), set(js))
        assert json.loads((root / "trace.json").read_text())
    assert figs["port"] == figs["ref"]
    assert figs["port"]["served"] == 12
    assert (fig["served"], f"{100 * fig['query_cache_hit_ratio']:.1f}",
            fig["history_windows"], fig["traces"]) == (
        figs["ref"]["served"], figs["ref"]["hit"], figs["ref"]["history"],
        figs["ref"]["traces"])
    assert fig["service"].device.type == "cpu"
    assert fig["final_snapshot"] is None       # replayed nothing new
    assert names["port"] == names["ref"]
    prom_names, js_names = names["port"]
    assert any("request_latency_s" in n for n in prom_names)
    assert any("request_latency_s" in n for n in js_names)
    assert any("snapshot" in n for n in prom_names)


def test_metrics_server_serves_both_formats():
    """``start_metrics_server`` on a free localhost port answers /metrics
    and /metrics.json with the registry, and 404 elsewhere."""
    import urllib.error
    import urllib.request
    reg = MetricsRegistry()
    reg.counter("served_total", "served").inc(3)
    srv = serve.start_metrics_server(reg, 0)
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert "served_total" in r.read().decode()
        with urllib.request.urlopen(base + "/metrics.json", timeout=10) as r:
            assert json.loads(r.read().decode())
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/other", timeout=10)
    finally:
        srv.shutdown()
        srv.server_close()


def test_serve_recsys_cli_asks_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--mode", "recsys", "--requests", "1"])


# ---------------------------------------------------------------- IRM

def test_offline_tuner_finds_the_reference_plan(tmp_path):
    """The port's StatsRecorder writes the IRM history (a fresh sweep of
    the service model); the port's and the reference's offline searches
    over that one file find the same knobs and instance counts."""
    hist = str(tmp_path / "history")
    kw = dict(n_log_samples=12, n_events=200, budget=120, seed=0,
              history_dir=hist)
    X, lat, res = offline.collect_logs(SERVICES["A"], 12, 200,
                                       history_dir=hist)
    jX, jlat, jres = jax_offline.logs_from_history(hist)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(lat, jlat)
    np.testing.assert_array_equal(res, jres)
    got = offline.autotune(SERVICES["A"], **kw)
    want = jax_offline.autotune(JAX_SERVICES["A"], **kw)
    assert vars(got.knobs_after) == vars(want.knobs_after)
    assert (got.instances_before, got.instances_after,
            got.candidates_tried) == (want.instances_before,
                                      want.instances_after,
                                      want.candidates_tried)
    assert got.latency_after_ms == pytest.approx(want.latency_after_ms,
                                                 rel=1e-12)
