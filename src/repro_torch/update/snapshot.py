"""Durable cube snapshots + restart protocol (DESIGN.md §9).

Everything the sparse tier is — consolidated blocks, overlay blocks,
tombstones, the primary routing index, per-server replica indexes, the
update cursor — lives in process memory; a crash or deploy loses it all.
This module is the durability layer: periodic snapshots of the
:class:`~repro.core.cube.ParameterCube` published with the delta log's
proven discipline, so a restarted node recovers by

    newest valid snapshot  +  delta-log replay from snapshot_version+1

and is bit-identical to a node that never crashed.

On-disk layout (one directory per snapshot, named by the DELTA version it
captures — the cube's internal version also bumps on index folds and
compaction passes, so the delta cursor is the cross-process coordinate)::

    <dir>/snap_<delta_version>/
        meta.json           # cube config, per-group shapes, group registry,
                            # (cube_version, delta_version)
        primary.npz         # the pinned primary snapshot: sigs/srv/blk/off
        server_<sid>.npz    # per-server index at the pinned version + every
                            # value block it (or the primary) references
        CHECKSUMS           # sha256 per file above — torn/corrupt detection
        DONE                # publish marker, written LAST
        aux.json            # reverse maps + touched-key log (advisory)
        AUX_CHECKSUMS
        AUX_DONE            # aux publish marker

The DONE-marker-last + re-hash-on-read discipline is the delta log's: a
snapshot missing DONE, or whose files fail their manifest, is detected and
IGNORED — recovery falls back to the previous valid snapshot (replaying a
longer delta suffix). Aux state (reverse maps for exact warm-start
invalidation, the touched-key log) publishes AFTER the snapshot proper,
behind its own marker: a crash between the two leaves a fully valid
snapshot whose caches merely start cold — never a torn one.

Consistency: the writer captures ``(delta cursor, cube pin, touched log)``
atomically under the UpdateManager's apply lock (no delta can be
mid-flight), then serializes OFF the lock under the pin — the pin keeps
every referenced block and versioned server index alive while delta
batches and compactions keep landing. The writer-lock holds are the
capture only, never the serialization.

Retention: ``CubeSnapshotter`` keeps the last K valid snapshots and owns
delta-log GC — delta dirs strictly older than the oldest retained
snapshot's version are pruned, but never ahead of any registered live
watcher's cursor (a replica still replaying must find its suffix).
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import signal
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.faults.crash import crash_point
from repro_torch.obs.log import log_event

log = logging.getLogger(__name__)

_PREFIX = "snap_"
_CHECKSUMS = "CHECKSUMS"
_AUX_CHECKSUMS = "AUX_CHECKSUMS"
_AUX_FILES = ("aux.json",)
# sharded (mesh) snapshots publish behind their own marker pair —
# deliberately NOT "DONE", so legacy single-cube listing/recovery treats
# a sharded snapshot as unpublished and skips it instead of half-loading
_MESH_DONE = "MESH_DONE"
_MESH_CHECKSUMS = "MESH_CHECKSUMS"
_SHARD_PREFIX = "shard_"

__all__ = [
    "SnapshotIntegrityError", "snapshot_path", "write_cube_snapshot",
    "write_aux_state", "verify_snapshot", "load_cube_snapshot",
    "load_aux_state", "list_snapshots", "latest_valid_snapshot",
    "prune_snapshots", "prune_delta_log", "CubeSnapshotter",
    "write_sharded_snapshot", "verify_sharded_snapshot",
    "load_sharded_snapshot", "list_sharded_snapshots",
    "latest_valid_sharded_snapshot",
]


class SnapshotIntegrityError(ValueError):
    """A published snapshot's content does not match its CHECKSUMS
    manifest — it must be ignored (fall back to an older one)."""


def snapshot_path(snapshot_dir: str, delta_version: int) -> str:
    # delta versions start at 0; version -1 (a snapshot taken before any
    # delta ever applied) encodes as snap_-00000000001, still sortable by
    # the parsed int
    return os.path.join(snapshot_dir, f"{_PREFIX}{delta_version:012d}")


def _sha256(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# ----------------------------------------------------------------- writing

def write_cube_snapshot(snapshot_dir: str, cube, pv, delta_version: int,
                        groups=(), extra_meta: Optional[dict] = None) -> str:
    """Serialize the cube state pinned by ``pv`` into
    ``snap_<delta_version>``: data files → CHECKSUMS → DONE last. The
    caller must hold the pin for the duration (``CubeSnapshotter`` does);
    a re-write of an existing version UNPUBLISHES first (markers removed
    before any file is replaced), mirroring ``write_delta``'s re-emit
    discipline. Returns the snapshot directory."""
    path = snapshot_path(snapshot_dir, delta_version)
    _unpublish(path)
    _write_snapshot_files(path, cube, pv, delta_version,
                          groups=groups, extra_meta=extra_meta)
    return path


def _unpublish(path: str):
    """Remove a snapshot dir marker-first: a reader listing mid-rewrite
    must see an unpublished directory, never a published one being
    replaced."""
    if os.path.exists(path):
        for marker in ("AUX_DONE", "DONE", _MESH_DONE, _AUX_CHECKSUMS,
                       _CHECKSUMS, _MESH_CHECKSUMS):
            try:
                os.remove(os.path.join(path, marker))
            except OSError:
                pass
        shutil.rmtree(path, ignore_errors=True)


def _write_snapshot_files(path: str, cube, pv, delta_version: int,
                          groups=(), extra_meta: Optional[dict] = None):
    """One cube's snapshot payload into ``path`` (data → CHECKSUMS →
    DONE last). Shared by the single-cube and per-shard writers."""
    os.makedirs(path, exist_ok=True)
    ver, psigs, psrv, pblk, poff = pv.snap
    meta = {
        "format": 1,
        "cube_version": int(ver),
        "delta_version": int(delta_version),
        "n_servers": cube.n_servers,
        "replication": cube.replication,
        "block_rows": cube.block_rows,
        "mem_block_fraction": cube.mem_block_fraction,
        "generation": cube.generation,
        "shapes": {str(g): [int(dim), np.dtype(dt).name]
                   for g, (dim, dt) in cube._shapes.items()},
        "groups": [[str(f), int(v), int(g)] for f, v, g in groups],
        "extra": extra_meta or {},
    }
    files = ["meta.json", "primary.npz"]
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    np.savez(os.path.join(path, "primary.npz"),
             sigs=psigs, srv=psrv, blk=pblk, off=poff)

    # the block set a recovered reader can reach at the pinned version:
    # primary routes (srv, blk) plus every server's index-at-pin routes —
    # all protected from reclaim by the caller's pin
    referenced: dict[int, set] = {sid: set() for sid in range(cube.n_servers)}
    live = psrv >= 0
    for sid, bid in zip(psrv[live].tolist(), pblk[live].tolist()):
        referenced[sid].add(bid)
    for sid, srv in enumerate(cube.servers):
        isigs, iblk, ioff = srv._index_at(ver)
        referenced[sid].update(iblk.tolist())
        arrays = {"isigs": isigs, "iblk": iblk, "ioff": ioff}
        bids = sorted(referenced[sid])
        arrays["block_ids"] = np.asarray(bids, np.int64)
        arrays["block_disk"] = np.asarray(
            [bool(srv.blocks[b].on_disk) for b in bids], bool)
        for b in bids:
            # .view: plain-ndarray copy-on-write read of the (possibly
            # memmapped) values; savez writes a dense copy
            arrays[f"block_{b}"] = srv.blocks[b].view
        np.savez(os.path.join(path, f"server_{sid}.npz"), **arrays)
        files.append(f"server_{sid}.npz")

    crash_point("snapshot.pre_manifest")
    sums = [f"{_sha256(os.path.join(path, fn))}  {fn}" for fn in files]
    with open(os.path.join(path, _CHECKSUMS), "w") as f:
        f.write("\n".join(sums) + "\n")
    crash_point("snapshot.pre_done")
    with open(os.path.join(path, "DONE"), "w"):
        pass
    return path


def _encode_key(k):
    # cube-cache keys are ints (group 0) or (group, id) tuples — JSON
    # round-trip: tuple → 2-list, int → int
    return list(k) if isinstance(k, tuple) else int(k)


def _decode_key(k):
    return tuple(k) if isinstance(k, list) else int(k)


def write_aux_state(snap_path: str, reverse_maps: dict,
                    touched_log=(), touched_floor: int = -1) -> str:
    """Persist the advisory warm-start state AFTER the snapshot published:
    per-group reverse maps (bucket → raw items, the exact-invalidation
    index) and the manager's touched-key log. Gated by its own
    AUX_CHECKSUMS + AUX_DONE so a crash here degrades to a valid snapshot
    with cold caches, never a torn snapshot."""
    crash_point("snapshot.pre_aux")
    aux = {
        "reverse_maps": {
            str(g): {str(b): sorted(int(i) for i in items)
                     for b, items in buckets.items()}
            for g, buckets in reverse_maps.items()},
        "touched": [[int(v), [_encode_key(k) for k in keys],
                     sorted(int(i) for i in items)]
                    for v, keys, items in touched_log],
        "touched_floor": int(touched_floor),
    }
    p = os.path.join(snap_path, "aux.json")
    with open(p, "w") as f:
        json.dump(aux, f)
    with open(os.path.join(snap_path, _AUX_CHECKSUMS), "w") as f:
        f.write(f"{_sha256(p)}  aux.json\n")
    with open(os.path.join(snap_path, "AUX_DONE"), "w"):
        pass
    return p


# ---------------------------------------------------------------- reading

def verify_snapshot(path: str) -> bool:
    """DONE present + every manifested file re-hashes clean + no
    unmanifested data file on disk (aux files are covered by their own
    manifest). Raises :class:`SnapshotIntegrityError` on any violation;
    returns True when verified."""
    if not os.path.exists(os.path.join(path, "DONE")):
        raise SnapshotIntegrityError(
            f"{os.path.basename(path)}: unpublished (no DONE)")
    manifest = os.path.join(path, _CHECKSUMS)
    if not os.path.exists(manifest):
        raise SnapshotIntegrityError(
            f"{os.path.basename(path)}: no CHECKSUMS manifest")
    expected = {}
    with open(manifest) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    digest, fn = line.split(None, 1)
                except ValueError:
                    raise SnapshotIntegrityError(
                        f"{os.path.basename(path)}: malformed CHECKSUMS "
                        f"line {line!r}")
                expected[fn.strip()] = digest
    skip = {"DONE", "AUX_DONE", _CHECKSUMS, _AUX_CHECKSUMS, *_AUX_FILES}
    on_disk = {fn for fn in os.listdir(path) if fn not in skip}
    extra = sorted(on_disk - set(expected))
    if extra:
        raise SnapshotIntegrityError(
            f"{os.path.basename(path)}: {extra} on disk but not in "
            f"CHECKSUMS")
    for fn, digest in expected.items():
        full = os.path.join(path, fn)
        if not os.path.exists(full):
            raise SnapshotIntegrityError(
                f"{os.path.basename(path)}: {fn} named in CHECKSUMS but "
                f"missing")
        got = _sha256(full)
        if got != digest:
            raise SnapshotIntegrityError(
                f"{os.path.basename(path)}: {fn} sha256 mismatch "
                f"(manifest {digest[:12]}…, file {got[:12]}…)")
    return True


def load_cube_snapshot(path: str, verify: bool = True):
    """Rebuild a ParameterCube from a published snapshot. Returns
    ``(cube, meta)``. Blocks are re-added slot by slot (fresh block ids)
    and every routing array is remapped through the old→new id table, so
    the restored cube serves lookups bit-identical to the pinned state —
    including replica failover at the restored version."""
    from repro_torch.core.cube import ParameterCube
    if verify:
        verify_snapshot(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    cube = ParameterCube(
        n_servers=int(meta["n_servers"]),
        replication=int(meta["replication"]),
        block_rows=int(meta["block_rows"]),
        mem_block_fraction=float(meta["mem_block_fraction"]),
        generation=int(meta["generation"]))
    cube_version = int(meta["cube_version"])
    for g, (dim, dt) in meta["shapes"].items():
        cube._shapes[int(g)] = (int(dim), np.dtype(dt))
        if cube._dim is None:
            cube._dim, cube._dtype = int(dim), np.dtype(dt)

    remaps: list[np.ndarray] = []
    for sid in range(cube.n_servers):
        srv = cube.servers[sid]
        with np.load(os.path.join(path, f"server_{sid}.npz")) as z:
            bids = z["block_ids"]
            disk = z["block_disk"]
            remap = (np.full(int(bids.max()) + 1, -1, np.int32)
                     if bids.size else np.empty(0, np.int32))
            for old_bid, on_disk in zip(bids.tolist(), disk.tolist()):
                new_bid = srv.add_block(np.empty(0, np.uint64),
                                        z[f"block_{old_bid}"],
                                        on_disk=bool(on_disk), index=False)
                remap[old_bid] = new_bid
            isigs, iblk, ioff = z["isigs"], z["iblk"], z["ioff"]
            srv.install_index(isigs, remap[iblk] if iblk.size else iblk,
                              ioff)
            srv.publish_version(cube_version)
            remaps.append(remap)

    with np.load(os.path.join(path, "primary.npz")) as z:
        psigs, psrv = z["sigs"], z["srv"]
        pblk, poff = z["blk"].copy(), z["off"]
    for sid in range(cube.n_servers):
        sel = psrv == sid
        if sel.any():
            pblk[sel] = remaps[sid][pblk[sel]]
    cube._snap = (cube_version, psigs, psrv, pblk, poff)
    return cube, meta


def load_aux_state(path: str) -> Optional[dict]:
    """The advisory aux state, or None when absent/torn/corrupt (recovery
    proceeds with cold caches — safe, just less warm)."""
    if not os.path.exists(os.path.join(path, "AUX_DONE")):
        return None
    manifest = os.path.join(path, _AUX_CHECKSUMS)
    if not os.path.exists(manifest):
        return None
    try:
        with open(manifest) as f:
            digest, fn = f.read().strip().split(None, 1)
        p = os.path.join(path, fn.strip())
        if _sha256(p) != digest:
            log_event(log, "snapshot_aux_checksum_failed",
                      level=logging.WARNING,
                      snapshot=os.path.basename(path))
            return None
        with open(p) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return None
    return {
        "reverse_maps": {
            int(g): {int(b): set(items) for b, items in buckets.items()}
            for g, buckets in raw.get("reverse_maps", {}).items()},
        "touched": [(int(v), frozenset(_decode_key(k) for k in keys),
                     frozenset(int(i) for i in items))
                    for v, keys, items in raw.get("touched", [])],
        "touched_floor": int(raw.get("touched_floor", -1)),
    }


def list_snapshots(snapshot_dir: str):
    """All snapshot dirs (published or not) as ``(version, path,
    published)``, version-sorted."""
    if not os.path.isdir(snapshot_dir):
        return []
    out = []
    for d in os.listdir(snapshot_dir):
        if not d.startswith(_PREFIX):
            continue
        try:
            ver = int(d[len(_PREFIX):])
        except ValueError:
            continue
        full = os.path.join(snapshot_dir, d)
        out.append((ver, full,
                    os.path.exists(os.path.join(full, "DONE"))))
    out.sort()
    return out


def latest_valid_snapshot(snapshot_dir: str) -> Optional[str]:
    """Newest snapshot that is published AND passes verification; torn or
    corrupt snapshots are logged and skipped — the fall-back-to-previous
    rule that makes a crash mid-snapshot harmless."""
    for ver, path, published in reversed(list_snapshots(snapshot_dir)):
        if not published:
            continue
        try:
            verify_snapshot(path)
            return path
        except SnapshotIntegrityError as e:
            log_event(log, "snapshot_corrupt_ignored",
                      level=logging.WARNING, version=ver,
                      snapshot=os.path.basename(path), error=str(e))
    return None


# ------------------------------------------------------ sharded snapshots

def write_sharded_snapshot(snapshot_dir: str, mesh, record,
                           delta_version: int, groups=(),
                           extra_meta: Optional[dict] = None) -> str:
    """Capture a sharded (mesh) cube: ``snap_<v>/shard_<s>/`` — each shard
    serialized with the single-cube discipline (its own meta/CHECKSUMS/
    DONE) at the shard version pinned by ``record`` (a MeshCube's
    ``_MeshRecord``: one cross-shard frontier, so the snapshot is
    batch-atomic across shards exactly like a pinned read). A top-level
    ``mesh_meta.json`` records the per-shard cursor map + topology, and
    ``MESH_DONE`` publishes LAST. The marker is deliberately not ``DONE``:
    legacy single-cube recovery sees an unpublished dir and skips it.

    This is the item-5 hook: a mesh restart = per-shard restore from the
    shard cursors + delta-log replay from ``delta_version + 1``."""
    path = snapshot_path(snapshot_dir, delta_version)
    _unpublish(path)
    os.makedirs(path, exist_ok=True)
    for s, (shard, pin) in enumerate(zip(mesh.shards, record.shard_pins)):
        _write_snapshot_files(os.path.join(path, f"{_SHARD_PREFIX}{s}"),
                              shard, pin, delta_version,
                              groups=groups, extra_meta=extra_meta)
    topo = mesh.router.topology
    meta = {
        "format": 1,
        "n_shards": int(mesh.n_shards),
        "mesh_version": int(record.version),
        "delta_version": int(delta_version),
        # per-shard cursor: the shard-local cube version each shard_<s>/
        # captures — the coordinate a per-shard replayer resumes from
        "shard_cursors": {str(s): int(p.version)
                          for s, p in enumerate(record.shard_pins)},
        "topology": {"version": int(topo.version), "seed": int(topo.seed),
                     "hosts": list(topo.hosts),
                     "assignments": [list(a) for a in topo.assignments]},
        "shapes": {str(g): [int(dim), np.dtype(dt).name]
                   for g, (dim, dt) in mesh._shapes.items()},
        "groups": [[str(f), int(v), int(g)] for f, v, g in groups],
        "extra": extra_meta or {},
    }
    mp = os.path.join(path, "mesh_meta.json")
    with open(mp, "w") as f:
        json.dump(meta, f)
    crash_point("snapshot.pre_mesh_manifest")
    with open(os.path.join(path, _MESH_CHECKSUMS), "w") as f:
        f.write(f"{_sha256(mp)}  mesh_meta.json\n")
    crash_point("snapshot.pre_mesh_done")
    with open(os.path.join(path, _MESH_DONE), "w"):
        pass
    return path


def verify_sharded_snapshot(path: str) -> bool:
    """MESH_DONE present, mesh_meta re-hashes clean, and every shard dir
    passes the single-cube verification. Raises
    :class:`SnapshotIntegrityError` on any violation."""
    base = os.path.basename(path)
    if not os.path.exists(os.path.join(path, _MESH_DONE)):
        raise SnapshotIntegrityError(f"{base}: unpublished (no MESH_DONE)")
    manifest = os.path.join(path, _MESH_CHECKSUMS)
    if not os.path.exists(manifest):
        raise SnapshotIntegrityError(f"{base}: no MESH_CHECKSUMS")
    with open(manifest) as f:
        digest, fn = f.read().strip().split(None, 1)
    if _sha256(os.path.join(path, fn.strip())) != digest:
        raise SnapshotIntegrityError(f"{base}: mesh_meta.json sha256 "
                                     f"mismatch")
    with open(os.path.join(path, "mesh_meta.json")) as f:
        meta = json.load(f)
    for s in range(int(meta["n_shards"])):
        sdir = os.path.join(path, f"{_SHARD_PREFIX}{s}")
        if not os.path.isdir(sdir):
            raise SnapshotIntegrityError(f"{base}: missing shard_{s}")
        verify_snapshot(sdir)
    return True


def load_sharded_snapshot(path: str, verify: bool = True):
    """Rebuild every shard cube of a sharded snapshot. Returns
    ``(shard_cubes, mesh_meta)`` — each shard restored with the proven
    single-cube loader (bit-identical lookups at its pinned cursor,
    replica failover included)."""
    if verify:
        verify_sharded_snapshot(path)
    with open(os.path.join(path, "mesh_meta.json")) as f:
        meta = json.load(f)
    shards = []
    for s in range(int(meta["n_shards"])):
        cube, _smeta = load_cube_snapshot(
            os.path.join(path, f"{_SHARD_PREFIX}{s}"), verify=False)
        shards.append(cube)
    return shards, meta


def list_sharded_snapshots(snapshot_dir: str):
    """Sharded snapshot dirs as ``(version, path, published)``,
    version-sorted (published = MESH_DONE present)."""
    if not os.path.isdir(snapshot_dir):
        return []
    out = []
    for d in os.listdir(snapshot_dir):
        if not d.startswith(_PREFIX):
            continue
        try:
            ver = int(d[len(_PREFIX):])
        except ValueError:
            continue
        full = os.path.join(snapshot_dir, d)
        if not os.path.isdir(os.path.join(full, f"{_SHARD_PREFIX}0")) \
                and not os.path.exists(os.path.join(full, _MESH_DONE)):
            continue
        out.append((ver, full,
                    os.path.exists(os.path.join(full, _MESH_DONE))))
    out.sort()
    return out


def latest_valid_sharded_snapshot(snapshot_dir: str) -> Optional[str]:
    """Newest published sharded snapshot that verifies clean; torn ones
    are logged and skipped."""
    for ver, path, published in reversed(list_sharded_snapshots(
            snapshot_dir)):
        if not published:
            continue
        try:
            verify_sharded_snapshot(path)
            return path
        except SnapshotIntegrityError as e:
            log_event(log, "sharded_snapshot_corrupt_ignored",
                      level=logging.WARNING, version=ver,
                      snapshot=os.path.basename(path), error=str(e))
    return None


# --------------------------------------------------------------- retention

def prune_snapshots(snapshot_dir: str, keep: int = 2) -> list[str]:
    """Keep the newest ``keep`` VALID snapshots; remove every snapshot dir
    (torn ones included) strictly older than the oldest retained. Returns
    the removed paths."""
    assert keep >= 1
    snaps = list_snapshots(snapshot_dir)
    valid = []
    for ver, path, published in snaps:
        if published:
            try:
                verify_snapshot(path)
                valid.append(ver)
            except SnapshotIntegrityError:
                pass
    if not valid:
        return []
    floor = sorted(valid)[-keep:][0]     # oldest retained valid version
    removed = []
    for ver, path, _pub in snaps:
        if ver < floor:
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    return removed


def prune_delta_log(log_dir: str, upto_version: int) -> int:
    """Remove delta dirs with version ≤ ``upto_version`` (they are baked
    into every retained snapshot). The caller computes the bound — oldest
    retained snapshot's version, floored by every live watcher cursor."""
    if not os.path.isdir(log_dir):
        return 0
    removed = 0
    for d in os.listdir(log_dir):
        if not d.startswith("delta_"):
            continue
        try:
            ver = int(d.split("_")[-1])
        except ValueError:
            continue
        if ver <= upto_version:
            shutil.rmtree(os.path.join(log_dir, d), ignore_errors=True)
            removed += 1
    return removed


# ------------------------------------------------------------- snapshotter

class CubeSnapshotter:
    """Periodic off-hot-path snapshots of a ``ServingSubstrate``'s cube +
    update-plane state, with retention and delta-log GC.

    ``maybe_snapshot`` (called by the substrate watcher after applies)
    snapshots once the delta cursor advanced ``every_deltas`` past the
    last snapshot; ``snapshot`` captures atomically under the manager's
    apply lock and serializes under a pin (writers keep publishing
    throughout). ``graceful_shutdown`` is the planned-restart fast path:
    stop the registered watchers, take a final snapshot at the quiescent
    cursor — the restarted node replays ZERO deltas."""

    def __init__(self, substrate, snapshot_dir: str, every_deltas: int = 8,
                 keep: int = 2, delta_log_dir: Optional[str] = None):
        assert every_deltas >= 1
        self.sub = substrate
        self.snapshot_dir = snapshot_dir
        self.every_deltas = every_deltas
        self.keep = keep
        self.delta_log_dir = delta_log_dir
        os.makedirs(snapshot_dir, exist_ok=True)
        self.watchers: list = []         # live cursors the delta GC floors on
        self.snapshots_taken = 0
        self.deltas_pruned = 0
        self.last_snapshot_s = 0.0       # duration of the last snapshot
        self._lock = threading.Lock()    # one snapshot in flight at a time
        # resume-aware: an existing valid snapshot already covers its
        # version — don't rewrite it on the first post-restart apply
        self.last_snapshot_version = -1
        newest = latest_valid_snapshot(snapshot_dir)
        meta_name = "meta.json"
        if newest is None:
            newest = latest_valid_sharded_snapshot(snapshot_dir)
            meta_name = "mesh_meta.json"
        if newest is not None:
            try:
                with open(os.path.join(newest, meta_name)) as f:
                    self.last_snapshot_version = int(
                        json.load(f)["delta_version"])
            except (OSError, ValueError, KeyError):
                pass

    def register_watcher(self, watcher):
        """Register a live delta watcher whose cursor floors the delta-log
        GC (pruning must never outrun a replaying consumer)."""
        self.watchers.append(watcher)
        return watcher

    # ------------------------------------------------------------ capture
    def maybe_snapshot(self) -> Optional[str]:
        mgr = self.sub.updates
        if (mgr.stats.last_version - self.last_snapshot_version
                < self.every_deltas):
            return None
        return self.snapshot()

    def snapshot(self, force: bool = False) -> Optional[str]:
        """Take one snapshot at the current delta cursor. Returns the
        snapshot path, or None when the cursor has not advanced since the
        last snapshot (``force`` overrides — a same-version rewrite)."""
        with self._lock:
            t0 = time.perf_counter()
            mgr = self.sub.updates
            with mgr.pinned_capture() as (pv, state):
                delta_ver, touched_log, touched_floor = state
                if delta_ver <= self.last_snapshot_version and not force:
                    return None
                groups = [(f, v, g)
                          for (f, v), g in self.sub.groups.items()]
                if getattr(self.sub.cube, "is_mesh", False):
                    # sharded capture: pv pins a MeshCube record — one
                    # cross-shard frontier; each shard serializes at its
                    # pinned cursor under snap_<v>/shard_<s>/. Aux state
                    # is skipped (mesh recovery starts with cold caches).
                    path = write_sharded_snapshot(
                        self.snapshot_dir, self.sub.cube, pv.snap,
                        delta_ver, groups=groups,
                        extra_meta={"tail_dim": self.sub.tail_dim})
                else:
                    path = write_cube_snapshot(
                        self.snapshot_dir, self.sub.cube, pv, delta_ver,
                        groups=groups,
                        extra_meta={"tail_dim": self.sub.tail_dim})
                    write_aux_state(
                        path,
                        {g: rm.export()
                         for g, rm in self.sub.bucket_items.items()},
                        touched_log, touched_floor)
            self.last_snapshot_version = delta_ver
            self.snapshots_taken += 1
            self.last_snapshot_s = time.perf_counter() - t0
            log_event(log, "snapshot_published",
                      watcher=type(self).__name__, version=delta_ver,
                      duration_s=self.last_snapshot_s,
                      snapshot=os.path.basename(path))
            self.gc()
            return path

    # ---------------------------------------------------------- retention
    def gc(self):
        """Retention + delta-log GC: keep the newest K valid snapshots;
        prune delta dirs ≤ min(oldest retained snapshot version, every
        registered watcher cursor)."""
        prune_snapshots(self.snapshot_dir, keep=self.keep)
        if self.delta_log_dir is None:
            return
        retained = []
        for ver, path, published in list_snapshots(self.snapshot_dir):
            if published:
                retained.append(ver)
        if not retained:
            return
        upto = min(retained)
        for w in self.watchers:
            upto = min(upto, w.applied_version)
        self.deltas_pruned += prune_delta_log(self.delta_log_dir, upto)

    # ----------------------------------------------------------- shutdown
    def graceful_shutdown(self) -> Optional[str]:
        """Planned restart: quiesce the watchers, snapshot the final
        cursor. A recover() from this snapshot replays zero deltas."""
        for w in self.watchers:
            try:
                w.stop()
            except Exception:            # noqa: BLE001 — best-effort stop
                pass
        return self.snapshot()

    def install_sigterm_hook(self, chain: bool = True):
        """SIGTERM (preemption notice) → graceful_shutdown, then chain to
        the previous handler (mirrors AsyncCheckpointer's emergency-save
        hook). Returns the installed handler."""
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            try:
                self.graceful_shutdown()
            finally:
                if chain:
                    if callable(prev):
                        prev(signum, frame)
                    else:
                        signal.default_int_handler(signum, frame)
        signal.signal(signal.SIGTERM, handler)
        return handler
