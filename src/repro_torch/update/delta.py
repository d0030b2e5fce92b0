"""The delta log: versioned parameter-update batches between training and
serving (DESIGN.md §6.1).

A continuously-retrained sparse model touches a tiny slice of rows per
pass — shipping whole generations (serve/hotload.py) for that is the
full-snapshot anti-pattern. The delta log is the streaming alternative:

  * ``GroupDelta`` — per-feature-group arrays of ``(id, row)`` upserts plus
    optional deletes; ids are raw ids in the group's key space (the same
    ids ``ParameterCube.lookup`` takes — signatures are derived at apply
    time so host and cube agree). ``item_ids`` optionally carries the raw
    item ids a serving-side query cache keys scores by, when that space
    differs from the cube's (hashed) id space.
  * ``DeltaBatch`` — one atomic publish unit: a monotonically increasing
    ``version`` plus one GroupDelta per touched group. Within a batch,
    deletes apply after upserts.

On-disk layout (the training-side emitter writes, the serving-side watcher
tails): ``<dir>/delta_<version>/group_<g>.npz`` + a ``CHECKSUMS`` manifest
(per-file sha256, the stream-integrity record) + an empty ``DONE`` marker
written LAST — the marker is the publish point, exactly like hot-load
generations, so a half-written delta is never consumed.

Integrity: the DONE marker catches a TORN delta (partial write), but not a
CORRUPTED one (bit rot, a truncated copy that still parses, a tampered
file). ``verify_delta`` re-hashes every npz against the manifest; the
watcher runs it before apply, so a corrupt batch is logged and skipped —
and retried after backoff, preserving version order — never half-applied.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from repro_torch.faults.crash import crash_point
from repro_torch.obs.log import log_event
from repro_torch.serve.hotload import PollWatcher

log = logging.getLogger(__name__)

_PREFIX = "delta_"
_CHECKSUMS = "CHECKSUMS"


class DeltaIntegrityError(ValueError):
    """A published delta's npz content does not match its CHECKSUMS
    manifest — the batch must be skipped (and re-emitted), never applied."""


@dataclass
class GroupDelta:
    group: int
    ids: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    rows: np.ndarray = field(default_factory=lambda: np.empty((0, 0),
                                                              np.float32))
    delete_ids: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int64))
    # raw item ids for targeted query-cache invalidation; None → the cube
    # ids double as the item keys (single-hash deployments)
    item_ids: Optional[np.ndarray] = None

    def touched_item_ids(self) -> np.ndarray:
        if self.item_ids is not None:
            return np.atleast_1d(np.asarray(self.item_ids))
        return np.concatenate([np.atleast_1d(np.asarray(self.ids)),
                               np.atleast_1d(np.asarray(self.delete_ids))])


@dataclass
class DeltaBatch:
    version: int
    groups: List[GroupDelta]

    @property
    def n_upserts(self) -> int:
        return sum(np.asarray(g.ids).size for g in self.groups)

    @property
    def n_deletes(self) -> int:
        return sum(np.asarray(g.delete_ids).size for g in self.groups)


# ----------------------------------------------------------------- log I/O

def delta_path(log_dir: str, version: int) -> str:
    return os.path.join(log_dir, f"{_PREFIX}{version:012d}")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_delta(log_dir: str, batch: DeltaBatch) -> str:
    """Training-side emit: per-group npz files first, then the CHECKSUMS
    manifest (sha256 per npz), DONE marker last (the atomic publish
    point). Returns the delta directory."""
    path = delta_path(log_dir, batch.version)
    os.makedirs(path, exist_ok=True)
    # a re-emit of this version (the corrupt-delta recovery path) must
    # UNPUBLISH first: remove DONE — so a watcher polling mid-rewrite
    # sees an unpublished directory, not a published one whose npz files
    # are being replaced under it — then the stale manifest (a torn
    # rewrite must fail verification, not pass against old sums)
    done = os.path.join(path, "DONE")
    if os.path.exists(done):
        os.remove(done)
    manifest = os.path.join(path, _CHECKSUMS)
    if os.path.exists(manifest):
        os.remove(manifest)
    # the re-emit may carry fewer groups: drop leftovers so the directory
    # always matches the manifest exactly (verify_delta rejects
    # unmanifested files)
    want = {f"group_{g.group}.npz" for g in batch.groups}
    for fn in os.listdir(path):
        if fn.startswith("group_") and fn.endswith(".npz") and fn not in want:
            os.remove(os.path.join(path, fn))
    sums = []
    for g in batch.groups:
        kw = {"ids": np.atleast_1d(np.asarray(g.ids)),
              "rows": np.asarray(g.rows),
              "delete_ids": np.atleast_1d(np.asarray(g.delete_ids))}
        if g.item_ids is not None:
            kw["item_ids"] = np.atleast_1d(np.asarray(g.item_ids))
        fn = f"group_{g.group}.npz"
        np.savez(os.path.join(path, fn), **kw)
        sums.append(f"{_sha256(os.path.join(path, fn))}  {fn}")
    crash_point("delta.pre_manifest")
    with open(os.path.join(path, _CHECKSUMS), "w") as f:
        f.write("\n".join(sums) + "\n")
    crash_point("delta.pre_done")
    with open(os.path.join(path, "DONE"), "w"):
        pass
    return path


def verify_delta(path: str) -> bool:
    """Re-hash every npz against the CHECKSUMS manifest. Raises
    :class:`DeltaIntegrityError` on any mismatch, a file the manifest
    names that is missing, or a group npz present on disk that the
    manifest does NOT name (``read_delta`` would apply it — a re-emitted
    delta with fewer groups must not resurrect a stale leftover, and a
    stray file dropped into a published dir must not slip past the
    check). Returns True when verified, False when the delta predates
    checksums (no manifest — accepted for compatibility, nothing to
    verify against)."""
    manifest = os.path.join(path, _CHECKSUMS)
    if not os.path.exists(manifest):
        return False
    expected = {}
    with open(manifest) as f:
        for line in f:
            line = line.strip()
            if line:
                digest, fn = line.split(None, 1)
                expected[fn.strip()] = digest
    on_disk = {fn for fn in os.listdir(path)
               if fn.startswith("group_") and fn.endswith(".npz")}
    extra = sorted(on_disk - set(expected))
    if extra:
        raise DeltaIntegrityError(
            f"{os.path.basename(path)}: {extra} present on disk but not "
            f"in the CHECKSUMS manifest")
    for fn, digest in expected.items():
        full = os.path.join(path, fn)
        if not os.path.exists(full):
            raise DeltaIntegrityError(
                f"{os.path.basename(path)}: {fn} named in manifest "
                f"but missing on disk")
        got = _sha256(full)
        if got != digest:
            raise DeltaIntegrityError(
                f"{os.path.basename(path)}: {fn} sha256 mismatch "
                f"(manifest {digest[:12]}…, file {got[:12]}…)")
    return True


def read_delta(path: str) -> DeltaBatch:
    version = int(os.path.basename(path).split("_")[-1])
    # sort by PARSED group id, not filename: lexical order puts
    # group_10.npz before group_2.npz, so at ≥10 groups the apply order
    # would diverge from group numbering
    names = [(int(fn[len("group_"):-len(".npz")]), fn)
             for fn in os.listdir(path)
             if fn.startswith("group_") and fn.endswith(".npz")]
    groups = []
    for gid, fn in sorted(names):
        with np.load(os.path.join(path, fn)) as z:
            groups.append(GroupDelta(
                group=gid,
                ids=z["ids"], rows=z["rows"], delete_ids=z["delete_ids"],
                item_ids=z["item_ids"] if "item_ids" in z else None))
    return DeltaBatch(version=version, groups=groups)


def list_deltas(log_dir: str, after_version: int = -1
                ) -> List[tuple[int, str]]:
    """Published (DONE-marked) deltas newer than ``after_version``, in
    version order — the watcher's tailing primitive."""
    if not os.path.isdir(log_dir):
        return []
    out = []
    for d in os.listdir(log_dir):
        if not d.startswith(_PREFIX):
            continue
        try:
            ver = int(d.split("_")[-1])
        except ValueError:
            continue
        full = os.path.join(log_dir, d)
        if ver > after_version and os.path.exists(os.path.join(full, "DONE")):
            out.append((ver, full))
    out.sort()
    return out


class DeltaEmitter:
    """Training-side convenience: stamps monotonically increasing versions
    onto batches and writes them to the log directory.

    Restarted on an existing log (``start_version=None``, the default) it
    scans the directory and resumes at ``max(existing) + 1`` — the old
    resume-at-0 default silently rewrote already-published delta
    directories in place, corrupting any watcher mid-stream. The scan
    counts every ``delta_*`` directory, published or not: a torn emit
    (no DONE) still owns its version; re-using it would race the crashed
    writer's leftovers. Pass an explicit ``start_version`` to override
    (replay/testing)."""

    def __init__(self, log_dir: str, start_version: Optional[int] = None):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        if start_version is None:
            existing = [-1]
            for d in os.listdir(log_dir):
                if d.startswith(_PREFIX):
                    try:
                        existing.append(int(d.split("_")[-1]))
                    except ValueError:
                        pass
            start_version = max(existing) + 1
        self.next_version = start_version

    def emit(self, groups: List[GroupDelta]) -> DeltaBatch:
        batch = DeltaBatch(version=self.next_version, groups=groups)
        write_delta(self.log_dir, batch)
        self.next_version += 1
        return batch


class CheckpointDiffEmitter:
    """Training-side bridge from whole checkpoints to the delta log
    (ROADMAP item 5's emitter — until now only tests and benches emitted
    deltas): row-diff the embedding tables of two ``train/checkpoint.py``
    checkpoints into ONE ``DeltaBatch`` — upserts for changed and new
    rows, tombstones for ids the new table dropped — and publish it via
    :class:`DeltaEmitter`.

    ``table_groups`` maps checkpoint leaf names (``tree_paths`` form, e.g.
    ``"params/embed/table"``) to cube group ids. Row index IS the raw id —
    the same convention ``ServingSubstrate`` loads tables under — so a
    grown table contributes ``[len(old), len(new))`` as new ids and a
    shrunk one tombstones ``[len(new), len(old))``. Leaves are read
    straight from the manifest (DONE-gated), never through the jax restore
    path: the emitter runs beside training and only needs host arrays."""

    def __init__(self, log_dir: str, table_groups: dict,
                 start_version: Optional[int] = None):
        self.emitter = DeltaEmitter(log_dir, start_version=start_version)
        self.table_groups = dict(table_groups)

    def _load_tables(self, ckpt_path: str) -> dict:
        if not os.path.exists(os.path.join(ckpt_path, "DONE")):
            raise FileNotFoundError(
                f"checkpoint {ckpt_path} incomplete (no DONE)")
        with open(os.path.join(ckpt_path, "manifest.json")) as f:
            manifest = json.load(f)
        want = set(self.table_groups)
        out = {}
        for rec in manifest["leaves"]:
            if rec["name"] in want:
                out[rec["name"]] = np.load(
                    os.path.join(ckpt_path, rec["file"]))
        missing = sorted(want - set(out))
        if missing:
            raise KeyError(
                f"checkpoint {ckpt_path} has no leaves {missing} "
                f"(available: {[r['name'] for r in manifest['leaves']]})")
        return out

    def diff(self, old_path: Optional[str],
             new_path: str) -> List[GroupDelta]:
        """GroupDeltas turning ``old_path``'s tables into ``new_path``'s.
        ``old_path=None`` is the bootstrap diff: every row an upsert.
        Tables with no changed rows produce no GroupDelta."""
        new = self._load_tables(new_path)
        old = self._load_tables(old_path) if old_path is not None else {}
        groups = []
        for name in sorted(self.table_groups, key=self.table_groups.get):
            gid = self.table_groups[name]
            b = np.asarray(new[name])
            if b.ndim != 2:
                raise ValueError(f"{name}: embedding table must be 2-D, "
                                 f"got shape {b.shape}")
            a = np.asarray(old[name]) if name in old else None
            if a is None:
                ids = np.arange(b.shape[0], dtype=np.int64)
                dels = np.empty(0, np.int64)
            else:
                n = min(a.shape[0], b.shape[0])
                changed = (np.flatnonzero((a[:n] != b[:n]).any(axis=1))
                           if n else np.empty(0, np.int64))
                grown = np.arange(n, b.shape[0], dtype=np.int64)
                ids = np.concatenate([changed.astype(np.int64), grown])
                dels = np.arange(b.shape[0], a.shape[0], dtype=np.int64)
            if ids.size or dels.size:
                rows = (b[ids] if ids.size
                        else np.empty((0, b.shape[1]), b.dtype))
                groups.append(GroupDelta(group=gid, ids=ids, rows=rows,
                                         delete_ids=dels))
        return groups

    def emit_diff(self, old_path: Optional[str],
                  new_path: str) -> Optional[DeltaBatch]:
        """Diff and publish. Returns the emitted batch, or None when the
        checkpoints' tables are identical (no version burned — an empty
        delta would still cost every watcher a verify+apply cycle)."""
        groups = self.diff(old_path, new_path)
        if not groups:
            return None
        return self.emitter.emit(groups)


class DeltaWatcher(PollWatcher):
    """Serving-side tail of the delta log — the streaming generalization of
    ``ModelMonitor`` (which it shares the PollWatcher skeleton with): where
    the monitor loads only the LATEST whole generation, the watcher applies
    EVERY pending delta strictly in version order (deltas compose; skipping
    one would corrupt the cube state). A failed apply stops at that delta
    and retries it after backoff, preserving the order.

    ``prune_applied``: remove each delta directory once applied. Without
    it, the log directory grows one directory per delta forever and every
    poll's os.listdir scans the full history — enable when this watcher is
    the log's only consumer (the serving wiring); leave off for shared
    logs, where retention belongs to the training side.

    ``verify_checksums`` (default on): each delta's npz files are re-hashed
    against its CHECKSUMS manifest BEFORE apply. A corrupted batch raises
    :class:`DeltaIntegrityError` — the poll thread logs it, backs off and
    retries at the same version (the training side must re-emit), so a
    corrupt delta is skipped rather than half-applied, and later versions
    are never applied over it out of order."""

    def __init__(self, watch_dir: str, apply_fn: Callable[[DeltaBatch], int],
                 poll_s: float = 0.25, max_backoff_s: float = 10.0,
                 start_after_version: int = -1, prune_applied: bool = False,
                 verify_checksums: bool = True, **kw):
        super().__init__(poll_s=poll_s, max_backoff_s=max_backoff_s, **kw)
        self.watch_dir = watch_dir
        self.apply_fn = apply_fn
        self.applied_version = start_after_version
        self.prune_applied = prune_applied
        self.verify_checksums = verify_checksums
        self.integrity_failures = 0

    def check_once(self) -> bool:
        applied = False
        for ver, path in list_deltas(self.watch_dir, self.applied_version):
            if self.verify_checksums:
                try:
                    verify_delta(path)
                except DeltaIntegrityError as e:
                    self.integrity_failures += 1
                    log_event(log, "delta_checksum_failed",
                              level=logging.WARNING,
                              watcher=type(self).__name__, version=ver,
                              path=path, error=str(e))
                    raise
            self.apply_fn(read_delta(path))
            self.applied_version = ver
            log_event(log, "delta_applied", watcher=type(self).__name__,
                      version=ver)
            applied = True
            if self.prune_applied:
                shutil.rmtree(path, ignore_errors=True)
        return applied
