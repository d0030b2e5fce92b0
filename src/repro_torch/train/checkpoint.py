"""Fault-tolerant checkpointing in the reference's on-disk format.

  * save: each leaf written as ``leaf_{i:05d}.npy`` in JAX's leaf order
    (dict keys sorted, lists by index), with a JSON manifest (step, meta,
    and per leaf its ``tree_paths`` name, file, shape, dtype and crc32);
    atomic via write-to-temp + rename; a DONE marker gates readers (the
    hot-load monitor, restore and ``update/delta.py``'s
    ``CheckpointDiffEmitter`` all key on it). Either package reads the
    other's checkpoints.
  * bfloat16: numpy has none of its own. The reference ``np.save``s an
    ``ml_dtypes`` array, which writes the 2-byte payloads under descr
    ``<V2`` with manifest dtype ``"bfloat16"``; the port writes and reads
    those same bytes through a uint16 view, keyed on the manifest's dtype,
    and the crc32 is over the same bytes in both packages.
  * async save: snapshot to host, then write on a thread — training
    continues.
  * emergency save on SIGTERM (preemption notice).

On a device mesh (``runtime.current_mesh()``) a save gathers every leaf
whole from the ranks' parts by its spec (``sharding.gather_tree``; every
rank takes part) and one rank, rank 0, writes the one-device format, so
either package reads a mesh's checkpoint; ``restore(..., shardings=)``
reads each leaf whole and keeps the rank's part by its spec (a
``RowShard`` where ``like`` holds one), so a checkpoint written on any
number of devices restores onto any mesh: the reference's resharding
``device_put``.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import runtime
from repro_torch import tree as tree_lib

BF16 = "bfloat16"


def tree_paths(tree) -> list[str]:
    """Every leaf's name, ``"a/b/0/w"``, in JAX's leaf order."""
    return [tree_lib.path_name(p) for p, _ in tree_lib.flatten_with_paths(tree)]


def _host(leaf) -> tuple[np.ndarray, str]:
    """(C-contiguous host payload, manifest dtype) of one leaf: a tensor
    or an array; bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(leaf)
        if arr.dtype.name == BF16:
            return arr.view(np.uint16), BF16
    return arr, str(arr.dtype)


def _write_leaf(path: str, arr: np.ndarray, dtype: str):
    if dtype == BF16:
        # the header ml_dtypes' array gets from np.save, then its bytes
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": arr.shape})
            f.write(arr.tobytes())
    else:
        np.save(path, arr)


def save(path: str, tree: Any, step: int = 0, meta: Optional[dict] = None,
         mark_done: bool = True) -> dict:
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = tree_lib.flatten_with_paths(tree)
    # the tree's shape (the reference writes JAX's treedef string there;
    # neither package's restore reads it)
    manifest = {"step": step, "meta": meta or {}, "leaves": [],
                "treedef": str(tree_lib.tree_map(lambda _: "*", tree))}
    for i, (p, leaf) in enumerate(flat):
        arr, dtype = _host(leaf)
        fn = f"leaf_{i:05d}.npy"
        _write_leaf(os.path.join(tmp, fn), arr, dtype)
        manifest["leaves"].append({
            "name": tree_lib.path_name(p), "file": fn,
            "shape": list(arr.shape), "dtype": dtype,
            "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if mark_done:
        open(os.path.join(tmp, "DONE"), "w").close()
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return manifest


def _load_leaf(path: str, rec: dict, verify: bool) -> np.ndarray:
    """One manifest record's array (bfloat16 as its uint16 bits), its
    crc32 checked."""
    arr = np.load(os.path.join(path, rec["file"]))
    if rec["dtype"] == BF16:
        arr = arr.view(np.uint16)
    if verify:
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF
        if crc != rec["crc32"]:
            raise IOError(f"checksum mismatch in {rec['name']}")
    return arr


def restore(path: str, like: Any, shardings: Any = None,
            verify: bool = True) -> tuple[Any, int]:
    """like: tree prototype (for structure). Each leaf comes back as a
    tensor of the manifest's dtype on the device of ``like``'s leaf (on
    the host where that leaf is no tensor). ``shardings`` (a tree of
    ``sharding.P`` like ``like``), on an installed mesh: each leaf
    becomes the rank's part of it by its spec."""
    if not os.path.exists(os.path.join(path, "DONE")):
        raise FileNotFoundError(f"checkpoint {path} incomplete (no DONE)")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    protos = tree_lib.leaves(like)
    if len(protos) != len(manifest["leaves"]):
        raise ValueError(f"leaf count mismatch: {len(protos)} vs "
                         f"{len(manifest['leaves'])}")
    out = []
    for rec, proto in zip(manifest["leaves"], protos):
        arr = _load_leaf(path, rec, verify)
        dev = proto.device if isinstance(proto, torch.Tensor) else "cpu"
        if rec["dtype"] == BF16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        out.append(t.to(dev))
    tree = tree_lib.unflatten(like, out)
    mesh = runtime.current_mesh()
    if shardings is not None and mesh is not None:
        from repro_torch.launch.sharding import P, local_part
        tree = tree_lib.tree_map(
            lambda t, spec: local_part(t, spec, mesh).clone()
            if isinstance(spec, P) else t, tree, shardings)
    return tree, manifest["step"]


class AsyncCheckpointer:
    """Snapshot-then-write-on-thread; at most one in flight (back-pressure)."""

    def __init__(self, base_dir: str, keep: int = 3):
        self.base_dir = base_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(base_dir, exist_ok=True)
        self.saved_steps: list[int] = []

    def save(self, tree: Any, step: int, meta: Optional[dict] = None,
             block: bool = False, specs: Any = None):
        """Snapshot ``tree`` to the host and write it on a thread as
        ``gen_{step}``. On an installed mesh with ``specs`` (the leaves'
        ``sharding.P``): every rank gathers the leaves whole (a
        collective: each rank calls this), then rank 0 alone writes."""
        self.wait()
        mesh = runtime.current_mesh()
        if mesh is not None and specs is not None:
            from repro_torch.launch.sharding import gather_tree
            tree = gather_tree(tree, specs, mesh)
            if mesh.rank != 0:
                return
        host_tree = tree_lib.tree_map(
            lambda x: (x.detach().to("cpu", copy=True)
                       if isinstance(x, torch.Tensor) else np.array(x)), tree)

        def write():
            p = os.path.join(self.base_dir, f"gen_{step}")
            save(p, host_tree, step, meta)
            self.saved_steps.append(step)
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        gens = sorted(d for d in os.listdir(self.base_dir)
                      if d.startswith("gen_"))
        for d in gens[: max(0, len(gens) - self.keep)]:
            shutil.rmtree(os.path.join(self.base_dir, d), ignore_errors=True)

    def latest(self) -> Optional[str]:
        gens = [d for d in os.listdir(self.base_dir) if d.startswith("gen_")
                and os.path.exists(os.path.join(self.base_dir, d, "DONE"))]
        if not gens:
            return None
        return os.path.join(self.base_dir,
                            max(gens, key=lambda d: int(d.split("_")[1])))

    def install_sigterm_hook(self, get_state, get_step):
        """Preemption: best-effort synchronous save on SIGTERM."""
        def handler(signum, frame):
            try:
                save(os.path.join(self.base_dir, f"gen_{get_step()}_emergency"),
                     get_state(), get_step(), {"emergency": True})
            finally:
                signal.default_int_handler(signum, frame)
        signal.signal(signal.SIGTERM, handler)
