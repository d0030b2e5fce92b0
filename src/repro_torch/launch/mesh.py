"""Device meshes on ``torch.distributed`` — the counterpart of
``repro/launch/mesh.py``, plus the rank launcher a mesh needs here.

A :class:`Mesh` names its axes and sizes (``mesh.shape`` maps each axis to
its size, in order, as the reference's does). A live mesh belongs to one
rank of a ``torch.distributed`` job whose ranks fill it row-major (rank =
flat index over the axes, the order of ``jax.make_mesh``'s devices) and
holds one process group for every combination of its axes; an abstract
mesh (:func:`abstract_mesh`) has only the names and sizes, which is all
the sharding rules read, so they can be evaluated at the production
shapes without 256 ranks. A dry mesh (:func:`dry_mesh`) is one rank's
view of a mesh without a job: the rank's coordinates, which the model
code reads as on a live rank, and no process group; its collectives
return, on the ``meta`` device, the outputs a live group would give,
counted the same (``runtime.py``), so one rank's step can be counted at
the production shapes on any host (``launch/dryrun.py::dry_run_cell``).

:func:`run_ranks` spawns ``n`` ranks (``spawn`` start method; rendezvous
through a ``FileStore`` in a fresh temporary directory, so concurrent
launches never share a port) and runs a module-level function in each.
Backend rule (:func:`backend_for`): ``nccl`` where each rank has its own
card, ``gloo`` on the CPU and where ranks share a card. :func:`run_jobs`
runs SPMD calls on a mesh of such ranks from whole inputs and their
specs (or a cell of ``launch/specs.py``), gathers the outputs whole, and
counts, checks and times each call as asked: the one rank runner of the
tests, ``chip_smoke.py`` and ``launch/dryrun.py``'s cells on a mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import itertools
import math
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.runtime import CollectiveCounts

#: seconds a rank may wait in one collective, and a launch for its ranks
RANK_TIMEOUT_S = 600.0


class Mesh:
    """Axis names and sizes; on a live mesh, the rank's coordinates and a
    process group per combination of axes."""

    def __init__(self, shape, axes, rank: Optional[int] = None,
                 backend: Optional[str] = None, dry: bool = False):
        self.axis_names = tuple(axes)
        self.dims = tuple(int(s) for s in shape)
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.dims} vs axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.dims))
        self.size = math.prod(self.dims)
        self.rank = rank
        self.backend = backend
        self.dry = dry
        if dry and rank is None:
            raise ValueError("a dry mesh is one rank's: give its rank")
        self.counts = CollectiveCounts()
        self.coords = ({} if rank is None else
                       dict(zip(self.axis_names,
                                np.unravel_index(rank, self.dims))))
        self.coords = {k: int(v) for k, v in self.coords.items()}
        self._groups: dict = {}

    @property
    def abstract(self) -> bool:
        return self.rank is None

    @property
    def name(self) -> str:
        return "x".join(str(d) for d in self.dims)

    def group(self, axes: tuple):
        if self.abstract or self.dry:
            raise RuntimeError(f"{'an abstract' if self.abstract else 'a dry'}"
                               f" mesh has no process groups")
        return self._groups[tuple(axes)]

    def _make_groups(self):
        """One process group per combination of axes (every rank creates
        every group, in one order, as ``new_group`` requires), keeping the
        ones this rank belongs to."""
        import torch.distributed as dist
        ranks = np.arange(self.size).reshape(self.dims)
        n = len(self.axis_names)
        for k in range(1, n + 1):
            for combo in itertools.combinations(range(n), k):
                if math.prod(self.dims[i] for i in combo) == 1:
                    continue
                rest = [i for i in range(n) if i not in combo]
                # the combination's axes last, in mesh order: each row one
                # group, its ranks in flat-index order over the combination
                rows = np.transpose(ranks, rest + list(combo)).reshape(
                    -1, math.prod(self.dims[i] for i in combo))
                for row in rows:
                    g = dist.new_group([int(r) for r in row],
                                       timeout=timedelta(seconds=RANK_TIMEOUT_S))
                    if self.rank in row:
                        self._groups[tuple(self.axis_names[i]
                                           for i in combo)] = g

    def __repr__(self):
        kind = ("abstract" if self.abstract else f"rank {self.rank}, dry"
                if self.dry else f"rank {self.rank}, {self.backend}")
        return f"Mesh({self.shape}, {kind})"


def abstract_mesh(shape, axes) -> Mesh:
    """Names and sizes only: what the sharding rules read."""
    return Mesh(shape, axes)


def make_mesh(shape, axes) -> Mesh:
    """This rank's mesh over the running ``torch.distributed`` job, whose
    world size must equal the mesh's size (``run_ranks`` starts one). A
    mesh of one device needs no job."""
    import torch.distributed as dist
    mesh_size = math.prod(shape)
    if mesh_size == 1:
        return Mesh(shape, axes, rank=0)
    if not dist.is_initialized():
        raise RuntimeError(f"a {tuple(shape)} mesh needs a torch.distributed "
                           f"job of {mesh_size} ranks (launch.mesh.run_ranks)")
    if dist.get_world_size() != mesh_size:
        raise ValueError(f"mesh {tuple(shape)} over {dist.get_world_size()} "
                         f"ranks")
    mesh = Mesh(shape, axes, rank=dist.get_rank(),
                backend=dist.get_backend())
    mesh._make_groups()
    return mesh


def dry_mesh(shape, axes, rank: int) -> Mesh:
    """Rank ``rank``'s view of a ``shape`` / ``axes`` mesh without a job:
    its coordinates, no process group; collectives on ``meta`` tensors
    only (``runtime.py``)."""
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} of a {tuple(shape)} mesh")
    return Mesh(shape, axes, rank=rank, dry=True)


def make_production_mesh(*, multi_pod: bool = False,
                         rank: Optional[int] = None) -> Mesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) with "pod": the sharding
    rules' production shapes. Abstract (names and sizes) without
    ``rank``; with it, that rank's dry mesh (:func:`dry_mesh`), on which
    its step runs on ``meta`` (a live one would need 256 or 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if rank is None:
        return abstract_mesh(shape, axes)
    return dry_mesh(shape, axes, rank)


def single_device_mesh() -> Mesh:
    return make_mesh((1, 1), ("data", "model"))


def parse_mesh(text: str) -> tuple:
    """"2x2" → ((2, 2), ("data", "model")); "2x2x4" adds "pod" in front,
    as the reference's ``--mesh`` reads it."""
    dims = tuple(int(x) for x in text.lower().split("x"))
    if not 1 <= len(dims) <= 3:
        raise ValueError(f"mesh {text!r}: 1 to 3 axes")
    return dims, ("pod", "data", "model")[-len(dims):]


# ------------------------------------------------------------------ ranks

def backend_for(device, n_ranks: int) -> str:
    """``nccl`` where each of ``n_ranks`` ranks has its own card, ``gloo``
    on the CPU and where ranks share a card (NCCL refuses two ranks on
    one device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(rank, n, store_path, backend, device, fn, args, results):
    import torch.distributed as dist
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank if backend == "nccl" else 0)
        else:                    # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n), rank=rank,
            world_size=n, timeout=timedelta(seconds=RANK_TIMEOUT_S))
        try:
            results.put((rank, True, _saved(fn(*args), store_path, rank)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the launcher
        results.put((rank, False, traceback.format_exc()))
        raise


def _saved(result, store_path: str, rank: int) -> str:
    """``result`` pickled to a file beside the launch's store; its path.
    A result goes back through a file, not the queue's pipe, whose
    reader takes a large one in small reads: with its four ranks'
    kernel checks, ``chip_smoke.py`` [13e]'s din x train_batch took
    108.9-136.9 s through the pipe and 33.9 s by file on an 8-core
    H100 host."""
    path = os.path.join(os.path.dirname(store_path), f"result_{rank}.pkl")
    with open(path, "wb") as f:
        pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
    return path


def run_ranks(fn: Callable, n: int, args: tuple = (), device="cpu",
              timeout: float = RANK_TIMEOUT_S) -> list:
    """``fn(*args)`` in each of ``n`` spawned ranks of one
    ``torch.distributed`` job on ``device`` (CUDA ranks all use card 0
    unless each has its own); the ranks' results, by rank. ``fn`` must be
    a module-level function and ``args`` picklable. A rank's failure, or
    no result within ``timeout`` seconds, stops every rank and raises."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    backend = backend_for(device, n)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, os.path.join(tmp, "store"), backend,
                               str(device), fn, args, results))
             for r in range(n)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < n:
            left = deadline - time.monotonic()
            try:
                rank, ok, res = results.get(timeout=max(left, 0.01))
            except queue.Empty:
                raise TimeoutError(f"{n} ranks of {fn.__name__}: "
                                   f"{n - len(out)} gave no result within "
                                   f"{timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed in "
                                   f"{fn.__name__}:\n{res}")
            with open(res, "rb") as f:
                out[rank] = pickle.load(f)
            os.remove(res)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(n)]


# ------------------------------------------------------------------- jobs

@dataclass(frozen=True)
class ModelDraw:
    """Parameters each rank draws itself: ``module``'s ``init`` (a recsys
    model's, the LM's) from a generator on the rank's device seeded
    ``seed``, on the rank's mesh — its part of the parameters only (a
    recsys model's rows of the split tables, an LM's slice of every
    layer), the same values as :meth:`draw` without a mesh gives whole."""
    module: str
    cfg: Any
    seed: int = 0

    def draw(self, device, mesh=None):
        dev = torch.device(device)
        return importlib.import_module(self.module).init(
            torch.Generator(device=dev).manual_seed(self.seed), self.cfg,
            device=dev, mesh=mesh)


@dataclass(frozen=True)
class CellDraw:
    """A cell of ``launch/specs.py`` as a job: each rank builds it on its
    live mesh and draws its part of the arguments (``Cell.materialize``
    with a generator seeded ``seed``); the call is ``cell.fn(*args)``,
    its output (the leading ``cell.mesh_outputs`` of it, where the cell
    says) gathered by the cell's ``out_specs``. A training cell's call is
    its next step (``cell.carry``: the new params and optimizer state fed
    back) and returns the loss."""
    arch: str
    shape: str
    reduced: bool = False
    seed: int = 0

    def prepare(self, dev, mesh):
        from repro_torch.launch.specs import build_cell
        cell = build_cell(self.arch, self.shape, device=dev,
                          reduced=self.reduced, mesh=mesh)
        return cell_call(cell, cell.materialize(
            dev, torch.Generator(device=dev).manual_seed(self.seed),
            mesh=mesh))


def cell_call(cell, args):
    """(call, out_specs): a rank's call of ``cell`` on its ``args`` as a
    function of no arguments, and the specs of what it returns. A train
    step's call is the next step (its params and optimizer state fed
    back) and returns the rest (the loss), replicated; a serving cell's
    returns its leading ``mesh_outputs``. The one call of a live rank
    (:class:`CellDraw`) and of a dry one (``launch/dryrun.py``)."""
    if cell.carry:
        state = {"args": args}

        def step():
            out = cell.fn(*state["args"])
            state["args"] = cell.next_args(state["args"], out)
            return tuple(out[cell.carry:])
        return step, tuple(cell.out_specs[cell.carry:])
    n = cell.mesh_outputs
    if n is None:
        return (lambda: cell.fn(*args)), cell.out_specs
    return (lambda: tuple(cell.fn(*args)[:n])), tuple(cell.out_specs[:n])


@dataclass
class Job:
    """One SPMD call from whole inputs: ``fn`` ("module:function") called
    as ``fn(params, *args, **kwargs)`` with ``params`` split by ``pspecs``
    (``sharding.shard_params``: split lookup tables become ``RowShard``s) or
    a :class:`ModelDraw` each rank draws, and ``args`` split by ``specs``
    (``sharding.local_tree``); or, with a :class:`CellDraw` as ``params``,
    the cell's call (``fn`` unused). The output is gathered whole by
    ``out_specs`` (None: each rank's output as it is). Trees hold numpy
    arrays or tensors; on the ranks they become tensors on the rank's
    device (integers as int64).

    The first call is the counted one (kernel launches, collectives);
    ``check_kernels`` replays its kernel calls through their wrappers and
    plain versions (``kernels.replay``). Then come ``warmup`` calls,
    ``repeat`` timed ones (CUDA events on the card, the host clock
    elsewhere) and, with ``count_ops``, one under the op counter."""
    fn: Optional[str] = None
    params: Any = None
    pspecs: Any = None
    args: tuple = ()
    specs: tuple = ()
    kwargs: dict = field(default_factory=dict)
    out_specs: Any = None
    warmup: int = 0
    repeat: int = 0
    count_ops: bool = False
    check_kernels: bool = False


def _resolve(path: str) -> Callable:
    module, name = path.split(":")
    obj = importlib.import_module(module)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _numpy(tree):
    """Tensors (and shards' locals) → numpy, bfloat16 as float32;
    containers walked; other leaves as they are."""
    from repro_torch.runtime import DataShard, RowShard
    if isinstance(tree, (RowShard, DataShard)):
        return _numpy(tree.local)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree


def _tensors(tree, dev):
    """numpy leaves → tensors on ``dev`` (integers as int64)."""
    if isinstance(tree, np.ndarray):
        t = torch.as_tensor(tree)
        return (t if t.is_floating_point() or t.dtype == torch.bool
                else t.long()).to(dev)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _tensors(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tensors(v, dev) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v, dev) for v in tree)
    return tree


def _prepare(job: Job, dev, mesh, drawn: dict):
    """The job's call on this rank, as a function of no arguments, and its
    output specs."""
    if isinstance(job.params, CellDraw):
        return job.params.prepare(dev, mesh)
    from repro_torch.launch import sharding
    fn = _resolve(job.fn)
    if isinstance(job.params, ModelDraw):
        if id(job.params) not in drawn:
            drawn.clear()                       # one model's tables at a time
            drawn[id(job.params)] = job.params.draw(dev, mesh)
        params = drawn[id(job.params)]
    else:
        params = sharding.shard_params(_tensors(job.params, dev), job.pspecs,
                                       mesh)
    args = tuple(sharding.local_tree(_tensors(a, dev), s, mesh)
                 for a, s in zip(job.args, job.specs))
    return (lambda: fn(params, *args, **job.kwargs)), job.out_specs


def _replay_in_turn(calls: list, mesh, dev) -> list:
    """``kernels.replay`` of this rank's recorded kernel calls, one rank
    after another (the plain version of a rank's call can take tens of GB
    of the card the ranks share): [{"kernel", "shapes", "got", "want"}]
    with the outputs as numpy."""
    import torch.distributed as dist
    from repro_torch import kernels as K
    rows = []
    for r in range(mesh.size):
        if r == mesh.rank:
            for name, shapes, got, want in K.replay(calls):
                rows.append({"kernel": name, "shapes": shapes,
                             "got": _numpy(got), "want": _numpy(want)})
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if mesh.size > 1:
            dist.barrier(group=mesh.group(mesh.axis_names))
    return rows


def _jobs_rank(shape, axes, device, jobs):
    """Rank side of :func:`run_jobs`: per job, this rank's call counted
    once (its kernel launches and collectives) and its output gathered,
    then the job's kernel checks, timing and op count; on the card also
    the peak memory of the job's calls after the checks."""
    from repro_torch import kernels as K
    from repro_torch import runtime
    from repro_torch.launch import op_analysis, sharding
    from repro_torch.launch.dryrun import _sync, _timed_ms
    dev = torch.device(device)
    mesh = make_mesh(shape, axes)
    out, drawn = [], {}
    with runtime.use_mesh(mesh), torch.no_grad():
        for job in jobs:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            t0 = time.monotonic()
            call, out_specs = _prepare(job, dev, mesh, drawn)
            _sync(dev)
            if dev.type == "cuda":       # the draw's transients, for the
                torch.cuda.empty_cache()  # ranks sharing the card
            row: dict = {"t_prepare_s": round(time.monotonic() - t0, 2)}
            before = mesh.counts.snapshot()
            K.reset_launches()
            with contextlib.ExitStack() as stack:
                calls = (stack.enter_context(K.recording())
                         if job.check_kernels else None)
                res = call()
            _sync(dev)
            row["launches"] = {k: v for k, v in K.launch_counts().items() if v}
            row["collectives"] = CollectiveCounts.since(mesh.counts.snapshot(),
                                                        before)
            if out_specs is not None:
                res = sharding.gather_tree(res, out_specs, mesh)
            row["out"] = _numpy(res)
            del res
            if calls is not None:
                row["kernel_checks"] = _replay_in_turn(calls, mesh, dev)
                del calls
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            for _ in range(job.warmup):
                call()
            if job.repeat:
                row["ms"] = _timed_ms(call, dev, job.repeat)
            if job.count_ops:
                _, row["ops"] = op_analysis.count_ops(call)
            if dev.type == "cuda":
                row["max_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
            out.append(row)
            # the call's arguments go before the next job draws its own
            # (a ModelDraw the next job shares stays in ``drawn``)
            del call
    return out


def collective_support(params=None) -> dict:
    """Which collectives the current mesh's backend carries correctly on
    tensors of this rank's device, each tried once over the whole mesh in
    float32 and in bfloat16 ("_bf16"): {kind: "ok", "wrong values" or the
    error}. Rank r contributes r + 1 everywhere, so every kind's result is
    known. A report for the records (run as a :class:`Job`): the
    collective helpers hand every kind to the backend directly, so a kind
    not "ok" here is one the mesh paths cannot use on this backend."""
    import torch.distributed as dist
    from repro_torch import runtime
    mesh = runtime.current_mesh()
    group = mesh.group(mesh.axis_names)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    n, r = mesh.size, mesh.rank
    ranks = torch.arange(1, n + 1, dtype=torch.float32)
    total = float(ranks.sum())

    def reduce(x, op=dist.ReduceOp.SUM):
        dist.all_reduce(x, op=op, group=group)
        return x

    def broadcast(x):
        dist.broadcast(x, src=0, group=group)
        return x

    def gather(x):
        out = x.new_empty(n * n)
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    def scatter(x):
        out = x.new_empty(1)
        dist.reduce_scatter_tensor(out, x, group=group)
        return out

    def to_all(x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    tries = {"all_reduce": (reduce, torch.full((n,), total)),
             "all_reduce_max": (lambda x: reduce(x, dist.ReduceOp.MAX),
                                torch.full((n,), float(n))),
             "broadcast": (broadcast, torch.ones(n)),
             "all_gather": (gather, ranks.repeat_interleave(n)),
             "reduce_scatter": (scatter, torch.full((1,), total)),
             "all_to_all": (to_all, ranks)}
    out = {}
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        for kind, (run, want) in tries.items():
            x = torch.full((n,), float(r + 1), dtype=dtype, device=dev)
            try:
                got = run(x)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
            except RuntimeError as e:     # the backend's refusal, reported
                out[kind + suffix] = (f"{type(e).__name__}: "
                                      f"{str(e).splitlines()[0][:160]}")
                continue
            out[kind + suffix] = ("ok" if torch.equal(got.float().cpu(), want)
                                  else f"wrong values {got.tolist()}")
    return {"device": str(dev), "backend": mesh.backend, "kinds": out}


def imported(params=None, packages=("jax", "jaxlib", "repro")) -> list:
    """The modules of ``packages`` this rank has imported (run as the last
    :class:`Job` of a launch: what the jobs before it pulled in)."""
    import sys
    return sorted(m for m in sys.modules if m.split(".")[0] in packages
                  and sys.modules[m] is not None)


def run_jobs(jobs: list, shape=(2, 2), axes=("data", "model"),
             device="cpu", timeout: float = RANK_TIMEOUT_S) -> list:
    """Every job of ``jobs`` on one mesh of ``shape`` / ``axes`` ranks
    (one launch): per rank, per job, {"out", "launches", "collectives",
    "t_prepare_s"} and, as the job asks, "kernel_checks", "ms", "ops";
    "max_allocated_bytes" on the card."""
    jobs = [dataclasses.replace(j, params=_numpy(j.params),
                                args=_numpy(tuple(j.args)),
                                specs=tuple(j.specs)) for j in jobs]
    return run_ranks(_jobs_rank, math.prod(shape),
                     (tuple(shape), tuple(axes), str(device), jobs),
                     device=device, timeout=timeout)
