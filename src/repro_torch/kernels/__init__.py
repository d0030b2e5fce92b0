"""Build, load and dispatch policy of the port's hand-written kernels.

Sources live in ``kernels/csrc/*.cu``: CUDA C++ for ``sm_90a`` with a
plain C interface. :func:`build` compiles them, one ``nvcc`` a source
started together, into ONE shared library and caches it under
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by a
hash of the sources and flags.
:func:`library` builds on first use and binds the entry points with
``ctypes``.

Dispatch is by tensor device only (:func:`on_cpu`):

  * tensors on the CPU go to the kernel's plain PyTorch version (its
    ``ref.py``);
  * tensors on a CUDA device launch the kernel. If the library cannot be
    built or loaded, or the device is not compute capability (9, 0), the
    wrapper raises. There is no override toward the plain version and no
    fallback;
  * tensors on the ``meta`` device (a dry run: one rank's step counted
    without a card, ``launch/dryrun.py::dry_run_cell``) take the kernel's
    path as on the card: the wrapper runs its checks, so a shape the
    kernel refuses is refused here too, and allocates its outputs on
    ``meta``; :func:`launch` then launches nothing and counts nothing in
    :data:`LAUNCHES`, and only hands the cost to active op counters
    (:func:`dry_launch`).

Mixed devices raise. Every wrapper counts its launches in
:data:`LAUNCHES` (one per launch, nowhere else), so a run can show that
its path went through the kernels. A ctypes launch is invisible to
PyTorch's dispatcher, so each wrapper also hands :func:`launch` its
kernel's ``cost(...)`` (flops and bytes from the shapes, the formulas of
the roofline bound): while an op counter (``launch/op_analysis.py``) is
active, that cost is added to it. Three costs read data on the host (a
mask's non-zeros, the ids' distinct rows, the valid cache length); on
``meta`` they take their bound instead, and the wrapper names it
(``bound=``), so a counter can say which of its kernel counts are bounds.

Checks on a path's own inputs: inside :func:`recording` every call of a
wrapper is kept with its inputs and the plain version that takes the same
arguments, and :func:`replay` runs each again through the wrapper and the
plain version, so a caller can hold a kernel to its plain version at the
shapes and on the inputs a path gave it (a rank's shard and ownership
weights on a mesh).

Gradients: no kernel has a backward kernel (the reference differentiates
its plain math). The kernels on the training path (embedding_bag,
din_attention, augru) run their forward on the card and take the
gradient of their plain version (:func:`with_plain_gradient`); the
serving-only kernels refuse to run where autograd would record them
(:func:`refuse_grad`). No wrapper hands back a CUDA output that silently
drops the gradient.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import fcntl
import functools
import hashlib
import inspect
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.obs.layer import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: C entry points of the library: name → argument types. Each returns the
#: ``cudaGetLastError()`` after its launch (or its CUDA call) as an int
#: (0 = success).
SIGNATURES = {
    "embedding_bag_f32": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    "embedding_bag_bf16": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    # a host pointer to the groups' descriptors (passed on by value)
    "embedding_bag_group_f32": [_P, _P],
    "embedding_bag_group_bf16": [_P, _P],
    # ..., the steps counter (null: not counted), then the stream
    "din_attention_f32": [_P] * 10 + [_I] * 5 + [_P, _P],
    "rerank_score_f32": [_P] * 18 + [_I] * 9 + [_P],
    "augru_f32": [_P] * 7 + [_I] * 4 + [_P],
    "candidate_scorer_f32": [_P] * 4 + [_I] * 4 + [_P, _P],
    "candidate_scorer_bf16": [_P] * 4 + [_I] * 4 + [_P, _P],
    # ..., scale, then the lse output (null: not written), then the stream
    "flash_decode_f32": [_P] * 6 + [_I] * 7 + [_F, _P, _P],
    "flash_decode_bf16": [_P] * 6 + [_I] * 7 + [_F, _P, _P],
    # a query, not a launch: SM count and resident split blocks per SM
    "flash_decode_residency": [_I] * 3 + [_P, _P],
    # an empty kernel, timed as the launch floor; no path launches it
    "launch_floor": [_P],
}

LAUNCHES = {"embedding_bag": 0, "din_attention": 0, "rerank_score": 0,
            "augru": 0, "candidate_scorer": 0, "flash_decode": 0}
_launch_lock = threading.Lock()
_lib = None
_lib_lock = threading.Lock()
_checked_devices: set = set()


# ------------------------------------------------------------ launch counts

def count_launch(name: str):
    with _launch_lock:
        LAUNCHES[name] += 1


def reset_launches():
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> dict:
    with _launch_lock:
        return dict(LAUNCHES)


def _sinks() -> list:
    """The op counters (``launch/op_analysis.py``) active here: the
    dispatch modes on this thread's mode stack with an ``add_kernel(name,
    cost, bound)`` method. A mode sees only its own thread's ops (and
    those of the autograd threads a backward runs on, which inherit the
    stack), so it takes only those launches."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return [m for m in _get_current_dispatch_mode_stack()
            if hasattr(m, "add_kernel")]


# ----------------------------------------------------------------- dispatch

def on_cpu(*tensors) -> bool:
    """True when every given tensor lies on the CPU (→ plain version),
    False when all lie on CUDA devices (→ kernel) or all on ``meta`` (→
    the kernel's path, dry: :func:`launch` launches nothing there). Mixed
    or other devices raise: they reach neither."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs in ({"cuda"}, {"meta"}):
        return False
    raise ValueError(f"kernel inputs on unsupported devices {sorted(devs)}")


def is_dry(t: torch.Tensor) -> bool:
    """True for a tensor on ``meta``: a cost reads its bound, not data."""
    return t.device.type == "meta"


def require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------- recording

_recording = threading.local()


@contextlib.contextmanager
def recording():
    """Keep every call of a :func:`recorded` wrapper made on this thread
    inside the block: yields the list they go to, each ``(kernel,
    wrapper, plain, args, kwargs)`` with the wrapper's defaults applied.
    The inputs are kept by reference: :func:`replay` them before anything
    overwrites them."""
    calls: list = []
    outer = getattr(_recording, "calls", None)
    _recording.calls = calls
    try:
        yield calls
    finally:
        _recording.calls = outer


def recorded(kernel_name: str, plain):
    """Decorator of kernel ``kernel_name``'s public wrapper: each call runs
    inside the layer span ``kernel.<kernel_name>`` (its checks, argument
    build and launch; ``obs.layer``), and inside :func:`recording` it is
    kept with ``plain``, the plain version that takes the wrapper's
    arguments."""
    def deco(wrapper):
        sig = inspect.signature(wrapper)
        layer = f"kernel.{kernel_name}"

        @functools.wraps(wrapper)
        def call(*args, **kwargs):
            calls = getattr(_recording, "calls", None)
            if calls is not None:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                calls.append((kernel_name, wrapper, plain, bound.args,
                              bound.kwargs))
            with span(layer):
                return wrapper(*args, **kwargs)
        return call
    return deco


def _outputs(out) -> list:
    return [out] if isinstance(out, torch.Tensor) else list(out)


def _shapes(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tuple(tree.shape)]
    if isinstance(tree, (list, tuple)):
        return [s for x in tree for s in _shapes(x)]
    if isinstance(tree, dict):
        return [s for x in tree.values() for s in _shapes(x)]
    return []


def replay(calls) -> list:
    """Each recorded call run again through its wrapper (a launch on the
    card) and through its plain version, on the same inputs: a list of
    ``(kernel, input shapes, the wrapper's outputs, the plain version's
    outputs)``, outputs as lists of tensors."""
    out = []
    with torch.no_grad():
        for name, wrapper, plain, args, kwargs in calls:
            got = _outputs(wrapper(*args, **kwargs))
            want = _outputs(plain(*args, **kwargs))
            out.append((name, _shapes((args, kwargs)), got, want))
    return out


# ---------------------------------------------------------------- gradients

def grad_wanted(*tensors) -> bool:
    """True when autograd would record a call on ``tensors``: grad mode is
    on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(kernel_name: str, *tensors):
    """A serving-only kernel has no backward: raise where autograd would
    record the call, instead of returning an output without a gradient."""
    if grad_wanted(*tensors):
        raise RuntimeError(
            f"{kernel_name}: the kernel has no backward (it lies on serving "
            f"paths only); call it under torch.no_grad() or with inputs that "
            f"do not require grad")


class _PlainGradient(torch.autograd.Function):
    """Forward: ``forward(*tensors)``, the kernel's launch. Backward: the
    gradient of ``plain(*tensors)``, the kernel's plain version, recomputed
    from the saved inputs. A tensor passed at several positions (one table
    read by two lookups) gets its whole gradient at the first."""

    @staticmethod
    def forward(ctx, forward, plain, *tensors):
        ctx.plain = plain
        first = {}
        ctx.first = [first.setdefault(id(t), i) if t is not None else i
                     for i, t in enumerate(tensors)]
        ctx.save_for_backward(*tensors)
        return forward(*tensors)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = []
            for i, t in enumerate(saved):
                if ctx.first[i] != i:
                    leaves.append(leaves[ctx.first[i]])
                elif t is None:
                    leaves.append(None)
                else:
                    leaves.append(t.detach().requires_grad_(need[i]))
            wrt = [i for i, t in enumerate(leaves) if ctx.first[i] == i
                   and t is not None and t.requires_grad]
            out = ctx.plain(*leaves)
            grads = torch.autograd.grad(out, [leaves[i] for i in wrt], grad,
                                        allow_unused=True)
        res = [None] * len(saved)
        for i, g in zip(wrt, grads):
            res[i] = g
        return (None, None, *res)


def with_plain_gradient(forward, plain, *tensors):
    """``forward(*tensors)`` (the kernel's launch), differentiable as
    ``plain(*tensors)`` (its plain version) is where autograd records the
    call; a bare launch elsewhere. The forward is the kernel's either way:
    the plain version only supplies the backward."""
    if not grad_wanted(*tensors):
        return forward(*tensors)
    return _PlainGradient.apply(forward, plain, *tensors)


# -------------------------------------------------------------------- build

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile every source into the shared library and return its path:
    one ``nvcc -c`` a source, all started together, then one link. A
    library already built from the same sources is reused. The
    compilers' output, ptxas resource usage included, is kept in
    ``build.log`` beside the library. Processes that build at once (the
    ranks of a mesh) take turns on a file lock in the build directory:
    the first compiles, the others find its library."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():                   # built while this one waited
            return lib
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]

        def run(args):
            return subprocess.run([nvcc, *args], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
        objs = [out / f"{src.stem}.{os.getpid()}.o" for src in sources()]
        with concurrent.futures.ThreadPoolExecutor(len(objs)) as pool:
            procs = list(pool.map(run, [
                [*compile_flags, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(sources(), objs)]))
        tmp = out / f"{LIB_NAME}.{os.getpid()}.tmp"
        if all(p.returncode == 0 for p in procs):
            procs.append(run([*NVCC_FLAGS, *map(str, objs), "-o", str(tmp)]))
        log = "".join(p.stdout for p in procs)
        (out / "build.log").write_text(log)
        for obj in objs:
            obj.unlink(missing_ok=True)
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError("nvcc failed:\n" + log)
        os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built on first use and bound with ctypes."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _lib = lib
    return _lib


def kernel(name: str, device: torch.device):
    """C entry point ``name`` for tensors on ``device``; raises unless the
    device is a compute-capability (9, 0) GPU."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _checked_devices:
        cap = torch.cuda.get_device_capability(idx)
        if cap != (9, 0):
            raise RuntimeError(
                f"the port's kernels are built for sm_90a; cuda:{idx} has "
                f"compute capability {cap}")
        _checked_devices.add(idx)
    return getattr(library(), name)


def launch(name: str, counter: str, device: torch.device, *args, cost,
           bound=None):
    """Launch C entry point ``name`` on ``device``'s current stream, raise
    on a launch error, and count the launch under ``counter``. ``cost``
    (a callable returning the launch's (flops, bytes)) is called only
    while an op counter is active, and its result added to each. On
    ``meta`` nothing launches: :func:`dry_launch` (``bound`` names what
    the cost takes as its bound there, where it reads data on the card)."""
    if device.type == "meta":
        dry_launch(counter, cost, bound)
        return
    fn = kernel(name, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    count_launch(counter)
    for sink in _sinks():
        sink.add_kernel(counter, cost)


def dry_launch(counter: str, cost, bound=None):
    """A launch on the ``meta`` device: nothing runs and :data:`LAUNCHES`
    is left as it is; ``cost`` is handed to the active op counters, as a
    launch hands it, with ``bound`` (None where the cost reads only
    shapes)."""
    for sink in _sinks():
        sink.add_kernel(counter, cost, bound)
