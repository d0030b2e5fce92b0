"""Build, load and dispatch policy of the port's hand-written kernels.

Sources live in ``kernels/csrc/*.cu``: CUDA C++ for ``sm_90a`` with a
plain C interface. :func:`build` compiles them with one ``nvcc`` call
into ONE shared library and caches it under
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
    fallback.

Every wrapper counts its launches in :data:`LAUNCHES` (one per launch,
nowhere else), so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C entry points of the library: name → argument types. Each returns the
#: ``cudaGetLastError()`` after its launch as an int (0 = success).
SIGNATURES = {
    "embedding_bag_f32": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    "embedding_bag_bf16": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    "din_attention_f32": [_P] * 11 + [_I] * 5 + [_P],
    "rerank_score_f32": [_P] * 19 + [_I] * 9 + [_P],
}

LAUNCHES = {"embedding_bag": 0, "din_attention": 0, "rerank_score": 0}
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


# ----------------------------------------------------------------- dispatch

def on_cpu(*tensors) -> bool:
    """True when every given tensor lies on the CPU (→ plain version),
    False when all lie on CUDA devices (→ kernel). Mixed or other devices
    raise: they reach neither."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs on unsupported devices {sorted(devs)}")


def require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


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
    """Compile every source into the shared library with one ``nvcc`` call
    and return its path. A library already built from the same sources is
    reused. The compiler's output, ptxas resource usage included, is kept
    in ``build.log`` beside the library."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"{LIB_NAME}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, *map(str, sources()), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (out / "build.log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + proc.stdout)
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


def launch(name: str, counter: str, device: torch.device, *args):
    """Launch C entry point ``name`` on ``device``'s current stream, raise
    on a launch error, and count the launch under ``counter``."""
    fn = kernel(name, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    count_launch(counter)
