"""The port stands alone and dispatches by device.

  * it imports neither ``jax`` nor the reference package ``repro`` (an AST
    scan, and a subprocess in which both imports are blocked serves
    requests);
  * the modules it copies from ``repro`` equal their sources after the
    import rewrite, so the copies cannot drift;
  * entry points default to ``cuda`` and raise where there is none;
  * a CUDA tensor goes to its kernel or raises, and never reaches a plain
    version; without ``nvcc`` the kernel library cannot be loaded.
"""
import ast
import contextlib
import ctypes
import os
import re
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.kernels as K
from repro_torch.kernels.din_attention import ops as din_ops
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.rerank_score import ops as rerank_ops

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}

#: modules the port carries unchanged but for ``repro`` → ``repro_torch``
#: in its import statements
VERBATIM = (
    ["configs/base.py", "configs/registry.py", "configs/other_archs.py",
     "configs/lm_archs.py", "data/synthetic.py",
     "serve/batcher.py", "serve/hotload.py",
     "update/delta.py", "update/manager.py", "update/policy.py"]
    + [f"core/{m}.py" for m in ("sedp", "executors", "cube", "cube_cache",
                                 "query_cache", "multitenant",
                                 "service_model")]
    + [f"obs/{p.name}" for p in sorted((SRC / "repro" / "obs").glob("*.py"))]
    + [f"faults/{p.name}"
       for p in sorted((SRC / "repro" / "faults").glob("*.py"))])

#: copies with a known edit beyond the import rewrite: (old, new)
EDITED = {"serve/stages.py": [("np.asarray(rt.serve(params, b))[:B]",
                               "rt.serve(params, b).cpu().numpy()[:B]")]}


def _rewrite_imports(text: str) -> str:
    return re.sub(r"^(\s*)(from|import) repro(?=[.\s])", r"\1\2 repro_torch",
                  text, flags=re.M)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")


# ---------------------------------------------------------------- imports

def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & FORBIDDEN)
           for p in files if _imported_roots(p) & FORBIDDEN}
    assert bad == {}


@pytest.mark.parametrize("rel", VERBATIM + sorted(EDITED))
def test_copied_module_equals_its_source(rel):
    want = _rewrite_imports((SRC / "repro" / rel).read_text())
    for old, new in EDITED.get(rel, []):
        assert want.count(old) == 1, f"{rel}: edit anchor {old!r} moved"
        want = want.replace(old, new)
    assert (PORT / rel).read_text() == want


def test_service_serves_with_jax_and_reference_blocked():
    """A fresh interpreter in which ``import jax`` and ``import repro``
    fail builds the port's service on the CPU and answers 8 requests."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        from repro_torch.core.service import InferenceService, ServiceConfig
        svc = InferenceService(ServiceConfig(arch_id="din", batch_size=8),
                               device="cpu")
        rep = svc.run(n_requests=8, executor="async")
        assert rep.errors == 0 and rep.completed == 8, rep
        scores = [ev.meta["response"].score for ev in rep.results]
        assert all(s is not None and 0.0 <= s <= 1.0 for s in scores), scores
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro")
                        and sys.modules[m] is not None)
        assert not loaded, loaded
        print("served", len(scores))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=150)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served 8" in out.stdout


# ------------------------------------------------------- default device

def _entry_points():
    from repro_torch import default_device
    from repro_torch.configs import registry
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.irm.shedding import PruningDNN
    from repro_torch.core.service import InferenceService, ServiceConfig
    from repro_torch.models import layers
    from repro_torch.models.recsys import common, din
    from repro_torch.serve.bucketing import (ShapeBucketer,
                                             bucketed_candidate_rerank)
    from repro_torch.sparse.embedding import TableSpec, init_table

    arch = registry.get("din")
    cfg = arch.reduced(arch.config)
    one = ShapeBucketer((4,))
    return {
        "default_device": lambda: default_device(),
        "InferenceService": lambda: InferenceService(ServiceConfig()),
        "din.init": lambda: din.init(torch.Generator(), cfg),
        "tables_init": lambda: common.tables_init(torch.Generator(), cfg),
        "mlp_tower_init": lambda: layers.mlp_tower_init(torch.Generator(),
                                                        4, (2,)),
        "init_table": lambda: init_table(torch.Generator(),
                                         TableSpec("t", 8, 2)),
        "PruningDNN": lambda: PruningDNN(),
        "params_from_numpy": lambda: params_from_numpy({"w": np.zeros(2)}),
        "bucketed_candidate_rerank": lambda: bucketed_candidate_rerank(
            None, None, None, {}, [(1, 0.5)], one, one),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda(name):
    """Without ``device="cpu"`` every entry point asks for ``cuda`` and,
    on a machine without one, raises instead of running on the CPU."""
    _no_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


# ------------------------------------------------------------- dispatch

class FakeCuda:
    """A CPU tensor that reports a CUDA device: what a wrapper sees of a
    CUDA tensor up to the launch, on a machine without one."""

    def __init__(self, t: torch.Tensor):
        self.t = t
        self.device = torch.device("cuda", 0)
        self.shape, self.dtype = t.shape, t.dtype

    def dim(self):
        return self.t.dim()

    def numel(self):
        return self.t.numel()

    def is_contiguous(self):
        return self.t.is_contiguous()

    def is_floating_point(self):
        return self.t.is_floating_point()

    def data_ptr(self):
        return self.t.data_ptr()

    def long(self):
        return FakeCuda(self.t.long())

    def float(self):
        return FakeCuda(self.t.float())

    def __getitem__(self, key):
        return self.t[key]


@pytest.fixture()
def fake_card(monkeypatch):
    """Stands in for the card: outputs allocated "on cuda" are FakeCuda,
    the library's entries check their arguments against the declared
    ctypes signature and record the call, and the plain versions fail the
    test if anything reaches them."""
    calls, status = [], {"rc": 0}
    real_empty = torch.empty

    def empty(*shape, dtype=None, device=None, **kw):
        if device is not None and torch.device(device).type == "cuda":
            return FakeCuda(real_empty(*shape, dtype=dtype))
        return real_empty(*shape, dtype=dtype, device=device, **kw)

    def entry(name):
        def fn(*args):
            argtypes = K.SIGNATURES[name]
            assert len(args) == len(argtypes), name
            for a, ty in zip(args, argtypes):
                assert a is None or isinstance(a, int), (name, a)
                ty(a)                     # fits the declared C type
            calls.append((name, args))
            return status["rc"]
        return fn

    def reached_plain(*_a, **_k):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(K, "kernel", lambda name, device: entry(name))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    for mod, ref in ((bag_ops, "embedding_bag_ref"),
                     (din_ops, "din_attention_ref"),
                     (rerank_ops, "rerank_score_ref")):
        monkeypatch.setattr(mod, ref, reached_plain)
    return calls, status


def _rng_tensors(rng, *shapes):
    return [FakeCuda(torch.as_tensor(rng.normal(size=s), dtype=torch.float32))
            for s in shapes]


def _launch_cases(rng):
    D, T, B, H1, H2 = 4, 6, 3, 8, 5
    ids = FakeCuda(torch.as_tensor(rng.integers(0, 10, (B, 2))))
    table, w = _rng_tensors(rng, (10, D), (B, 2))
    din_args = _rng_tensors(rng, (B, T, D), (B, T), (B, D), (4 * D, H1),
                            (H1,), (H1, H2), (H2,), (H2, 1), (1,))
    C, du, di, M1, M2 = 5, 3, 2, 7, 6
    hist, mask, tgt, uo, io = _rng_tensors(rng, (T, D), (T,), (C, D), (du,),
                                           (C, di))

    def tower(*dims):
        return [dict(zip(("w", "b"), _rng_tensors(rng, (a, b), (b,))))
                for a, b in zip(dims[:-1], dims[1:])]

    return {
        "embedding_bag": (lambda: bag_ops.embedding_bag(table, ids, w, "mean"),
                          (B, D), "embedding_bag_f32"),
        "din_attention": (lambda: din_ops.din_attention(*din_args), (B, D),
                          "din_attention_f32"),
        "rerank_score": (lambda: rerank_ops.rerank_score(
            hist, mask, tgt, uo, io, tower(4 * D, H1, H2, 1),
            tower(2 * D + du + di, M1, M2, 1)), (C,), "rerank_score_f32"),
    }


@pytest.mark.parametrize("kernel", ["embedding_bag", "din_attention",
                                    "rerank_score"])
def test_cuda_tensors_launch_the_kernel(kernel, fake_card, rng):
    """The wrapper hands the C entry arguments of its declared types,
    returns the output it allocated on the tensors' device, and counts
    exactly one launch; the plain version is never called."""
    calls, _status = fake_card
    fn, shape, entry = _launch_cases(rng)[kernel]
    before = K.launch_counts()
    out = fn()
    assert isinstance(out, FakeCuda) and tuple(out.shape) == shape
    assert [c[0] for c in calls] == [entry]
    assert out.data_ptr() in calls[0][1]            # the kernel writes it
    after = K.launch_counts()
    assert after[kernel] == before[kernel] + 1
    assert {k: after[k] - before[k] for k in after if k != kernel} == \
        {k: 0 for k in after if k != kernel}


@pytest.mark.parametrize("kernel", ["embedding_bag", "din_attention",
                                    "rerank_score"])
def test_failed_launch_raises_and_is_not_counted(kernel, fake_card, rng):
    _calls, status = fake_card
    status["rc"] = 9                          # cudaErrorInvalidConfiguration
    fn, _shape, _entry = _launch_cases(rng)[kernel]
    before = K.launch_counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        fn()
    assert K.launch_counts() == before


def test_mixed_devices_reach_neither_version():
    cpu = torch.zeros(2)
    with pytest.raises(ValueError, match="unsupported devices"):
        K.on_cpu(cpu, FakeCuda(cpu))
    assert K.on_cpu(cpu, None) is True
    assert K.on_cpu(FakeCuda(cpu)) is False


def test_wrong_capability_raises(monkeypatch):
    monkeypatch.setattr(K, "_checked_devices", set())
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i: (8, 0))
    with pytest.raises(RuntimeError, match="compute capability"):
        K.kernel("embedding_bag_f32", torch.device("cuda", 0))


def test_library_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc (as on a CPU-only machine): loading the library raises; no
    plain version is handed back in its place."""
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(K, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(K, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.library()
    assert K._lib is None
    assert not (K.build_dir() / K.LIB_NAME).exists()


def test_library_signatures_match_the_sources():
    """Every declared C entry exists in the CUDA sources with the same
    number of parameters."""
    text = "\n".join(p.read_text() for p in K.sources())
    for name, argtypes in K.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name


@pytest.mark.parametrize("source,module,names", [
    ("din_attention.cu", din_ops, {"kChunk": "CHUNK"}),
    ("rerank_score.cu", rerank_ops, {"kChunk": "CHUNK", "kCands": "CANDS"})])
def test_wrapper_tiling_constants_match_the_sources(source, module, names):
    """The wrappers size their scratch and shared memory with the same
    tile constants the kernels are compiled with."""
    text = (K.CSRC / source).read_text()
    for cname, pyname in names.items():
        m = re.search(r"constexpr int " + cname + r" = (\d+);", text)
        assert m and int(m.group(1)) == getattr(module, pyname), cname


def test_ctypes_pointer_types_are_wide():
    """Pointers and the stream travel as c_void_p (a plain int would be
    cut to 32 bits)."""
    for name, argtypes in K.SIGNATURES.items():
        assert argtypes[-1] is ctypes.c_void_p, name
        assert ctypes.c_void_p in argtypes[:4], name
