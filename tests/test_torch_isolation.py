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
from repro_torch.kernels.augru import ops as augru_ops
from repro_torch.kernels.candidate_scorer import ops as scorer_ops
from repro_torch.kernels.din_attention import ops as din_ops
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.flash_decode import ops as decode_ops
from repro_torch.kernels.mla_decode import ops as mla_ops
from repro_torch.kernels.rerank_score import ops as rerank_ops

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}

#: modules the port carries unchanged but for ``repro`` → ``repro_torch``
#: in its import statements
VERBATIM = (
    ["configs/base.py", "configs/registry.py", "configs/other_archs.py",
     "configs/lm_archs.py", "configs/jizhi_service.py", "data/synthetic.py",
     "serve/batcher.py", "serve/hotload.py", "update/__init__.py",
     "update/delta.py", "update/manager.py", "update/policy.py",
     "update/snapshot.py", "train/elastic.py", "data/pipeline.py",
     "data/sampler.py"]
    + [f"core/{m}.py" for m in ("sedp", "executors", "cube", "cube_cache",
                                 "query_cache", "multitenant",
                                 "service_model")]
    + [f"obs/{p.name}" for p in sorted((SRC / "repro" / "obs").glob("*.py"))]
    + [f"faults/{p.name}"
       for p in sorted((SRC / "repro" / "faults").glob("*.py"))]
    + [f"mesh/{p.name}" for p in sorted((SRC / "repro" / "mesh").glob("*.py"))]
    + [f"core/irm/{m}.py" for m in ("cmaes", "models", "offline")])

#: copies with a known edit beyond the import rewrite: (old, new)
EDITED = {"serve/stages.py": [("np.asarray(rt.serve(params, b))[:B]",
                               "rt.serve(params, b).cpu().numpy()[:B]")],
          # the published DeepSeek-V2-Lite decode: dropless, un-renormalised
          # gates and YaRN rope (the JAX package's defaults unchanged)
          "configs/base.py": [
              ("    capacity_factor: float = 1.25\n"
               "    router_scale: Optional[float] = None\n",
               "    capacity_factor: Optional[float] = 1.25  # None: dropless "
               "(no pair dropped)\n"
               "    router_scale: Optional[float] = None\n"
               "    norm_topk_prob: bool = True      # renormalise the top-k "
               "gates to sum 1\n\n\n"
               "@dataclass(frozen=True)\n"
               "class RopeScaling:\n"
               '    """YaRN rope scaling, under the published ``rope_scaling`` '
               'keys."""\n'
               "    factor: float\n"
               "    original_max_position_embeddings: int\n"
               "    beta_fast: float = 32.0\n"
               "    beta_slow: float = 1.0\n"
               "    mscale: float = 1.0\n"
               "    mscale_all_dim: float = 0.0\n"
               '    type: str = "yarn"\n'),
              ("    rope_theta: float = 1e6\n",
               "    rope_theta: float = 1e6\n"
               "    rope_scaling: Optional[RopeScaling] = None  # None: plain "
               "RoPE\n")],
          # the port's layer spans (obs/layer.py, the port's own module)
          "obs/__init__.py": [
              ("from repro_torch.obs.log import",
               "from repro_torch.obs.layer import span  # noqa: F401\n"
               "from repro_torch.obs.log import"),
              ('"read_history",\n]', '"read_history", "span",\n]')]}


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


@pytest.mark.parametrize(
    "rel", [r for r in VERBATIM if r not in EDITED] + sorted(EDITED))
def test_copied_module_equals_its_source(rel):
    want = _rewrite_imports((SRC / "repro" / rel).read_text())
    for old, new in EDITED.get(rel, []):
        assert want.count(old) == 1, f"{rel}: edit anchor {old!r} moved"
        want = want.replace(old, new)
    assert (PORT / rel).read_text() == want


def test_service_serves_with_jax_and_reference_blocked():
    """A fresh interpreter in which ``import jax`` and ``import repro``
    fail builds the port's services on the CPU: the DIN re-rank service
    answers 8 requests, the four-scenario service (DIN, DIEN, MIND,
    two-tower) answers 8 in every scenario, and a DIN service with an HBM
    head applies a delta, snapshots at shutdown and recovers from it."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        from repro_torch.core.service import (InferenceService,
                                              MultiScenarioService,
                                              ServiceConfig)
        svc = InferenceService(ServiceConfig(arch_id="din", batch_size=8),
                               device="cpu")
        rep = svc.run(n_requests=8, executor="async")
        assert rep.errors == 0 and rep.completed == 8, rep
        scores = [ev.meta["response"].score for ev in rep.results]
        assert all(s is not None and 0.0 <= s <= 1.0 for s in scores), scores
        multi = MultiScenarioService(
            ("din-rerank", "dien-rerank", "mind-retrieval",
             "towers-retrieval"), device="cpu")
        rep = multi.run(n_requests=8, executor="async")
        by = multi.by_scenario(rep)
        assert rep.errors == 0 and sorted(len(v) for v in by.values()) == \
            [8] * 4, {k: len(v) for k, v in by.items()}
        assert all(ev.meta["response"].topk for ev in rep.results)
        # a head, live updates, a snapshot, and a recovery from it
        import os, shutil, tempfile
        import numpy as np
        from repro_torch.update import DeltaEmitter, GroupDelta
        d = tempfile.mkdtemp()
        cfg = dict(arch_id="din", batch_size=8, shed=False, head_slots=32,
                   live_updates=True, update_dir=os.path.join(d, "log"),
                   snapshot_dir=os.path.join(d, "snaps"))
        os.makedirs(cfg["update_dir"])
        svc = InferenceService(ServiceConfig(**cfg), device="cpu")
        wave = svc.run(n_requests=32, executor="sim")
        keys = np.unique([int(ev.payload["hashed"]["item_id"])
                          for ev in wave.results])
        DeltaEmitter(cfg["update_dir"]).emit([GroupDelta(
            group=0, ids=keys,
            rows=np.ones((len(keys), 4), np.float32))])
        assert svc.update_watcher.check_once()
        assert svc.updates.head.table.device.type == "cpu"
        assert svc.updates.head.stats.promotions > 0
        assert svc.shutdown() is not None
        rec = InferenceService(ServiceConfig(recover=True, **cfg),
                               device="cpu")
        assert rec.updates.stats.last_version == 0
        assert not rec.substrate.recovering
        again = rec.run(n_requests=8, executor="sim")
        assert again.errors == 0 and again.completed == 8, again
        shutil.rmtree(d)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro")
                        and sys.modules[m] is not None)
        assert not loaded, loaded
        print("served", len(scores), "and", len(rep.results))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=150)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served 8 and 32" in out.stdout


def test_lm_service_serves_with_jax_and_reference_blocked():
    """A fresh interpreter in which ``import jax`` and ``import repro``
    fail imports the LM path (transformer, attention, MoE, the
    flash_decode kernel's wrapper, the launchers, the training modules)
    and serves 6 requests of reduced smollm-135m on the CPU, then trains
    it 2 steps with a checkpoint and resumes from it."""
    script = textwrap.dedent("""
        import argparse
        import sys
        import tempfile
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.kernels.flash_decode
        import repro_torch.models.attention
        import repro_torch.models.moe
        import repro_torch.models.transformer
        import repro_torch.data.pipeline
        import repro_torch.train.checkpoint
        import repro_torch.train.elastic
        import repro_torch.train.optimizer
        import repro_torch.train.train_step
        from repro_torch.launch.serve import serve_lm
        from repro_torch.launch.train import parser, train
        fig = serve_lm(argparse.Namespace(arch="smollm-135m", requests=6,
                                          reduced=True), device="cpu")
        assert fig["completed"] == 6 and fig["steps"] > 0, fig
        d = tempfile.mkdtemp()
        args = parser().parse_args(["--reduced", "--steps", "2",
                                    "--ckpt-dir", d, "--ckpt-every", "1"])
        first = train(args, device="cpu")
        again = train(args, device="cpu")
        assert again["start_step"] == first["end_step"] == 2, again
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro")
                        and sys.modules[m] is not None)
        assert not loaded, loaded
        print("completed", fig["completed"])
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=150)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "completed 6" in out.stdout


# ------------------------------------------------------- default device

def _entry_points():
    from repro_torch import default_device
    from repro_torch.configs import registry
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.irm.shedding import PruningDNN
    from repro_torch.core.service import (InferenceService,
                                          MultiScenarioService, ServiceConfig)
    from repro_torch.models import layers
    from repro_torch.models.recsys import common, dien, din, mind, towers
    from repro_torch.serve.bucketing import (ShapeBucketer,
                                             bucketed_candidate_rerank)
    from repro_torch.sparse.embedding import TableSpec, init_table
    from repro_torch.convert import kv_cache_from_numpy
    from repro_torch.launch.serve import serve_lm, serve_recsys
    from repro_torch.launch.train import parser as train_parser
    from repro_torch.launch.train import train
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import moe, schnet, transformer
    from repro_torch.serve.scenario import ServingSubstrate
    from repro_torch.update import HBMHead

    def reduced(arch_id):
        arch = registry.get(arch_id)
        return arch.reduced(arch.config)

    cfg = reduced("din")
    one = ShapeBucketer((4,))
    return {
        "default_device": lambda: default_device(),
        "InferenceService": lambda: InferenceService(ServiceConfig()),
        "MultiScenarioService": lambda: MultiScenarioService(),
        "din.init": lambda: din.init(torch.Generator(), cfg),
        "dien.init": lambda: dien.init(torch.Generator(), reduced("dien")),
        "mind.init": lambda: mind.init(torch.Generator(), reduced("mind")),
        "towers.init": lambda: towers.init(
            torch.Generator(), reduced("two-tower-retrieval")),
        "tables_init": lambda: common.tables_init(torch.Generator(), cfg),
        "mlp_tower_init": lambda: layers.mlp_tower_init(torch.Generator(),
                                                        4, (2,)),
        "init_table": lambda: init_table(torch.Generator(),
                                         TableSpec("t", 8, 2)),
        "PruningDNN": lambda: PruningDNN(),
        "params_from_numpy": lambda: params_from_numpy({"w": np.zeros(2)}),
        "bucketed_candidate_rerank": lambda: bucketed_candidate_rerank(
            None, None, None, {}, [(1, 0.5)], one, one),
        "transformer.init": lambda: transformer.init(
            torch.Generator(), reduced("smollm-135m")),
        "KVCache.zeros": lambda: transformer.KVCache.zeros(
            reduced("smollm-135m"), 1, 8),
        "kv_cache_from_numpy": lambda: kv_cache_from_numpy(
            transformer.KVCache(np.zeros(2), np.zeros(2), np.int32(0))),
        "norm_init": lambda: layers.norm_init(4, "rmsnorm", "float32"),
        "mlp_init": lambda: layers.mlp_init(torch.Generator(), 4, 8, 4, True,
                                            "float32"),
        "moe_expert_init": lambda: moe.moe_expert_init(
            torch.Generator(), 8, reduced("deepseek-v2-lite-16b").moe,
            "float32"),
        "serve_lm": lambda: serve_lm(types.SimpleNamespace(
            arch="smollm-135m", requests=1, reduced=True)),
        "HBMHead": lambda: HBMHead(8, 4),
        "ServingSubstrate(head_slots=8)": lambda: ServingSubstrate(
            head_slots=8),
        "serve_recsys": lambda: serve_recsys(types.SimpleNamespace(
            arch="din", requests=1, snapshot_dir=None, recover=False,
            update_dir=None, metrics_port=0, metrics_out=None,
            history_dir=None, history_interval_s=1.0, trace_out=None)),
        "train": lambda: train(train_parser().parse_args(
            ["--reduced", "--steps", "1", "--ckpt-dir",
             str(ROOT / "build" / "never_written")])),
        "schnet.init": lambda: schnet.init(0, reduced("schnet")),
        "run_cell": lambda: run_cell("schnet", "molecule",
                                     str(ROOT / "build" / "never_written"),
                                     reduced=True),
        "build_cell(...).materialize": lambda: build_cell(
            "schnet", "molecule", reduced=True).materialize(),
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

    def element_size(self):
        return self.t.element_size()

    def data_ptr(self):
        return self.t.data_ptr()

    def long(self):
        return FakeCuda(self.t.long())

    def float(self):
        return FakeCuda(self.t.float())

    def __getitem__(self, key):
        return self.t[key]


#: SM count x resident blocks per SM the fake card states for the split plan
STATED_SLOTS = 132 * 2


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
                want = float if ty is ctypes.c_float else int
                assert a is None or isinstance(a, want), (name, a)
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
    # the split plan's card: 132 SMs, two resident split blocks each
    monkeypatch.setattr(decode_ops, "device_slots", lambda *a: STATED_SLOTS)
    for mod, ref in ((bag_ops, "embedding_bag_ref"),
                     (din_ops, "din_attention_ref"),
                     (rerank_ops, "rerank_score_ref"),
                     (augru_ops, "augru_ref"),
                     (scorer_ops, "candidate_scorer_ref"),
                     (decode_ops, "flash_decode_ref")):
        monkeypatch.setattr(mod, ref, reached_plain)
    return calls, status


class DeviceLength(FakeCuda):
    """A valid length held on the card: reading it on the host (``.item()``,
    ``int()``) would wait for the device, and fails the test."""

    def __init__(self, n: int):
        super().__init__(torch.tensor(n, dtype=torch.int32))

    def item(self):
        raise AssertionError("cache_len was read on the host")

    def __int__(self):
        raise AssertionError("cache_len was read on the host")

    __index__ = __int__


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

    Din, H = 7, 9
    augru_args = _rng_tensors(rng, (B, T, Din), (B, T), (Din, 3 * H),
                              (H, 3 * H), (3 * H,))
    cands, query = _rng_tensors(rng, (C, 2 * D), (2 * D,))
    S, Hkv, G, Dh = 40, 2, 3, 16
    q, kc, vc = _rng_tensors(rng, (B, Hkv, G, Dh), (B, S, Hkv, Dh),
                             (B, S, Hkv, Dh))
    return {
        "embedding_bag": (lambda: bag_ops.embedding_bag(table, ids, w, "mean"),
                          [(B, D)], "embedding_bag_f32"),
        "din_attention": (lambda: din_ops.din_attention(*din_args), [(B, D)],
                          "din_attention_f32"),
        "rerank_score": (lambda: rerank_ops.rerank_score(
            hist, mask, tgt, uo, io, tower(4 * D, H1, H2, 1),
            tower(2 * D + du + di, M1, M2, 1)), [(C,)], "rerank_score_f32"),
        "augru": (lambda: augru_ops.augru(*augru_args), [(B, H)],
                  "augru_f32"),
        # one block of candidates: the kernel's own top-k is the answer
        "candidate_scorer": (lambda: scorer_ops.candidate_scorer(
            cands, query, k=3), [(3,), (3,)], "candidate_scorer_f32"),
        "flash_decode": (lambda: decode_ops.flash_decode(
            q, kc, vc, DeviceLength(S - 3)), [(B, Hkv, G, Dh)],
            "flash_decode_f32"),
    }


KERNELS = ["embedding_bag", "din_attention", "rerank_score", "augru",
           "candidate_scorer", "flash_decode"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_tensors_launch_the_kernel(kernel, fake_card, rng):
    """The wrapper hands the C entry arguments of its declared types,
    returns the outputs it allocated on the tensors' device, and counts
    exactly one launch; the plain version is never called."""
    calls, _status = fake_card
    fn, shapes, entry = _launch_cases(rng)[kernel]
    before = K.launch_counts()
    outs = fn()
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert [tuple(o.shape) for o in outs] == shapes
    assert [c[0] for c in calls] == [entry]
    for out in outs:
        assert isinstance(out, FakeCuda)
        assert out.data_ptr() in calls[0][1]        # the kernel writes it
    after = K.launch_counts()
    assert after[kernel] == before[kernel] + 1
    assert {k: after[k] - before[k] for k in after if k != kernel} == \
        {k: 0 for k in after if k != kernel}


@pytest.mark.parametrize("kernel", KERNELS)
def test_failed_launch_raises_and_is_not_counted(kernel, fake_card, rng):
    _calls, status = fake_card
    status["rc"] = 9                          # cudaErrorInvalidConfiguration
    fn, _shape, _entry = _launch_cases(rng)[kernel]
    before = K.launch_counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        fn()
    assert K.launch_counts() == before


def test_flash_decode_wrapper_reads_the_length_on_the_device(fake_card, rng):
    """The wrapper hands the kernel the length's device address (never its
    value), allocates the (B,H,G,D) output and a float32 workspace of one
    (m, l, acc[G,D]) per (b, h, split), and splits S by the shapes and the
    card alone; with one split there is no workspace (the kernel writes
    the output itself)."""
    calls, _status = fake_card
    B, S, H, G, D = 2, 700, 3, 4, 32
    q, kc, vc = _rng_tensors(rng, (B, H, G, D), (B, S, H, D), (B, S, H, D))
    length = DeviceLength(650)
    out = decode_ops.flash_decode(q, kc, vc, length, scale=0.25)
    (name, args), = calls
    assert name == "flash_decode_f32" and isinstance(out, FakeCuda)
    assert tuple(out.shape) == (B, H, G, D)
    chunk, n_split = decode_ops.split_plan(B, H, S, STATED_SLOTS)
    assert (chunk, n_split) == (256, 3)
    ptrs = args[:6]
    assert ptrs[:4] == (q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                        length.data_ptr())
    assert ptrs[4] is not None and ptrs[5] == out.data_ptr()
    assert args[6:13] == (B, H, G, D, S, chunk, n_split)
    assert args[13] == 0.25
    calls.clear()
    q1, k1, v1 = _rng_tensors(rng, (4, 3, 3, 64), (4, 64, 3, 64),
                              (4, 64, 3, 64))
    out = decode_ops.flash_decode(q1, k1, v1, DeviceLength(40))
    (name, args), = calls
    assert args[4] is None and args[5] == out.data_ptr()
    assert args[11:13] == (64, 1)
    with pytest.raises(ValueError, match="int32"):
        decode_ops.flash_decode(q, kc, vc, FakeCuda(torch.tensor(5)))
    with pytest.raises(ValueError, match="head dim"):
        q2, k2, v2 = _rng_tensors(rng, (1, 1, 1, 24), (1, 8, 1, 24),
                                  (1, 8, 1, 24))
        decode_ops.flash_decode(q2, k2, v2, DeviceLength(4))
    with pytest.raises(ValueError, match="at most 16 query heads"):
        q3, k3, v3 = (FakeCuda(torch.zeros(s, dtype=torch.bfloat16))
                      for s in ((1, 1, 17, 16), (1, 8, 1, 16), (1, 8, 1, 16)))
        decode_ops.flash_decode(q3, k3, v3, DeviceLength(4))


def test_flash_decode_wrapper_hands_the_lse_buffer(fake_card, rng):
    """``return_lse`` allocates a float32 (B,H,G) lse and hands the kernel
    its address after the scale; the default call hands null there and
    returns the output alone. Either way one launch."""
    calls, _status = fake_card
    B, S, H, G, D = 2, 700, 3, 4, 32
    q, kc, vc = _rng_tensors(rng, (B, H, G, D), (B, S, H, D), (B, S, H, D))
    before = K.launch_counts()["flash_decode"]
    out, lse = decode_ops.flash_decode(q, kc, vc, DeviceLength(0),
                                       return_lse=True)
    (name, args), = calls
    assert isinstance(lse, FakeCuda) and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, H, G) and args[14] == lse.data_ptr()
    assert args[5] == out.data_ptr()
    calls.clear()
    plain = decode_ops.flash_decode(q, kc, vc, DeviceLength(650))
    (name, args), = calls
    assert isinstance(plain, FakeCuda) and args[14] is None
    assert len(args) == len(K.SIGNATURES[name])      # the stream last
    assert K.launch_counts()["flash_decode"] == before + 2


def _record_allocations(monkeypatch):
    """The shapes of everything the wrapper allocates on the card."""
    shapes, empty = [], torch.empty

    def recording(*shape, **kw):
        t = empty(*shape, **kw)
        if isinstance(t, FakeCuda):
            shapes.append(tuple(t.shape))
        return t
    monkeypatch.setattr(torch, "empty", recording)
    return shapes


#: B4 shapes (B, T, Din, H): DIEN's path, the reference's sweep and edge
#: cells, H = 1, and the largest H the kernel holds in registers
AUGRU_SHAPES = [(64, 100, 108, 108), (16, 100, 108, 108), (8, 8, 8, 8),
                (16, 100, 18, 108), (4, 25, 12, 20), (1, 7, 6, 10),
                (4, 1, 6, 10), (2, 3, 5, 1), (3, 4, 9, 112)]


@pytest.mark.parametrize("B,T,Din,H", AUGRU_SHAPES)
def test_augru_wrapper_hands_the_kernel_its_projection_scratch(
        B, T, Din, H, fake_card, monkeypatch, rng):
    """B4's wrapper admits the shape and hands the C entry the (B, H)
    output and a (B*T, NP) float32 scratch for the input projection, NP =
    3H rounded up to a multiple of 4 (the recurrence copies gx rows in
    16-byte pieces)."""
    calls, _status = fake_card
    shapes = _record_allocations(monkeypatch)
    args_in = _rng_tensors(rng, (B, T, Din), (B, T), (Din, 3 * H), (H, 3 * H),
                           (3 * H,))
    out = augru_ops.augru(*args_in)
    (name, args), = calls
    np_cols = augru_ops.gx_cols(H)
    assert np_cols % 4 == 0 and 3 * H <= np_cols < 3 * H + 4
    assert name == "augru_f32" and shapes == [(B, H), (B * T, np_cols)]
    assert args[:5] == tuple(t.data_ptr() for t in args_in)
    assert args[6] == out.data_ptr() and args[5] not in args[:5] + (args[6],)
    assert args[7:11] == (B, T, Din, H)


@pytest.mark.parametrize("H", [augru_ops.MAX_H + 1, 200, 341])
def test_augru_wrapper_raises_beyond_the_register_limit(H, fake_card, rng):
    """Above MAX_H (U held in registers, 4 threads of 28 rows per unit) the
    wrapper raises before it allocates or launches anything."""
    calls, _status = fake_card
    before = K.launch_counts()
    with pytest.raises(ValueError, match="registers"):
        augru_ops.augru(*_rng_tensors(rng, (2, 3, 4), (2, 3), (4, 3 * H),
                                      (H, 3 * H), (3 * H,)))
    assert calls == [] and K.launch_counts() == before


def _rerank_args(rng, C, T, D, du, di, H1, H2, M1, M2):
    hist, mask, tgt, uo, io = _rng_tensors(rng, (T, D), (T,), (C, D), (du,),
                                           (C, di))

    def tower(*dims):
        return [dict(zip(("w", "b"), _rng_tensors(rng, (a, b), (b,))))
                for a, b in zip(dims[:-1], dims[1:])]
    return (hist, mask, tgt, uo, io, tower(4 * D, H1, H2, 1),
            tower(2 * D + du + di, M1, M2, 1))


@pytest.mark.parametrize("C,T", [(64, 100), (1, 1), (33, 300)])
def test_rerank_wrapper_hands_the_kernel_no_scratch(C, T, fake_card,
                                                    monkeypatch, rng):
    """B1 runs as one launch whose blocks sum their partial pooled vectors
    through distributed shared memory: the wrapper allocates the (C,)
    output and nothing else, and hands the C entry the shapes."""
    calls, _status = fake_card
    shapes = _record_allocations(monkeypatch)
    args_in = _rerank_args(rng, C, T, 18, 36, 18, 80, 40, 200, 80)
    out = rerank_ops.rerank_score(*args_in)
    (name, args), = calls
    assert name == "rerank_score_f32" and shapes == [(C,)]
    assert args[17] == out.data_ptr()
    assert args[18:27] == (T, 18, C, 36, 18, 80, 40, 200, 80)


@pytest.mark.parametrize("H1,H2", [(rerank_ops.MAX_H1 + 1, 40),
                                   (80, rerank_ops.MAX_H2 + 1)])
def test_rerank_wrapper_raises_beyond_its_tiles(H1, H2, fake_card, rng):
    calls, _status = fake_card
    before = K.launch_counts()
    with pytest.raises(ValueError, match="tiles"):
        rerank_ops.rerank_score(*_rerank_args(rng, 8, 10, 4, 3, 2, H1, H2,
                                              7, 6))
    assert calls == [] and K.launch_counts() == before


def _bag_groups(rng, spec, dtype=torch.float32):
    """(table, ids, weights, combiner) groups on the fake card from
    (V, D, B, K, weighted, combiner) tuples."""
    out = []
    for V, D, B, K, weighted, comb in spec:
        table = FakeCuda(torch.as_tensor(rng.normal(size=(V, D))).to(dtype))
        ids = FakeCuda(torch.as_tensor(rng.integers(0, V, (B, K))))
        w = (FakeCuda(torch.as_tensor(rng.random((B, K)), dtype=torch.float32))
             if weighted else None)
        out.append((table, ids, w, comb))
    return out


def _descriptors(address):
    """The groups' descriptors as the C entry receives them."""
    return bag_ops._Groups.from_address(address)


def test_grouped_bag_is_one_launch_with_descriptors_by_value(fake_card,
                                                            monkeypatch, rng):
    """One grouped call: one launch of the C entry with one pointer (the
    descriptors, read by the entry and passed on by value: nothing is
    copied to the device), one count, one output buffer of every block,
    each group at its block's row stride and column offset, and the prefix
    offsets of the bags; the plain version is never reached."""
    calls, _status = fake_card
    seen = []
    real = K.kernel

    def entry(name, device):
        fn = real(name, device)

        def call(*args):
            d = _descriptors(args[0])
            seen.append([(g.table, g.ids, g.weights, g.out, g.V, g.K, g.mean,
                          g.out_stride, g.out_col, g.bag0)
                         for g in d.g[:d.n]] + [(d.n, d.D, d.total)])
            return fn(*args)
        return call
    monkeypatch.setattr(K, "kernel", entry)
    shapes = _record_allocations(monkeypatch)
    groups = _bag_groups(rng, [(50, 18, 1600, 1, False, "sum"),
                               (50, 18, 16, 1, False, "sum"),
                               (30, 18, 16, 4, True, "mean"),
                               (20, 18, 16, 1, False, "sum")])
    before = K.launch_counts()
    outs = bag_ops.embedding_bag_group(groups, blocks=(1, 3))
    after = K.launch_counts()
    (name, args), = calls
    assert name == "embedding_bag_group_f32" and len(args) == 2  # + stream
    assert after["embedding_bag"] == before["embedding_bag"] + 1
    assert {k: after[k] - before[k] for k in after if k != "embedding_bag"} \
        == {k: 0 for k in after if k != "embedding_bag"}
    assert shapes == [((1600 + 16 * 3) * 18,)]          # one buffer
    assert [tuple(o.shape) for o in outs] == [(1600, 18), (16, 54)]
    base = outs[0].data_ptr()
    assert outs[1].data_ptr() == base + 1600 * 18 * 4
    (*gs, (n, D, total)), = seen
    assert (n, D, total) == (4, 18, 1600 + 3 * 16)
    table, ids, w, comb = groups[2]
    assert gs[2] == (table.data_ptr(), ids.data_ptr(), w.data_ptr(),
                     outs[1].data_ptr(), 30, 4, 1, 54, 18, 1616)
    assert [g[3] for g in gs] == [base] + [outs[1].data_ptr()] * 3
    assert [(g[7], g[8], g[9]) for g in gs] == [(18, 0, 0), (54, 0, 1600),
                                                (54, 18, 1616), (54, 36, 1632)]
    assert [g[2] for g in gs].count(None) == 3


@pytest.mark.parametrize("bad", ["dtype", "D", "groups", "bags"])
def test_grouped_bag_refuses_what_one_launch_cannot_take(bad, fake_card, rng):
    """Tables of two dtypes or two widths, more groups than MAX_GROUPS, or
    a block whose groups differ in bag count: a ValueError, no launch, no
    count."""
    calls, _status = fake_card
    spec = [(40, 18, 8, 1, False, "sum"), (40, 18, 8, 2, False, "sum")]
    blocks = None
    if bad == "D":
        spec[1] = (40, 20, 8, 2, False, "sum")
    if bad == "groups":
        spec = spec * (bag_ops.MAX_GROUPS // 2) + spec[:1]
    if bad == "bags":
        spec[1] = (40, 18, 9, 2, False, "sum")
        blocks = (2,)
    groups = _bag_groups(rng, spec)
    if bad == "dtype":
        groups[1] = _bag_groups(rng, spec[1:], torch.bfloat16)[0]
    before = K.launch_counts()
    with pytest.raises(ValueError):
        bag_ops.embedding_bag_group(groups, blocks)
    assert calls == [] and K.launch_counts() == before


def test_grouped_bag_descriptors_match_the_source():
    """The ctypes descriptors have the C structs' members, in order and of
    the same types, so the entry reads what the wrapper wrote."""
    text = (K.CSRC / "embedding_bag.cu").read_text()
    ctype = {"int": ctypes.c_int, "long long": ctypes.c_longlong}

    def members(struct):
        body = re.search(r"struct " + struct + r" \{(.*?)\};", text,
                         re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        out = []
        for decl in filter(None, (d.strip() for d in body.split(";"))):
            first, *rest = decl.split(",")
            words = first.split()
            ty = " ".join(words[:-1])
            for name in [words[-1]] + [r.strip() for r in rest]:
                out.append((name.lstrip("*").split("[")[0],
                            ctypes.c_void_p if "*" in ty + name
                            else ctype.get(ty, ty)))
        return out
    group = [(n, t) for n, t in bag_ops._Group._fields_]
    assert members("BagGroup") == group
    groups = members("BagGroups")
    assert groups[0] == ("g", "BagGroup")
    assert groups[1:] == [(n, t) for n, t in bag_ops._Groups._fields_[1:]]
    assert bag_ops._Groups._fields_[0][1]._length_ == bag_ops.MAX_GROUPS


@pytest.mark.parametrize("B,T", [(16, 100), (1, 1), (3, 300), (256, 100)])
def test_din_attention_is_one_launch_without_scratch(B, T, fake_card,
                                                     monkeypatch, rng):
    """B2 runs as one launch of clusters over the chunks of a row, summed
    through distributed shared memory: the wrapper allocates the (B, D)
    output and nothing else, and hands the C entry the shapes."""
    calls, _status = fake_card
    shapes = _record_allocations(monkeypatch)
    D, H1, H2 = 18, 80, 40
    args_in = _rng_tensors(rng, (B, T, D), (B, T), (B, D), (4 * D, H1), (H1,),
                           (H1, H2), (H2,), (H2, 1), (1,))
    out = din_ops.din_attention(*args_in)
    (name, args), = calls
    assert name == "din_attention_f32" and shapes == [(B, D)]
    assert args[9] == out.data_ptr()
    assert args[10:15] == (B, T, D, H1, H2)
    assert args[15] is None            # the steps counter is off on the path


def test_din_attention_computed_steps_hands_the_counter(fake_card,
                                                        monkeypatch, rng):
    """``computed_steps`` launches once with the steps counter on: the C
    entry gets a zeroed int64 on the inputs' device and the wrapper
    reads back what the launch added to it."""
    calls, _status = fake_card
    real_zeros = torch.zeros

    def zeros(*shape, dtype=None, device=None, **kw):
        if device is not None and torch.device(device).type == "cuda":
            return FakeCuda(real_zeros(*shape, dtype=dtype))
        return real_zeros(*shape, dtype=dtype, device=device, **kw)
    monkeypatch.setattr(torch, "zeros", zeros)
    monkeypatch.setattr(FakeCuda, "item", lambda self: self.t.item(),
                        raising=False)
    entry = K.kernel("din_attention_f32", None)

    def counting(*args):
        counter = _at(args[15], (1,), torch.int64)
        assert int(counter[0]) == 0
        counter += 16 * 7
        return entry(*args)
    monkeypatch.setattr(K, "kernel", lambda name, device: counting)
    B, T, D, H1, H2 = 3, 100, 18, 80, 40
    args_in = _rng_tensors(rng, (B, T, D), (B, T), (B, D), (4 * D, H1), (H1,),
                           (H1, H2), (H2,), (H2, 1), (1,))
    assert din_ops.computed_steps(*args_in) == 16 * 7
    (name, args), = calls
    assert name == "din_attention_f32" and isinstance(args[15], int)


@pytest.mark.parametrize("H1,H2", [(din_ops.MAX_H1 + 1, 40),
                                   (80, din_ops.MAX_H2 + 1)])
def test_din_attention_raises_beyond_its_tiles(H1, H2, fake_card, rng):
    calls, _status = fake_card
    before = K.launch_counts()
    with pytest.raises(ValueError, match="tiles"):
        din_ops.din_attention(*_rng_tensors(
            rng, (2, 5, 4), (2, 5), (2, 4), (16, H1), (H1,), (H1, H2), (H2,),
            (H2, 1), (1,)))
    assert calls == [] and K.launch_counts() == before


#: B6's path shapes (B, H, S, dtype, G, D) and the stated resident split
#: blocks per SM at their (dtype, G, D): the LM service (smollm-135m),
#: decode_32k, long_500k (qwen3-8b), starcoder2-7b's geometry, the
#: bf16 serve-like shape at qwen3-8b's, and the reduced LM configs'
#: (d_head 16, up to 2 kv heads, G 1-2, s_max 64)
PLAN_SHAPES = [(4, 3, 64, "f32 serve_lm", 12), (128, 3, 32768, "decode_32k", 12),
               (1, 8, 524288, "long_500k", 2), (8, 4, 4096, "starcoder2", 2),
               (4, 8, 64, "bf16 serve-like", 2), (4, 2, 64, "reduced", 16),
               (1, 1, 64, "reduced B=1", 16), (3, 2, 700, "ragged S", 4)]


@pytest.mark.parametrize("B,H,S,label,per_sm", PLAN_SHAPES,
                         ids=[p[3] for p in PLAN_SHAPES])
def test_flash_decode_split_plan_fills_whole_waves(B, H, S, label, per_sm):
    """On a card of 132 SMs holding ``per_sm`` split blocks each: the
    splits cover [0, S) exactly, each chunk is a whole number of tiles of
    at least MIN_CHUNK rows (or all of S), and no other splitting takes
    fewer waves x (tiles per chunk + SPLIT_OVERHEAD), i.e. B·H·n_split
    fills whole waves as far as the shapes allow. The plan reads no length: cache_len is not
    among its inputs."""
    slots = 132 * per_sm
    chunk, n_split = decode_ops.split_plan(B, H, S, slots)
    assert chunk % decode_ops.TILE == 0
    assert (n_split - 1) * chunk < S <= n_split * chunk
    assert chunk >= min(decode_ops.MIN_CHUNK, -(-S // decode_ops.TILE)
                        * decode_ops.TILE)

    def cost(c, n):
        return -(-B * H * n // slots) * (c // decode_ops.TILE
                                          + decode_ops.SPLIT_OVERHEAD)
    for n in range(1, -(-S // decode_ops.MIN_CHUNK) + 1):
        c = -(-(-(-S // n)) // decode_ops.TILE) * decode_ops.TILE
        assert cost(chunk, n_split) <= cost(c, -(-S // c))
    waves = -(-B * H * n_split // slots)
    if 1 < n_split < -(-S // decode_ops.MIN_CHUNK):
        # not held back by MIN_CHUNK: the last wave is mostly full
        assert B * H * n_split > (waves - 0.25) * slots
    assert "cache_len" not in decode_ops.split_plan.__wrapped__.__code__.co_varnames


def test_flash_decode_split_plan_of_the_long_shapes():
    """long_500k at two resident blocks per SM: 33 splits of 8 blocks fill
    one wave of 264 exactly; starcoder2-7b's geometry: 8 splits of 512
    rows, 256 blocks in one wave."""
    assert decode_ops.split_plan(1, 8, 524288, 264) == (15936, 33)
    assert decode_ops.split_plan(8, 4, 4096, 264) == (512, 8)
    assert decode_ops.split_plan(128, 3, 32768, 132 * 12) == (8192, 4)


def test_flash_decode_reads_the_residency_once_per_configuration(monkeypatch):
    """device_slots asks the library's residency entry (which launches
    nothing) for (dtype, G, D) and multiplies SM count by resident blocks,
    once per device and configuration; a configuration with no resident
    block raises."""
    seen = []

    def residency(bf16, G, D, out, stream):
        seen.append((bf16, G, D))
        res = (ctypes.c_int * 2).from_address(out)
        res[0], res[1] = (2, 132) if G < 99 else (0, 132)
        return 0

    monkeypatch.setattr(decode_ops, "_slots", {})
    monkeypatch.setattr(K, "kernel", lambda name, device: (
        residency if name == "flash_decode_residency" else None))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    before = K.launch_counts()
    dev = torch.device("cuda", 0)
    assert decode_ops.device_slots(dev, torch.bfloat16, 4, 128) == 264
    assert decode_ops.device_slots(dev, torch.bfloat16, 4, 128) == 264
    assert decode_ops.device_slots(dev, torch.float32, 3, 64) == 264
    assert seen == [(1, 4, 128), (0, 3, 64)]
    assert K.launch_counts() == before
    with pytest.raises(RuntimeError, match="no resident block"):
        decode_ops.device_slots(dev, torch.float32, 99, 64)


@pytest.mark.parametrize("C,k,blocks", [
    (64, 64, 1), (64, 16, 1), (64, 17, 1), (1, 1, 1), (17, 17, 1),
    (17, 4, 1), (300, 8, 1), (1024, 1024, 1), (1025, 8, 2), (1025, 1025, 2),
    (4096, 100, 4), (1_000_000, 8, 977), (1_000_000, 17, 977)])
def test_candidate_scorer_block_plan(C, k, blocks, monkeypatch, fake_card):
    """B5's wrapper launches ceil(C / BLOCK_C) blocks through the C entry
    with (C, D, k, vec) alone: the kernel sizes each block from C and picks
    its selection method by k (``kArgmaxMaxK``, checked against
    ARGMAX_MAX_K below). At C <= BLOCK_C the one block's output is the
    answer, returned unmerged; above, the merge sees every block's k
    candidates."""
    calls, _status = fake_card
    merged = []

    class Merged(Exception):
        pass

    def merge(ranks, vals, idx, kk):
        assert ranks.numel() == idx.numel() == vals.numel()
        merged.append((vals.numel(), kk))
        raise Merged
    monkeypatch.setattr(scorer_ops, "merge_blocks", merge)
    cands = FakeCuda(torch.zeros((min(C, 4096), 8)))
    cands.shape = (C, 8)                 # the rows themselves are never read
    query = FakeCuda(torch.zeros(8))
    if blocks == 1:
        v, i = scorer_ops.candidate_scorer(cands, query, k)
        assert (v.data_ptr(), i.data_ptr()) == calls[0][1][2:4]
        assert v.numel() == i.numel() == k and not merged
    else:
        with pytest.raises(Merged):
            scorer_ops.candidate_scorer(cands, query, k)
        assert merged == [(blocks * k, k)]
    (name, args), = calls
    assert name == "candidate_scorer_f32"
    assert args[4:8] == (C, 8, k, 1)


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
    ("din_attention.cu", din_ops, {"kChunk": "CHUNK", "kMaxH1": "MAX_H1",
                                   "kMaxH2": "MAX_H2",
                                   "kMaxCluster": "MAX_CLUSTER",
                                   "kBulkThreads": "BULK_THREADS",
                                   "kBulkTiles": "BULK_TILES",
                                   "kBulkList": "BULK_LIST",
                                   "kRegSteps": "REG_STEPS",
                                   "kRegUnits": "REG_UNITS",
                                   "kUnitPad": "UNIT_PAD"}),
    ("embedding_bag.cu", bag_ops, {"kMaxGroups": "MAX_GROUPS"}),
    ("rerank_score.cu", rerank_ops, {"kCands": "CANDS", "kMaxH1": "MAX_H1",
                                     "kMaxH2": "MAX_H2"}),
    ("augru.cu", augru_ops, {"kMaxH": "MAX_H"}),
    ("candidate_scorer.cu", scorer_ops, {"kBlockC": "BLOCK_C",
                                         "kArgmaxMaxK": "ARGMAX_MAX_K"}),
    ("flash_decode.cu", decode_ops, {"kTile": "TILE"}),
    ("mla_decode.cu", mla_ops, {"kHeads": "HEADS", "kLat": "LATENT",
                                "kRope": "ROPE", "kTile": "TILE",
                                "kWarps": "WARPS"})])
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


# -------------------------------------------------------------- gradients

_CTYPE = {torch.float32: ctypes.c_float, torch.int64: ctypes.c_int64}


def _at(ptr, shape, dtype=torch.float32):
    """A CPU tensor over host memory at ``ptr``: what a device pointer of
    the fake card below is."""
    n = int(np.prod(shape))
    if n == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer((_CTYPE[dtype] * n).from_address(ptr),
                            dtype=dtype).view(shape)


def _plain_entries():
    """C entries of the training path's kernels that compute the kernel's
    plain version at the addresses they are handed, as the card would
    compute the kernel there."""
    from repro_torch.kernels.augru.ref import augru_ref
    from repro_torch.kernels.din_attention.ref import din_attention_ref
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    def din(hist, mask, tgt, w1, b1, w2, b2, w3, b3, out, B, T, D, H1, H2,
            _steps, _stream):
        args = [_at(hist, (B, T, D)), _at(mask, (B, T)), _at(tgt, (B, D)),
                _at(w1, (4 * D, H1)), _at(b1, (H1,)), _at(w2, (H1, H2)),
                _at(b2, (H2,)), _at(w3, (H2, 1)), _at(b3, (1,))]
        _at(out, (B, D)).copy_(din_attention_ref(*args))
        return 0

    def bag(table, ids, weights, out, V, D, B, K, mean, _stream):
        _at(out, (B, D)).copy_(embedding_bag_ref(
            _at(table, (V, D)), _at(ids, (B, K), torch.int64),
            None if weights is None else _at(weights, (B, K)),
            "mean" if mean else "sum"))
        return 0

    def group(desc, _stream):
        d = bag_ops._Groups.from_address(desc)
        for i in range(d.n):
            g = d.g[i]
            B = (d.g[i + 1].bag0 if i + 1 < d.n else d.total) - g.bag0
            res = embedding_bag_ref(
                _at(g.table, (g.V, d.D)), _at(g.ids, (B, g.K), torch.int64),
                None if not g.weights else _at(g.weights, (B, g.K)),
                "mean" if g.mean else "sum")
            _at(g.out, (B, g.out_stride))[:, g.out_col:g.out_col + d.D] = res
        return 0

    def augru(x, att, w, u, b, _gx, out, B, T, Din, H, _stream):
        _at(out, (B, H)).copy_(augru_ref(
            _at(x, (B, T, Din)), _at(att, (B, T)), _at(w, (Din, 3 * H)),
            _at(u, (H, 3 * H)), _at(b, (3 * H,))))
        return 0
    return {"din_attention_f32": din, "embedding_bag_f32": bag,
            "embedding_bag_group_f32": group, "augru_f32": augru}


def _plain_card(monkeypatch):
    """CPU tensors take the kernels' path (``on_cpu`` says no), and the C
    entries of B2, B3 and B4 compute the plain version in place of the
    launch: what runs on the card, up to the kernels' own arithmetic."""
    entries = _plain_entries()
    monkeypatch.setattr(K, "kernel", lambda name, device: entries[name])
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    for mod in (bag_ops, din_ops, augru_ops):
        monkeypatch.setattr(mod, "on_cpu", lambda *t: False)


def _din_setup():
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.models.recsys import din
    arch = registry.get("din")
    cfg = arch.reduced(arch.config)
    params = din.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    raw = synthetic.recsys_batch(np.random.default_rng(0), cfg, 8)

    def to_torch(tree):
        if isinstance(tree, dict):
            return {k: to_torch(v) for k, v in tree.items()}
        a = np.asarray(tree)
        return torch.as_tensor(a, dtype=torch.int64 if a.dtype.kind in "iu"
                               else torch.float32)
    return cfg, params, to_torch(raw), din


def _grads(loss_fn, params):
    """{path: gradient or None} of every leaf of a tree of dicts and lists
    (None: autograd never reached the leaf)."""
    live = {}

    def leaves(node, path):
        if isinstance(node, dict):
            return {k: leaves(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [leaves(v, f"{path}/{i}") for i, v in enumerate(node)]
        live[path] = node.detach().requires_grad_(True)
        return live[path]
    loss = loss_fn(leaves(params, ""))
    grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    return dict(zip(live, grads))


def test_din_loss_on_the_card_differentiates_every_parameter(monkeypatch):
    """Fault C-3: on the card the kernels' outputs had no ``grad_fn``, so
    ``din.loss_fn`` gave the tables and ``attn_mlp`` no gradient and no
    error. With the plain version in place of each launch, every
    parameter's gradient on the card's path equals the CPU's, and the
    forward launched the grouped embedding_bag and din_attention once
    each (the backward launches nothing)."""
    cfg, params, batch, din = _din_setup()
    want = _grads(lambda p: din.loss_fn(p, batch, cfg), params)
    _plain_card(monkeypatch)
    before = K.launch_counts()
    got = _grads(lambda p: din.loss_fn(p, batch, cfg), params)
    after = K.launch_counts()
    assert {k: after[k] - before[k] for k in after} == dict(
        {k: 0 for k in after}, embedding_bag=1, din_attention=1)
    missing = sorted(k for k, g in got.items() if g is None)
    assert missing == [], f"no gradient on the card's path for {missing}"
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   msg=k)


def _kernel_grad_cases(rng):
    def t(*shape, grad=True):
        x = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
        return x.requires_grad_(grad)

    def ids(V, *shape):
        return torch.as_tensor(rng.integers(-2, V + 2, shape))

    B, T, D, H1, H2 = 3, 5, 4, 8, 6
    din_args = (t(B, T, D), t(B, T, grad=False), t(B, D), t(4 * D, H1), t(H1),
                t(H1, H2), t(H2), t(H2, 1), t(1))
    table, other = t(20, D), t(9, D)
    bag_ids = ids(20, 4, 3)
    bag_w = torch.as_tensor(rng.random((4, 3)) + 0.5,
                            dtype=torch.float32).requires_grad_()
    group = [(table, ids(20, 6, 1), None, "sum"),
             (table, ids(20, 2, 3), None, "sum"),      # one table, two groups
             (other, ids(9, 2, 4),
              torch.as_tensor(rng.random((2, 4)) + 0.5, dtype=torch.float32),
              "mean"),
             (other, ids(9, 2, 2), None, "mean")]
    Din, H = 5, 7
    augru_args = (t(B, T, Din), t(B, T), t(Din, 3 * H), t(H, 3 * H), t(3 * H))
    return {
        "din_attention": (lambda f: f(*din_args), din_args[:1] + din_args[2:],
                          din_ops.din_attention, din_ops.din_attention_ref),
        "embedding_bag": (lambda f: f(table, bag_ids, bag_w, "mean"),
                          (table, bag_w),
                          bag_ops.embedding_bag, bag_ops.embedding_bag_ref),
        "embedding_bag_group": (
            lambda f: torch.cat([o.reshape(-1) for o in f(group, (1, 1, 2))]),
            (table, other, group[2][2]), bag_ops.embedding_bag_group,
            bag_ops.embedding_bag_group_ref),
        "augru": (lambda f: f(*augru_args), augru_args, augru_ops.augru,
                  augru_ops.augru_ref),
    }


@pytest.mark.parametrize("case", ["din_attention", "embedding_bag",
                                  "embedding_bag_group", "augru"])
def test_training_kernels_reach_their_backward(case, monkeypatch, rng):
    """B2, B3 (per table and grouped, a table read by two groups) and B4
    on the card's path: the forward is one counted launch, the output has
    a ``grad_fn``, and the backward gives every input the plain version's
    gradient (weights too where they require it), launching nothing."""
    call, inputs, wrapper, plain = _kernel_grad_cases(rng)[case]
    with_weights = tuple(x for x in inputs if x.requires_grad)
    want_out = call(plain)
    g = torch.as_tensor(rng.normal(size=tuple(want_out.shape)),
                        dtype=torch.float32)
    want = torch.autograd.grad(want_out, with_weights, g, allow_unused=True)
    _plain_card(monkeypatch)
    counter = "embedding_bag" if case.startswith("embedding") else case
    before = K.launch_counts()
    out = call(wrapper)
    assert out.grad_fn is not None
    assert K.launch_counts()[counter] == before[counter] + 1
    torch.testing.assert_close(out, want_out.detach(), rtol=0, atol=0)
    got = torch.autograd.grad(out, with_weights, g, allow_unused=True)
    assert K.launch_counts() == dict(before, **{counter: before[counter] + 1})
    for a, b in zip(got, want):
        assert a is not None
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_training_kernels_launch_bare_without_autograd(monkeypatch, rng):
    """Under ``torch.no_grad()`` (serving) the same inputs launch the
    kernel with no autograd node: the forward path is unchanged."""
    call, _inputs, wrapper, _plain = _kernel_grad_cases(rng)["din_attention"]
    _plain_card(monkeypatch)
    with torch.no_grad():
        out = call(wrapper)
    assert out.grad_fn is None and not out.requires_grad


@pytest.mark.parametrize("kernel", ["rerank_score", "candidate_scorer",
                                    "flash_decode"])
def test_serving_kernels_refuse_to_run_under_autograd(kernel, fake_card,
                                                      monkeypatch, rng):
    """B1, B5 and B6 have no backward: on the card's path, with grad mode
    on and an input that requires grad, they raise a RuntimeError naming
    the kernel before any launch; under ``torch.no_grad()`` they launch."""
    calls, _status = fake_card
    for mod in (rerank_ops, scorer_ops, decode_ops):
        monkeypatch.setattr(mod, "on_cpu", lambda *t: False)

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)

    def tower(*dims):
        return [{"w": t(a, b), "b": t(b)} for a, b in zip(dims[:-1], dims[1:])]
    D, T, C = 4, 6, 5
    w1 = t(4 * D, 8).requires_grad_()
    run = {
        "rerank_score": lambda: rerank_ops.rerank_score(
            t(T, D), t(T), t(C, D), t(3), t(C, 2),
            [{"w": w1, "b": t(8)}] + tower(8, 6, 1), tower(2 * D + 5, 7, 6, 1)),
        "candidate_scorer": lambda: scorer_ops.candidate_scorer(
            t(C, 8).requires_grad_(), t(8), k=3),
        "flash_decode": lambda: decode_ops.flash_decode(
            t(2, 2, 3, 16).requires_grad_(), t(2, 40, 2, 16), t(2, 40, 2, 16),
            torch.tensor(30, dtype=torch.int32)),
    }[kernel]
    before = K.launch_counts()
    with pytest.raises(RuntimeError, match=kernel + ".*no backward"):
        run()
    assert calls == [] and K.launch_counts() == before
    with torch.no_grad():
        run()
    assert len(calls) == 1 and K.launch_counts()[kernel] == before[kernel] + 1


def _meta(*shape, dtype=torch.float32):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
        shape = tuple(shape[0])
    return FakeCuda(torch.empty(shape, dtype=dtype, device="meta"))


def test_din_attention_and_augru_take_the_training_batch(fake_card,
                                                         monkeypatch):
    """The published recsys training batch, B = 65,536 (T = 100): B2 and
    B4 hand it to their C entries (their grids no longer put B or B·T
    tiles on the 65,535-block y extent; the sources below)."""
    calls, _status = fake_card
    real_empty = torch.empty

    def empty(*shape, dtype=None, device=None, **kw):
        if device is not None and torch.device(device).type == "cuda":
            return _meta(*shape, dtype=dtype)
        return real_empty(*shape, dtype=dtype, device=device, **kw)
    monkeypatch.setattr(torch, "empty", empty)
    B, T, D, H1, H2 = 65536, 100, 18, 80, 40
    out = din_ops.din_attention(_meta(B, T, D), _meta(B, T), _meta(B, D),
                                _meta(4 * D, H1), _meta(H1), _meta(H1, H2),
                                _meta(H2), _meta(H2, 1), _meta(1))
    assert tuple(out.shape) == (B, D)
    assert calls[-1][0] == "din_attention_f32"
    assert calls[-1][1][10:15] == (B, T, D, H1, H2)
    Din = H = 108
    out = augru_ops.augru(_meta(B, T, Din), _meta(B, T), _meta(Din, 3 * H),
                          _meta(H, 3 * H), _meta(3 * H))
    assert tuple(out.shape) == (B, H)
    assert calls[-1][0] == "augru_f32" and calls[-1][1][7:11] == (B, T, Din, H)


def test_training_path_grids_keep_the_batch_off_the_y_extent():
    """B2's clusters and B4's projection tiles ride one x extent (up to
    2^31 - 1 blocks): no ``blockIdx.y`` and no 2-D grid in either source."""
    for source in ("din_attention.cu", "augru.cu"):
        text = re.sub(r"//[^\n]*", "", (K.CSRC / source).read_text())
        assert "blockIdx.y" not in text, source
        assert not re.search(r"dim3\s*\w*\s*\([^)]*,", text), source


# ------------------------------------------------------------------- mesh

def test_mesh_paths_run_with_jax_and_reference_blocked():
    """A fresh interpreter in which ``import jax`` and ``import repro``
    fail imports ``runtime``, ``launch.mesh``, ``launch.sharding`` and the
    mesh paths and runs a sharded bag on two gloo ranks; the ranks the
    launcher spawns import neither ``jax`` nor ``repro``."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        from repro_torch import runtime
        from repro_torch.launch import dryrun, mesh, sharding, specs
        from repro_torch.models.recsys import din, dien, mind, towers
        from repro_torch.sparse import sharded
        from repro_torch.launch.mesh import Job, run_jobs, run_ranks
        from repro_torch.launch.sharding import P, Table
        table = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)
        ids = np.array([[0, 31], [8, 17]])
        job = Job("repro_torch.sparse.sharded:sharded_embedding_bag_2d",
                  table, Table(("data", "model"), None), (ids,),
                  (P("data", None),), out_specs=P("data", None))
        ranks = run_jobs([job], (2, 1), timeout=120)
        assert all(np.array_equal(r[0]["out"], table[ids].sum(1))
                   for r in ranks), ranks
        mods = run_ranks(eval, 2, ("sorted(m for m in __import__('sys')"
                                   ".modules if m.split('.')[0] in "
                                   "('jax', 'jaxlib', 'repro'))",),
                         timeout=120)
        assert mods == [[], []], mods
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro")
                        and sys.modules[m] is not None)
        assert not loaded, loaded
        print("MESH-ISOLATED")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=170)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "MESH-ISOLATED" in out.stdout


def test_lm_mesh_paths_run_with_jax_and_reference_blocked():
    """A fresh interpreter in which ``import jax`` and ``import repro``
    fail imports the LM's mesh paths (``models.moe``, ``models.attention``,
    ``models.transformer``) and runs an LM cell on two gloo ranks (reduced
    smollm-135m x long_500k: B6 with its lse on each rank's half of the
    sequence); after the cell the ranks have imported neither ``jax`` nor
    ``repro``."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.models.attention
        import repro_torch.models.moe
        import repro_torch.models.transformer
        from repro_torch.launch.mesh import CellDraw, Job, run_jobs
        if __name__ == "__main__":
            cell = Job(params=CellDraw("smollm-135m", "long_500k",
                                       reduced=True))
            ranks = run_jobs([cell, Job("repro_torch.launch.mesh:imported")],
                             (1, 2), timeout=150)
            for rank in ranks:
                logits, = rank[0]["out"]
                assert logits.shape == (1, 512), logits.shape
                assert rank[1]["out"] == [], rank[1]["out"]
            loaded = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro")
                            and sys.modules[m] is not None)
            assert not loaded, loaded
            print("LM-MESH-ISOLATED")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=170)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LM-MESH-ISOLATED" in out.stdout


def test_mesh_training_runs_with_jax_and_reference_blocked():
    """A fresh interpreter in which ``import jax`` and ``import repro``
    fail imports the modules of training on a mesh (the differentiable
    collectives, the ZeRO-2 train step, the optimizers on shards,
    checkpoints on a mesh, the launcher, the recsys losses, SchNet's edge
    split) and runs a training cell on two gloo ranks (reduced schnet x
    molecule, its edges split over ``model``); after the steps the ranks
    have imported neither ``jax`` nor ``repro``."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.launch.train
        import repro_torch.models.recsys.common
        import repro_torch.models.schnet
        import repro_torch.runtime
        import repro_torch.train.checkpoint
        import repro_torch.train.optimizer
        import repro_torch.train.train_step
        import repro_torch.tree
        from repro_torch.launch.mesh import CellDraw, Job, run_jobs
        if __name__ == "__main__":
            cell = Job(params=CellDraw("schnet", "molecule", reduced=True),
                       repeat=1)
            ranks = run_jobs([cell, Job("repro_torch.launch.mesh:imported")],
                             (1, 2), timeout=150)
            for rank in ranks:
                loss, = rank[0]["out"]
                assert loss.shape == () and loss == loss, loss
                assert any(k.endswith("/bwd") for k, _ in
                           rank[0]["collectives"]), rank[0]["collectives"]
                assert rank[1]["out"] == [], rank[1]["out"]
            loaded = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro")
                            and sys.modules[m] is not None)
            assert not loaded, loaded
            print("TRAIN-MESH-ISOLATED")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=170)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "TRAIN-MESH-ISOLATED" in out.stdout


def test_build_takes_turns_across_processes(tmp_path):
    """Two processes that build the kernel library at once (the ranks of
    a mesh on one card) take turns on the build directory's file lock:
    one compiles (each source, then the link), the other finds its
    library; the two never compile at once. The compile is a stub that
    takes a second."""
    script = textwrap.dedent("""
        import os, sys, time, types
        from pathlib import Path
        import repro_torch.kernels as K
        root, log = Path(sys.argv[1]), Path(sys.argv[2])
        K.BUILD_ROOT = root
        K._nvcc = lambda: "nvcc"

        def run(cmd, **kw):
            with open(log, "a") as f:
                f.write(f"start {os.getpid()} {time.time()}\\n")
            time.sleep(1.0)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"library")
            with open(log, "a") as f:
                f.write(f"end {os.getpid()} {time.time()}\\n")
            return types.SimpleNamespace(returncode=0, stdout="")
        K.subprocess = types.SimpleNamespace(run=run, PIPE=None, STDOUT=None)
        print(K.build())
    """)
    log = tmp_path / "compiles.log"
    procs = [subprocess.Popen([sys.executable, "-c", script,
                               str(tmp_path / "build"), str(log)], cwd=ROOT,
                              env=dict(os.environ, PYTHONPATH=str(SRC)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1 and Path(paths.pop()).read_bytes() == b"library"
    events = [line.split() for line in log.read_text().splitlines()]
    # one process ran every compile (a source each, then the link)
    n_runs = len(K.sources()) + 1
    assert len({e[1] for e in events}) == 1, events
    assert sorted(e[0] for e in events) == ["end"] * n_runs + \
        ["start"] * n_runs, events
