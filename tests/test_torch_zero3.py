"""ZeRO-3 (deepseek-v3's ``fsdp_params``) and the model-split residual
(``shard_carry``) in training on a device mesh, on the CPU: gloo ranks
through ``launch.mesh.run_jobs``, one launch a mesh, the reduced
deepseek-v3 with ``remat=True`` and ``zero_specs`` at ``ZERO_MIN``
elements so that the reduced leaves do shard. At (2, 2) and (2, 4):

  (a) the ZeRO-3 + split-carry step (parameters by
      ``zero_specs(..., gathered=True)``, each ZeRO-3 leaf a
      ``runtime.DataShard`` gathered on use) against the same mesh's
      ZeRO-2 whole-carry step: loss at ``TOL_OPT``, gradients gathered
      and updated parameters at ``TOL_LM``, leaf-scaled;
  (b) the same against the reference's jitted step with
      ``in_shardings`` = its ``zero_specs`` and ``shard_carry`` as
      published (the fsdp cell of ``repro/launch/specs.py:108-126``), in
      a subprocess with 8 forced host devices;
  (c) every rank's ZeRO-3 blocks of the shape
      ``NamedSharding(mesh, zspec).shard_shape(leaf.shape)`` gives;
  (d) the collectives by kind: per layer and per ZeRO-3 leaf one
      all_gather over ``data`` forward, one ``/recompute`` (the remat
      layers' recompute, or the backward gathering a saved weight again)
      and one ``reduce_scatter/bwd``; no all_gather after the
      backward; the carry's reduce_scatter / all_gather / all_to_all over
      ``model`` in place of the row-parallel all_reduce;
  (e) the tensors ``checkpoint`` saves between layers: (B_local, S,
      d / model);
  (f) a checkpoint saved at (2, 2) in the ZeRO-3 layout, restored bit for
      bit on one device and at (2, 4);
  (g) planted faults: a copy that skips the head's gather (each rank
      uses its block, zeros elsewhere), one that all-reduces the ZeRO-3
      gradients over ``data`` a second time, and one that leaves every
      ZeRO-3 leaf as it was instead of updating it, all fail (a).

(a) and (b) hold the update itself too (``_update_close``): AdamW's
first step moves each element by about lr, less than TOL_LM, so a hold
of the parameters alone passes a step left out. (a) also runs at (2, 2)
with two micro-batches, the ZeRO-3 leaves' gradients accumulated in
their blocks.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import transformer as jax_tf
from repro_torch import tree as tree_lib
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.launch import sharding
from repro_torch.launch.mesh import Job, abstract_mesh, run_jobs
from repro_torch.launch.sharding import P
from repro_torch.train import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("data", "model")
MESHES = {"2x2": (2, 2), "2x4": (2, 4)}
ARCH = "deepseek-v3-671b"
TOL_OPT = dict(rtol=1e-6, atol=1e-6)          # tests/test_torch_train.py
TOL_LM = dict(rtol=2e-3, atol=2e-3)
#: zero_specs' minimum leaf size: the reduced leaves are far below 2^20
ZERO_MIN = 64
LR = 1e-3
B, S = 8, 16
FAULTS = ("skip_gather", "double_reduce", "no_update")
N_MICRO = 2


def _cfg(reg, carry=True):
    arch = reg.get(ARCH)
    cfg = dataclasses.replace(arch.reduced(arch.config), remat=True)
    assert cfg.shard_carry and cfg.fsdp_params
    return cfg if carry else dataclasses.replace(cfg, shard_carry=False)


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's ``init`` of the reduced deepseek-v3, as numpy."""
    return jax.tree.map(np.asarray, jax_tf.init(jax.random.PRNGKey(0),
                                                _cfg(jax_registry)))


def _tokens():
    return np.random.default_rng(24).integers(0, _cfg(registry).vocab, (B, S))


def _specs(shape):
    """(TP specs, ZeRO-2 specs, ZeRO-3 specs) of the port on ``shape``."""
    port = params_from_numpy(_weights(), "cpu")
    mesh = abstract_mesh(shape, AXES)
    pspecs = sharding.lm_param_specs(port, _cfg(registry), mesh)
    return (pspecs,
            sharding.zero_specs(port, pspecs, mesh, min_size=ZERO_MIN),
            sharding.zero_specs(port, pspecs, mesh, min_size=ZERO_MIN,
                                gathered=True))


# --------------------------------------------------------------- helpers

#: rank-side functions (the ranks import this module from the test's
#: temporary directory on sys.path; it imports nothing of jax)
HELPER = '''
import contextlib

import torch
import torch.nn.functional as F

from repro_torch import runtime
from repro_torch import tree as tree_lib
from repro_torch.launch import sharding
from repro_torch.models import transformer
from repro_torch.train import checkpoint, optimizer, train_step


@contextlib.contextmanager
def watched(log, shapes):
    """Every counted collective logged as (kind with its phase, axes,
    True inside a ZeRO-3 leaf's gather), and the shape of each tensor a
    remat checkpoint takes as a layer's input."""
    collective, gather = runtime._collective, runtime.DataShard.gather
    ckpt = transformer.checkpoint
    inside = []

    def logged(kind, x, axes, op, mesh=None, backward=False):
        out = collective(kind, x, axes, op, mesh, backward)
        m = mesh or runtime.current_mesh()
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in m.axis_names if a in names)
        if any(m.shape[a] > 1 for a in axes):
            log.append((runtime._phase_kind(kind, backward), axes,
                        bool(inside)))
        return out

    def tagged(self):
        inside.append(1)
        try:
            return gather(self)
        finally:
            inside.pop()

    def saved(fn, p, x, **kw):
        shapes.append(tuple(x.shape))
        return ckpt(fn, p, x, **kw)
    runtime._collective, runtime.DataShard.gather = logged, tagged
    transformer.checkpoint = saved
    try:
        yield
    finally:
        runtime._collective, runtime.DataShard.gather = collective, gather
        transformer.checkpoint = ckpt


@contextlib.contextmanager
def planted(fault, skip_shape, pspecs):
    """``skip_gather``: the gather of a leaf whose block has
    ``skip_shape`` skipped (the rank's block, zeros elsewhere);
    ``double_reduce``: the ZeRO-3 gradients summed over ``data`` once
    more by the step; ``no_update``: AdamW's update leaves every ZeRO-3
    leaf (spec ``Gathered`` in ``pspecs``) as it was."""
    gather, plan = runtime.DataShard.gather, train_step._LeafPlan.__init__
    adamw = optimizer.adamw

    def skipped(self):
        if tuple(self.local.shape) != tuple(skip_shape):
            return gather(self)
        n = self.local.shape[self.dim]
        start = runtime.shard_index("data") * n
        whole = n * runtime.axes_size("data")
        pad = [0, 0] * (self.local.dim() - self.dim - 1) + [
            start, whole - start - n]
        return F.pad(self.local, pad)

    def twice(self, pspec, zspec, batch_axes):
        plan(self, pspec, zspec, batch_axes)
        if isinstance(pspec, sharding.Gathered):
            self.sum_axes = self.sum_axes + ("data",)

    def frozen(**kw):
        init, update = adamw(**kw)

        def kept(grads, state, params, specs=None):
            new, state = update(grads, state, params, specs=specs)
            return tree_lib.tree_map(
                lambda n, o, s: o if isinstance(s, sharding.Gathered) else n,
                new, params, pspecs), state
        return init, kept
    if fault == "skip_gather":
        runtime.DataShard.gather = skipped
    elif fault == "double_reduce":
        train_step._LeafPlan.__init__ = twice
    elif fault == "no_update":
        optimizer.adamw = frozen
    try:
        yield
    finally:
        runtime.DataShard.gather, train_step._LeafPlan.__init__ = gather, plan
        optimizer.adamw = adamw


def step(params, tokens, cfg, pspecs, zspecs, lr, fault=None,
         skip_shape=(), save_to=None, n_micro=1):
    """The loss and gradient (summed by the step's rule, gathered whole),
    then one AdamW step: {"loss", "grads", "params" (gathered), "fwd"
    (the collectives of the loss and gradient), "post" (those of the
    step beyond them), "saved" (the remat inputs' shapes), "blocks"
    (each leaf's rank-local shape)}. Over ``n_micro`` > 1 micro-batches
    only the step runs: "loss" is its loss, "grads" None. ``save_to``:
    the updated params checkpointed there (gathered by their specs)."""
    mesh = runtime.current_mesh()

    def loss_fn(p, t):
        return transformer.lm_loss(p, t, cfg)
    fwd, every, saved = [], [], []
    grads = None
    with planted(fault, skip_shape, pspecs):
        if n_micro == 1:
            with watched(fwd, saved):
                loss, g = train_step.value_and_grad(loss_fn, params, tokens)
            grads = sharding.gather_tree(
                train_step.reduce_grads(g, params, pspecs), pspecs, mesh)
        run, init = train_step.build_train_step(
            loss_fn, optimizer.adamw(lr=lr), grad_shardings=zspecs,
            param_specs=pspecs, n_micro=n_micro)
        state = init(params)
        with watched(every, []):
            new, _, step_loss = run(params, state, tokens)
    if n_micro > 1:
        loss = step_loss
    if save_to:
        checkpoint.AsyncCheckpointer(save_to).save(new, 1, block=True,
                                                   specs=pspecs)
    blocks = [[tree_lib.path_name(p), list(t.shape),
               isinstance(s, runtime.DataShard)]
              for (p, t), s in zip(tree_lib.flatten_with_paths(params),
                                   _nodes(params))]
    return {"loss": float(loss), "grads": grads, "fwd": fwd,
            "post": every[len(fwd):], "saved": saved, "blocks": blocks,
            "params": sharding.gather_tree(new, pspecs, mesh)}


def _nodes(tree):
    """Each leaf's innermost node: its DataShard, else the leaf."""
    if isinstance(tree, runtime.DataShard):
        return [tree]
    if isinstance(tree, runtime.RowShard):
        return _nodes(tree.local)
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _nodes(tree[k])]
    return [tree]


def restore(params, pspecs, restore_from):
    """The newest generation under ``restore_from`` restored into this
    rank's ZeRO-3 layout: gathered whole, and whether every ZeRO-3 leaf
    came back a DataShard of its block's shape."""
    mesh = runtime.current_mesh()
    ck = checkpoint.AsyncCheckpointer(restore_from)
    got, _ = checkpoint.restore(ck.latest(), params, pspecs)
    same = [(type(a) is type(b) and tuple(a.local.shape) ==
             tuple(b.local.shape)) for a, b in zip(_nodes(got), _nodes(params))
            if isinstance(b, runtime.DataShard)]
    return {"layout": bool(same) and all(same),
            "params": sharding.gather_tree(got, pspecs, mesh)}
'''


def _step_job(shape, zero3, fault=None, save_to=None, n_micro=1):
    pspecs, zspecs, z3specs = _specs(shape)
    specs = z3specs if zero3 else pspecs
    head = tuple(np.shape(_weights()["lm_head"]["w"]))
    mesh = abstract_mesh(shape, AXES)
    skip = tuple(sharding.local_part(torch.empty(head, device="meta"),
                                     z3specs["lm_head"]["w"], mesh).shape)
    return Job("zero3_helper:step", _weights(), specs, (_tokens(),),
               (P("data", None),),
               {"cfg": _cfg(registry, carry=zero3), "pspecs": specs,
                "zspecs": zspecs, "lr": LR, "fault": fault,
                "skip_shape": skip, "save_to": save_to, "n_micro": n_micro})


# ------------------------------------------------------------ reference

REF_SCRIPT = """
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro import runtime
    from repro.configs import registry
    from repro.launch import sharding as shr
    from repro.launch.mesh import make_mesh
    from repro.models import transformer as tf
    from repro.train import optimizer as opt_lib
    from repro.train.train_step import build_train_step
    toks = jnp.asarray(np.load(sys.argv[1]), jnp.int32)
    a = registry.get("deepseek-v3-671b")
    cfg = dataclasses.replace(a.reduced(a.config), remat=True)
    assert cfg.shard_carry and cfg.fsdp_params
    params = tf.init(jax.random.PRNGKey(0), cfg)
    out = {}
    for name in ("2x2", "2x4"):
        mesh = make_mesh(tuple(int(x) for x in name.split("x")),
                         ("data", "model"))
        with runtime.use_mesh(mesh):
            ps = shr.param_specs(params, cfg, mesh)
            zs = shr.zero_specs(params, ps, mesh, min_size=int(sys.argv[3]))
            loss_fn = lambda p, t: tf.lm_loss(p, t, cfg)
            step, init = build_train_step(
                loss_fn, opt_lib.adamw(lr=float(sys.argv[4])),
                grad_shardings=shr.to_named(mesh, zs))

            def both(p, t):
                l, g = jax.value_and_grad(loss_fn)(p, t)
                new_p, _, _ = step(p, init(p), t)
                return l, g, new_p
            # the fsdp cell: the parameters themselves by the ZeRO specs
            f = jax.jit(both, in_shardings=(
                shr.to_named(mesh, zs),
                shr.to_named(mesh, shr.batched_spec(mesh, toks.shape))))
            l, g, new_p = f(params, toks)
        out[name + "/loss"] = np.asarray(l)
        for i, leaf in enumerate(jax.tree.leaves(g)):
            out[f"{name}/grad/{i}"] = np.asarray(leaf)
        for i, leaf in enumerate(jax.tree.leaves(new_p)):
            out[f"{name}/param/{i}"] = np.asarray(leaf)
        specs = jax.tree.leaves(zs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        for i, (leaf, spec) in enumerate(zip(jax.tree.leaves(params), specs)):
            out[f"{name}/shard/{i}"] = np.asarray(
                NamedSharding(mesh, spec).shard_shape(leaf.shape))
    np.savez(sys.argv[2], **out)
    print("REF-ZERO3-OK")
"""


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    """The reference's fsdp steps, started first in a subprocess of their
    own (they run while the ranks do)."""
    tmp = tmp_path_factory.mktemp("ref_zero3")
    np.save(tmp / "toks.npy", _tokens())
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_SCRIPT),
         str(tmp / "toks.npy"), str(tmp / "out.npz"), str(ZERO_MIN), str(LR)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def ref(ref_proc, runs):
    proc, tmp = ref_proc
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0 and "REF-ZERO3-OK" in out, \
        out[-2000:] + err[-3000:]
    return dict(np.load(tmp / "out.npz"))


# ------------------------------------------------------------ the ranks

@pytest.fixture(scope="module")
def runs(ref_proc, tmp_path_factory):
    """One launch a mesh: (2, 2) the ZeRO-2 and ZeRO-3 steps (the ZeRO-3
    one saving its checkpoint), the planted faults and both steps over
    N_MICRO micro-batches; (2, 4) the two steps and the restore of the
    (2, 2) checkpoint."""
    helper = tmp_path_factory.mktemp("helper")
    (helper / "zero3_helper.py").write_text(HELPER)
    ck = str(tmp_path_factory.mktemp("ckpt"))
    out = {"ckpt": ck}
    sys.path.insert(0, str(helper))
    try:
        for name, shape in MESHES.items():
            jobs = {"zero2": _step_job(shape, False),
                    "zero3": _step_job(shape, True,
                                       save_to=ck if name == "2x2" else None)}
            if name == "2x2":
                for fault in FAULTS:
                    jobs[fault] = _step_job(shape, True, fault=fault)
                jobs["zero2_micro"] = _step_job(shape, False, n_micro=N_MICRO)
                jobs["zero3_micro"] = _step_job(shape, True, n_micro=N_MICRO)
            else:
                z3 = _specs(shape)[2]
                jobs["restore"] = Job("zero3_helper:restore", _weights(), z3,
                                      (), (), {"pspecs": z3,
                                               "restore_from": ck})
            ranks = run_jobs(list(jobs.values()), shape, AXES, timeout=400)
            out[name] = {k: [r[i]["out"] for r in ranks]
                         for i, k in enumerate(jobs)}
    finally:
        sys.path.remove(str(helper))
    return out


# ---------------------------------------------------------------- checks

def _leaves(tree) -> list:
    leaves = tree if isinstance(tree, list) else tree_lib.leaves(tree)
    return [np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                       else x) for x in leaves]


def _worst(got, want) -> float:
    """The largest leaf-scaled difference: |got - want| / max(1,
    max|want|) over every leaf."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    worst = 0.0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = max(1.0, float(np.abs(b).max(initial=0)))
        worst = max(worst, float(np.abs(a - b).max(initial=0)) / scale)
    return worst


def _held(got, want, tol, label):
    """Two trees (or lists of leaves) leaf by leaf at ``tol``,
    leaf-scaled (atol x max(1, max|want|)); the worst difference
    printed."""
    worst = _worst(got, want)
    print(f"{label}: largest leaf-scaled difference {worst:.3e}")
    for i, (a, b) in enumerate(zip(_leaves(got), _leaves(want))):
        scale = max(1.0, float(np.abs(b).max(initial=0)))
        np.testing.assert_allclose(a, b, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale,
                                   err_msg=f"{label} leaf {i}")


def _update_close(got, want, grads, label, frac=1e-2):
    """The update ``got - old`` against ``want - old`` (``old`` the drawn
    parameters), leaf by leaf, on the elements whose gradient
    (``grads``) is at least 1e-3 of the leaf's largest: within ``frac``
    of the leaf's largest update there (the rule of
    ``tests/test_torch_mesh_train.py``). AdamW's first step moves each
    such element by about lr whatever its gradient's size, so a step
    skipped, or applied on one data block of a leaf, fails here, where a
    hold of the parameters at TOL_LM (twice lr) passes."""
    old = _leaves(params_from_numpy(_weights(), "cpu"))
    got, want, grads = _leaves(got), _leaves(want), _leaves(grads)
    assert len(got) == len(old) == len(want) == len(grads)
    held = 0
    for i, (a, o, b, g) in enumerate(zip(got, old, want, grads)):
        if not np.abs(g).max(initial=0) > 0:
            continue
        big = np.abs(g) >= 1e-3 * np.abs(g).max()
        du, dw = (a - o)[big], (b - o)[big]
        room = frac * float(np.abs(dw).max())
        assert room > 0, f"{label} leaf {i}: the reference did not move"
        np.testing.assert_allclose(du, dw, rtol=0, atol=room,
                                   err_msg=f"{label} leaf {i} update")
        held += 1
    assert held, label


def _step_held(got, want, label):
    """(a)'s hold of one ZeRO-3 rank's step against a ZeRO-2 rank's: the
    loss, the gradients, the updated parameters and the update."""
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL_OPT)
    _held(got["grads"], want["grads"], TOL_LM, label + " grads")
    _held(got["params"], want["params"], TOL_LM, label + " params")
    _update_close(got["params"], want["params"], want["grads"], label)


def _ref_leaves(ref, key, what):
    n = sum(1 for k in ref if k.startswith(f"{key}/{what}/"))
    return [ref[f"{key}/{what}/{i}"] for i in range(n)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_zero3_split_carry_step_equals_zero2_whole_carry(mesh, runs):
    """(a) Each rank's ZeRO-3 + split-carry step against the same rank's
    ZeRO-2 whole-carry step: the loss, every gradient leaf (summed by the
    rule, gathered whole), every updated parameter and its update."""
    for got, want in zip(runs[mesh]["zero3"], runs[mesh]["zero2"]):
        _step_held(got, want, f"{mesh} ZeRO-3 vs ZeRO-2")


def test_zero3_micro_batch_step_equals_zero2_micro_batch_step(runs):
    """(a) at (2, 2) over N_MICRO micro-batches: each ZeRO-3 leaf's
    gradient accumulates in its block (the gather's backward
    reduce-scatters each micro-batch's), the step's loss, the updated
    parameters and the update (on the elements the whole batch's
    gradient moves) against the ZeRO-2 step over the same micro-batches."""
    label = f"2x2 {N_MICRO} micro-batches ZeRO-3 vs ZeRO-2"
    for got, want, whole in zip(runs["2x2"]["zero3_micro"],
                                runs["2x2"]["zero2_micro"],
                                runs["2x2"]["zero2"]):
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL_OPT)
        _held(got["params"], want["params"], TOL_LM, label + " params")
        _update_close(got["params"], want["params"], whole["grads"], label)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_zero3_step_equals_reference_fsdp_step(mesh, runs, ref):
    """(b) Each rank's ZeRO-3 step against the reference's jitted step
    whose parameters are in_shardings by its zero_specs, shard_carry as
    published."""
    for rank in runs[mesh]["zero3"]:
        np.testing.assert_allclose(rank["loss"], ref[mesh + "/loss"],
                                   **TOL_LM)
        _held(rank["grads"], _ref_leaves(ref, mesh, "grad"), TOL_LM,
              f"{mesh} grads vs the reference")
        _held(rank["params"], _ref_leaves(ref, mesh, "param"), TOL_LM,
              f"{mesh} params vs the reference")
        _update_close(rank["params"], _ref_leaves(ref, mesh, "param"),
                      _ref_leaves(ref, mesh, "grad"),
                      f"{mesh} update vs the reference")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_zero3_blocks_have_the_reference_shard_shapes(mesh, runs, ref):
    """(c) Every rank's leaf of the ZeRO-3 layout has the shape
    ``NamedSharding(mesh, zspec).shard_shape`` gives in the reference, and
    the leaves whose spec is ``Gathered`` are DataShards: a layer's
    router, the head and the embedding among them."""
    want = _ref_leaves(ref, mesh, "shard")
    gathered = []
    tree_lib.tree_map(
        lambda _leaf, spec: gathered.append(isinstance(spec,
                                                       sharding.Gathered)),
        params_from_numpy(_weights(), "cpu"), _specs(MESHES[mesh])[2])
    for rank in runs[mesh]["zero3"]:
        blocks = rank["blocks"]
        assert [list(s) for _, s, _ in blocks] == [list(w) for w in want]
        assert [z for *_, z in blocks] == gathered
        z3 = {name for name, _, is_z3 in blocks if is_z3}
        assert {"embed/table", "lm_head/w", "layers/moe/router"} <= z3


def _count(log, kind, axes, z3=None):
    return sum(1 for k, a, tag in log if k == kind and tuple(a) == axes
               and (z3 is None or tag == z3))


def _z3_leaves(blocks, prefix):
    return sum(1 for name, _, z in blocks if z and name.startswith(prefix))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_zero3_and_carry_collectives_by_kind(mesh, runs):
    """(d) The loss and gradient's collectives: each ZeRO-3 leaf gathered
    over ``data`` once forward and once more in the backward (the remat
    layers' in their recompute, the others' where the backward first
    needs a weight autograd saved: ``runtime.regathered``), and one
    reduce_scatter/bwd over ``data`` per forward gather (the ZeRO-2
    step's count plus the gathers); after the backward no
    all_gather at all (ZeRO-2: one per ZeRO shard, and its
    reduce_scatter). The split carry: per block two all_reduces over
    ``model`` fewer, two reduce_scatters over ``model`` (attention's and
    the FFN's or the shared expert's), an all_to_all per MoE block in
    place of its rows' all_gather, and the residual gathered over
    ``model`` twice a block (none at a block whose input comes whole:
    the first and the MTP's) and once before each head."""
    cfg = _cfg(registry)
    n_dense = cfg.moe.n_dense_layers
    n_moe = cfg.n_layers - n_dense
    n_blocks = cfg.n_layers + 1                       # + the MTP block
    for z3, z2 in zip(runs[mesh]["zero3"], runs[mesh]["zero2"]):
        blocks = z3["blocks"]
        per_layer = _z3_leaves(blocks, "layers/")
        uses = (sum(1 for *_, z in blocks if z) + per_layer * (n_moe - 1)
                + _z3_leaves(blocks, "dense_layers/") * (n_dense - 1))
        fwd, post = z3["fwd"], z3["post"]
        data, model = ("data",), ("model",)
        assert per_layer > 0
        assert _count(fwd, "all_gather", data, True) == uses
        # again in the backward: a remat layer's leaves in its recompute,
        # every other leaf autograd saved when it first needs it; all but
        # the embedding, whose lookup saves no weight
        assert _count(fwd, "all_gather/recompute", data, True) == uses - 1
        assert _count(fwd, "reduce_scatter/bwd", data) == \
            _count(z2["fwd"], "reduce_scatter/bwd", data) + uses
        assert _count(z2["fwd"], "all_gather", data, True) == 0
        assert not [c for c in post if c[0].startswith("all_gather")]
        assert not [c for c in post if c[0] == "reduce_scatter"]
        n_zero2 = sum(1 for *_, z in blocks if z)
        assert _count(z2["post"], "all_gather", data) == n_zero2
        assert _count(z2["post"], "reduce_scatter", data) == n_zero2
        # the carry
        assert _count(z2["fwd"], "all_reduce", model) \
            - _count(fwd, "all_reduce", model) == 2 * n_blocks
        assert _count(fwd, "reduce_scatter", model) == 2 * n_blocks
        assert _count(z2["fwd"], "reduce_scatter", model) == 0
        assert _count(fwd, "all_to_all", model) == n_moe + 1
        assert _count(z2["fwd"], "all_to_all", model) == 0
        assert _count(z2["fwd"], "all_gather", model) == n_moe + 1
        assert _count(fwd, "all_gather", model) == 2 * n_blocks


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_remat_saves_the_rank_s_block_of_d_model(mesh, runs):
    """(e) The tensor each remat checkpoint takes as its layer's input:
    (B_local, S, d / model) with the split carry, (B_local, S, d) whole."""
    cfg = _cfg(registry)
    nd, nm = MESHES[mesh]
    n_moe = cfg.n_layers - cfg.moe.n_dense_layers
    for z3, z2 in zip(runs[mesh]["zero3"], runs[mesh]["zero2"]):
        assert z3["saved"] == [(B // nd, S, cfg.d_model // nm)] * n_moe
        assert z2["saved"] == [(B // nd, S, cfg.d_model)] * n_moe


def test_zero3_checkpoint_restores_bit_for_bit_on_one_device_and_2x4(runs):
    """(f) The (2, 2) ZeRO-3 ranks' updated parameters, saved gathered by
    their specs: restored on one device, and at (2, 4) into its ZeRO-3
    layout (each leaf its DataShard of the (2, 4) block), bit for bit."""
    want = _leaves(runs["2x2"]["zero3"][0]["params"])
    ck = checkpoint.AsyncCheckpointer(runs["ckpt"])
    got, step = checkpoint.restore(ck.latest(),
                                   params_from_numpy(_weights(), "cpu"))
    assert step == 1
    for a, b in zip(_leaves(got), want):
        np.testing.assert_array_equal(a, b)
    for rank in runs["2x4"]["restore"]:
        assert rank["layout"]
        for a, b in zip(_leaves(rank["params"]), want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails_the_zero2_hold(fault, runs):
    """(g) A copy that skips the head's gather, that sums the ZeRO-3
    gradients over ``data`` once more, or that leaves the ZeRO-3 leaves
    un-updated, fails (a)'s hold on every rank."""
    failed = 0
    for got, want in zip(runs["2x2"][fault], runs["2x2"]["zero2"]):
        try:
            _step_held(got, want, f"planted {fault}")
        except AssertionError:
            failed += 1
    assert failed == len(runs["2x2"]["zero2"])
