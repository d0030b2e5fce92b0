"""Training on a device mesh against one device and against the reference,
on the CPU (gloo ranks through ``launch.mesh.run_jobs``; one launch per
mesh serves every rank-side case):

  * each differentiable collective of ``runtime`` (all_gather, its
    partial form, reduce_scatter, all_reduce, all_to_all and ``enter``)
    over ("data",), ("model",) and both axes of (2, 2) and (2, 4): every
    rank's gradient against the derivative of the same function run
    whole (every rank's part simulated in one process), exactly;
  * the LM train step (the helper's ``steps_on_mesh``: the first batch's
    loss and gradient, summed by the rule for gradients and gathered, then
    one ZeRO-2 AdamW step, ``zero_specs`` at a minimum size of
    ``ZERO_MIN`` elements so that the reduced leaves do shard over
    ``data``) for the five reduced archs at (2, 2) and (2, 4): loss,
    every gradient leaf and the updated parameters against the port's
    one-device step (loss at ``TOL_OPT``; gradients and parameters at
    ``TOL_LM``, leaf-scaled as ``tests/test_torch_train.py`` states it)
    and against the reference's jitted step on its own mesh (8 forced
    host devices in a subprocess, as ``tests/test_distributed.py`` runs
    it). The MoE archs (deepseek-v2-lite, deepseek-v3) are held to the
    reference's mesh step only: their load-balance aux on a mesh is the
    mean of each data shard's ``E·Σ(me·ce)``, not the aux of the whole
    batch (reference ``moe.py:57-62,208``), so their loss on a mesh
    differs from one device by design (1.3e-4 at (2, 2) for the reduced
    deepseek-v2-lite, 1.2e-4 for deepseek-v3, and ~6e-4 on the embedding
    gradient); with the aux weight at 0 the MoE step equals one device;
  * micro-batches (two steps of 2) at (2, 2) against one device;
  * ``optimizer.adafactor()`` on a mesh (its means and the update clip's
    RMS over TP and ZeRO shards) against the reference's on its mesh;
  * the four recsys models at (2, 2): loss and every gradient leaf
    against one device within 2e-5 (leaf-scaled), the tables as
    ``RowShard``s whose gradient lands on the owner's rows, and one step
    of the combined optimizer (row-wise Adagrad on the split tables);
  * SchNet on molecule and full_graph_sm shapes (reduced widths) at
    (2, 2), its edges split over both axes: loss and gradients against
    the reference's (2e-5, leaf-scaled), one ZeRO-2 AdamW step against
    one device;
  * every rank's loss, gathered gradient and parameters after its steps
    the same bits as every other rank's;
  * the updates (new - old parameters) against one device's and the
    reference's, where a hold of the parameters alone would pass a step
    left out;
  * checkpoints: saved at (2, 2), restored on one device and at (2, 4);
    saved on one device, restored at (2, 2); saved at (2, 4), restored
    on one device: bit for bit;
  * ``launch/train.py`` with ``--mesh 2x2 --reduced``: losses against the
    one-device run, a resume bit for bit, the mesh's checkpoint restored
    by one device bit for bit;
  * the cells on a mesh: ``run_cell`` for schnet x molecule and din x
    train_batch (reduced), and smollm-135m x train_4k (reduced, its shape
    cut in the ranks to B=8, S=64), each rank's loss equal to the cell's
    one-device step and the backward's collectives counted.
"""
import argparse
import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.data import synthetic
from repro.models import schnet as jax_schnet
from repro.models import transformer as jax_tf
from repro.models.recsys import dien as jax_dien
from repro.models.recsys import din as jax_din
from repro.models.recsys import mind as jax_mind
from repro.models.recsys import towers as jax_towers
from repro_torch import tree as tree_lib
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.launch import dryrun, sharding, specs
from repro_torch.launch.mesh import CellDraw, Job, abstract_mesh, run_jobs
from repro_torch.launch.sharding import P
from repro_torch.launch.train import train
from repro_torch.models import transformer
from repro_torch.train import checkpoint, optimizer
from repro_torch.train.train_step import build_train_step, value_and_grad

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("data", "model")
MESHES = {"2x2": (2, 2), "2x4": (2, 4)}
LM_ARCHS = ["qwen3-8b", "smollm-135m", "starcoder2-7b",
            "deepseek-v2-lite-16b", "deepseek-v3-671b"]
MOE_ARCHS = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]
TOL_OPT = dict(rtol=1e-6, atol=1e-6)          # tests/test_torch_train.py
TOL = dict(rtol=2e-5, atol=2e-5)
TOL_LM = dict(rtol=2e-3, atol=2e-3)
#: zero_specs' minimum leaf size here: the reduced leaves are far below
#: the production 2^20, and a ZeRO shard is what the step must show
ZERO_MIN = 64
LR = 1e-3
B, S = 8, 16
RECSYS = {"din": (jax_din, "din"), "dien": (jax_dien, "dien"),
          "mind": (jax_mind, "mind"),
          "two-tower-retrieval": (jax_towers, "towers")}
GNN_SHAPES = ["molecule", "full_graph_sm"]
KINDS = ["all_gather", "all_gather_partial", "reduce_scatter", "all_reduce",
         "all_to_all", "enter"]
GROUPS = [("data",), ("model",), ("data", "model")]


def _reduced(reg, arch_id):
    arch = reg.get(arch_id)
    return arch.reduced(arch.config)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------- helpers

#: rank-side functions (the ranks import this module from the test's
#: temporary directory on sys.path; it imports nothing of jax)
HELPER = '''
import torch

from repro_torch import runtime
from repro_torch.configs import registry
from repro_torch.launch import sharding
from repro_torch.train import checkpoint


def _rep(mesh, axes):
    """The rank of this rank's group over ``axes`` at index 0 there."""
    coords = dict(mesh.coords)
    for a in axes:
        coords[a] = 0
    r = 0
    for a in mesh.axis_names:
        r = r * mesh.shape[a] + coords[a]
    return r


def collective_grad(params, X, W, kind, axes):
    """d loss / d x for this rank's x (X[rank]; X[group's first rank] for
    enter, a value replicated over ``axes``): the loss is this rank's
    <y, W[rank]> summed over every rank, or, where y is replicated over
    ``axes`` (all_gather, all_reduce), <y, W[group's first rank]> summed
    over the other axes."""
    mesh = runtime.current_mesh()
    axes = runtime.mesh_axes(axes)
    other = tuple(a for a in mesh.axis_names if a not in axes)
    rep = _rep(mesh, axes)
    x = (X[rep] if kind == "enter" else X[mesh.rank]).clone()
    with torch.enable_grad():
        x.requires_grad_(True)
        y = {"all_gather": lambda: runtime.all_gather(x, axes),
             "all_gather_partial": lambda: runtime.all_gather(
                 x, axes, partial=True),
             "reduce_scatter": lambda: runtime.reduce_scatter(x, axes),
             "all_reduce": lambda: runtime.all_reduce(x, axes),
             "all_to_all": lambda: runtime.all_to_all(x, axes),
             "enter": lambda: runtime.enter(x, axes)}[kind]()
        if kind in ("all_gather", "all_reduce"):
            loss = runtime.all_reduce((y * W[rep]).sum(), other)
        else:
            loss = runtime.all_reduce((y * W[mesh.rank]).sum(),
                                      mesh.axis_names)
        grad, = torch.autograd.grad(loss, x)
    return {"loss": float(loss), "grad": grad}


def steps_on_mesh(params, batches, loss, cfg, pspecs, zspecs,
                  opt=("adamw", {}), n_micro=1, batch_axes=None,
                  loss_kwargs=None):
    """The first batch's loss and gradient (summed by ``reduce_grads``,
    gathered whole), then one ZeRO-2 step (``zspecs``) per batch with
    ``opt`` (a factory of ``train/optimizer.py`` and its keywords, or
    "recsys" for ``for_family("recsys")``): {"loss", "grads", "losses",
    "params"}, the trees whole on every rank. ``loss`` is
    "module:function", called ``fn(params, batch, cfg, **loss_kwargs)``."""
    import importlib
    from repro_torch.train import optimizer
    from repro_torch.train.train_step import (build_train_step, reduce_grads,
                                              value_and_grad)
    module, name = loss.split(":")
    fn = getattr(importlib.import_module(module), name)

    def loss_fn(p, b):
        return fn(p, b, cfg, **(loss_kwargs or {}))
    mesh = runtime.current_mesh()
    l0, g = value_and_grad(loss_fn, params, batches[0])
    grads = sharding.gather_tree(reduce_grads(g, params, pspecs, batch_axes),
                                 pspecs, mesh)
    kind, kw = opt
    o = (optimizer.for_family("recsys") if kind == "recsys"
         else getattr(optimizer, kind)(**kw))
    step, init = build_train_step(loss_fn, o, n_micro=n_micro,
                                  grad_shardings=zspecs, param_specs=pspecs,
                                  batch_axes=batch_axes)
    state, losses = init(params), []
    for b in batches:
        params, state, l = step(params, state, b)
        losses.append(float(l))
    return {"loss": float(l0), "grads": grads, "losses": losses,
            "params": sharding.gather_tree(params, pspecs, mesh)}


def save_and_restore(params, pspecs, save_to=None, restore_from=None):
    """Save this rank's parameters (gathered; rank 0 writes) as gen_1 under
    ``save_to``; restore the newest generation under ``restore_from``
    onto the mesh and return it gathered whole."""
    mesh = runtime.current_mesh()
    if save_to:
        checkpoint.AsyncCheckpointer(save_to).save(params, 1, block=True,
                                                   specs=pspecs)
    if not restore_from:
        return None
    ck = checkpoint.AsyncCheckpointer(restore_from)
    got, _ = checkpoint.restore(ck.latest(), params, pspecs)
    return sharding.gather_tree(got, pspecs, mesh)


def moe_edge_grad(params, x, w, cfg, pspecs):
    """The gradient of <moe_apply(x), w> + aux over the expert weights
    and this rank's block of the tokens, summed by the rule (the expert
    weights and the router over data), gathered whole."""
    from repro_torch.launch.sharding import P
    from repro_torch.models import moe
    from repro_torch.train.train_step import reduce_grads, value_and_grad
    mesh = runtime.current_mesh()

    def loss_fn(q, b):
        out, aux = moe.moe_apply(q["p"], q["x"], cfg)
        return runtime.all_reduce((out * b).sum(), "data") + aux
    specs = {"p": pspecs, "x": P("data", None)}
    live = {"p": params, "x": x}
    loss, g = value_and_grad(loss_fn, live, w)
    return {"loss": float(loss), "grads": sharding.gather_tree(
        reduce_grads(g, live, specs), specs, mesh)}


def cut_shape(params, arch_id, shape_name, dims):
    """This rank's registry answers ``dims`` for the shape (a cell's
    published shape cut to a CPU's size)."""
    import dataclasses
    orig = registry.get_shape

    def get_shape(arch, name):
        s = orig(arch, name)
        if arch.arch_id == arch_id and name == shape_name:
            return dataclasses.replace(s, dims=dict(dims))
        return s
    registry.get_shape = get_shape
'''

CUT = ("smollm-135m", "train_4k", {"seq_len": 64, "global_batch": 8})


def _group(shape, rank, axes):
    """(ranks of ``rank``'s group over ``axes`` in flat-index order, its
    position there) on a mesh of ``shape`` over AXES."""
    coords = np.unravel_index(rank, shape)
    members = []
    for r in range(int(np.prod(shape))):
        c = np.unravel_index(r, shape)
        if all(c[i] == coords[i] for i, a in enumerate(AXES)
               if a not in axes):
            members.append(r)
    return members, members.index(rank)


def _collective_case(shape, kind, axes):
    """(X, W, each rank's expected gradient): the loss of the helper's
    ``collective_grad`` written out over all ranks in one process and
    differentiated by autograd."""
    rng = np.random.default_rng(len(kind) * 7 + len(axes) + shape[1])
    R, rows, cols = int(np.prod(shape)), 8, 3
    G = len(_group(shape, 0, axes)[0])
    X = rng.normal(size=(R, rows, cols)).astype(np.float32)
    yrows = {"all_gather": G * rows, "all_gather_partial": G * rows,
             "reduce_scatter": rows // G}.get(kind, rows)
    W = rng.normal(size=(R, yrows, cols)).astype(np.float32)
    x = torch.tensor(X, requires_grad=True)
    w = torch.tensor(W)
    loss = torch.zeros(())
    for r in range(R):
        members, pos = _group(shape, r, axes)
        rep = members[0]
        if kind in ("all_gather", "all_reduce") and r != rep:
            continue                  # the replicated term counts once
        if kind in ("all_gather", "all_gather_partial"):
            y = torch.cat([x[q] for q in members])
        elif kind == "reduce_scatter":
            y = sum(x[q] for q in members).chunk(G)[pos]
        elif kind == "all_reduce":
            y = sum(x[q] for q in members)
        elif kind == "all_to_all":
            y = torch.cat([x[q].chunk(G)[pos] for q in members])
        else:                         # enter: x replicated over the group
            y = x[rep]
        loss = loss + (y * w[rep if kind in ("all_gather", "all_reduce")
                              else r]).sum()
    loss.backward()
    want = [x.grad[_group(shape, r, axes)[0][0] if kind == "enter" else r]
            for r in range(R)]
    return X, W, float(loss.detach()), [g.numpy() for g in want]


@functools.lru_cache(maxsize=None)
def _lm_weights(arch_id):
    """The reference's ``init`` of the reduced LM, as numpy."""
    return _np(jax_tf.init(jax.random.PRNGKey(0),
                           _reduced(jax_registry, arch_id)))


def _lm_case(arch_id, shape, opt=("adamw", {"lr": LR}), n_micro=1,
             batches=None, loss_kwargs=None):
    """A ``steps_on_mesh`` job for the reduced LM on the reference's
    weights."""
    cfg = _reduced(registry, arch_id)
    weights = _lm_weights(arch_id)
    port = params_from_numpy(weights, "cpu")
    mesh = abstract_mesh(shape, AXES)
    pspecs = sharding.lm_param_specs(port, cfg, mesh)
    zspecs = sharding.zero_specs(port, pspecs, mesh, min_size=ZERO_MIN)
    batches = batches if batches is not None else [_tokens(arch_id)]
    return Job("mesh_train_helper:steps_on_mesh", weights, pspecs,
               (batches,), ([P("data", None)] * len(batches),),
               {"loss": "repro_torch.models.transformer:lm_loss", "cfg": cfg,
                "pspecs": pspecs, "zspecs": zspecs, "opt": opt,
                "n_micro": n_micro, "loss_kwargs": loss_kwargs})


def _tokens(arch_id, seed=0):
    cfg = _reduced(registry, arch_id)
    rng = np.random.default_rng(seed + len(arch_id))
    return rng.integers(0, cfg.vocab, (B, S))


@functools.lru_cache(maxsize=None)
def _rec_case(name):
    jmod, _ = RECSYS[name]
    cfg = _reduced(registry, name)
    weights = _np(jmod.init(jax.random.PRNGKey(0),
                            _reduced(jax_registry, name)))
    batch = synthetic.recsys_batch(np.random.default_rng(3), cfg, 16)
    mesh = abstract_mesh((2, 2), AXES)
    port = params_from_numpy(weights, "cpu")
    pspecs = sharding.recsys_param_specs(port, cfg, mesh)
    bspec = tree_lib.tree_map(
        lambda a: sharding.batched_spec(mesh, np.shape(a)), batch)
    job = Job("mesh_train_helper:steps_on_mesh", weights, pspecs,
              ([batch],), ([bspec],),
              {"loss": f"repro_torch.models.recsys.{RECSYS[name][1]}:loss_fn",
               "cfg": cfg, "pspecs": pspecs,
               "zspecs": sharding.zero_specs(port, pspecs, mesh,
                                             min_size=ZERO_MIN),
               "opt": ("recsys", {})})
    return job, weights, batch


@functools.lru_cache(maxsize=None)
def _gnn_case(shape_name):
    cfg = _reduced(registry, "schnet")
    cell = specs.build_cell("schnet", shape_name, device="cpu", reduced=True)
    _, _, batch = cell.materialize("cpu", torch.Generator().manual_seed(0))
    batch = {"inputs": {k: v.numpy() for k, v in batch["inputs"].items()},
             "targets": batch["targets"].numpy()}
    d_feat = (batch["inputs"]["node_feat"].shape[1]
              if "node_feat" in batch["inputs"] else None)
    weights = _np(jax_schnet.init(jax.random.PRNGKey(0),
                                  _reduced(jax_registry, "schnet"), d_feat))
    n_graphs = len(batch["targets"])
    port = params_from_numpy(weights, "cpu")
    mesh = abstract_mesh((2, 2), AXES)
    pspecs = sharding.gnn_param_specs(port, cfg, mesh)
    job = Job("mesh_train_helper:steps_on_mesh", weights, pspecs,
              ([batch],), (None,),
              {"loss": "repro_torch.models.schnet:batch_loss", "cfg": cfg,
               "pspecs": pspecs,
               "zspecs": sharding.zero_specs(port, pspecs, mesh,
                                             min_size=ZERO_MIN),
               "batch_axes": (), "loss_kwargs": {"n_graphs": n_graphs}})
    return job, weights, batch, n_graphs


def _moe_edge():
    """Expert weights with d_ff = 15 (it does not split over data = 2),
    32 tokens and the output's weights."""
    rng = np.random.default_rng(8)
    d, E, f = 16, 8, 15
    return {"router": (rng.normal(size=(d, E)) / 4).astype(np.float32),
            "w1": (rng.normal(size=(E, d, f)) / 4).astype(np.float32),
            "w3": (rng.normal(size=(E, d, f)) / 4).astype(np.float32),
            "w2": (rng.normal(size=(E, f, d)) / 4).astype(np.float32),
            "x": rng.normal(size=(32, d)).astype(np.float32),
            "w": rng.normal(size=(32, d)).astype(np.float32)}


# ------------------------------------------------------------ reference

REF_SCRIPT = """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from repro import runtime
    from repro.configs import registry
    from repro.launch import sharding as shr
    from repro.launch.mesh import make_mesh
    from repro.models import transformer as tf
    from repro.train import optimizer as opt_lib
    from repro.train.train_step import build_train_step
    d = dict(np.load(sys.argv[1]))
    runs = [r.split(":") for r in sys.argv[3].split(",")]
    out = {}
    for arch_id, mesh_name, opt in runs:
        cfg = registry.get(arch_id)
        cfg = cfg.reduced(cfg.config)
        params = tf.init(jax.random.PRNGKey(0), cfg)
        toks = jnp.asarray(d[arch_id], jnp.int32)
        mesh = make_mesh(tuple(int(x) for x in mesh_name.split("x")),
                         ("data", "model"))
        with runtime.use_mesh(mesh):
            ps = shr.param_specs(params, cfg, mesh)
            zs = shr.zero_specs(params, ps, mesh, min_size=int(sys.argv[4]))
            loss_fn = lambda p, t: tf.lm_loss(p, t, cfg)
            o = (opt_lib.adamw(lr=float(sys.argv[5])) if opt == "adamw"
                 else opt_lib.adafactor())
            step, init = build_train_step(loss_fn, o,
                                          grad_shardings=shr.to_named(mesh, zs))

            def both(p, t):
                l, g = jax.value_and_grad(loss_fn)(p, t)
                new_p, _, _ = step(p, init(p), t)
                return l, g, new_p
            f = jax.jit(both, in_shardings=(
                shr.to_named(mesh, ps),
                shr.to_named(mesh, shr.batched_spec(mesh, toks.shape))))
            l, g, new_p = f(params, toks)
        key = f"{arch_id}/{mesh_name}/{opt}"
        out[key + "/loss"] = np.asarray(l)
        for i, leaf in enumerate(jax.tree.leaves(g)):
            out[f"{key}/grad/{i}"] = np.asarray(leaf)
        for i, leaf in enumerate(jax.tree.leaves(new_p)):
            out[f"{key}/param/{i}"] = np.asarray(leaf)
    # the MoE whose expert d_ff does not split over data (the mirrored
    # sum over data): its gradient on the (2, 4) mesh and on one device
    from repro.configs.base import MoEConfig
    from repro.models.moe import moe_apply
    cfg = MoEConfig(n_routed=8, top_k=2, d_ff_expert=15, capacity_factor=8.0)
    p = {k: jnp.asarray(d["moe/" + k]) for k in ("router", "w1", "w3", "w2")}
    x, w = jnp.asarray(d["moe/x"]), jnp.asarray(d["moe/w"])

    def moe_loss(p, x):
        o, aux = moe_apply(p, x, cfg)
        return jnp.sum(o * w) + aux
    grad = jax.value_and_grad(moe_loss, argnums=(0, 1))
    with runtime.use_mesh(make_mesh((2, 4), ("data", "model"))):
        runs = {"2x4": jax.jit(grad)(p, x)}
    runs["single"] = grad(p, x)
    for name, (l, (gp, gx)) in runs.items():
        out[f"moe/{name}/loss"] = np.asarray(l)
        for i, leaf in enumerate(jax.tree.leaves({"p": gp, "x": gx})):
            out[f"moe/{name}/grad/{i}"] = np.asarray(leaf)
    np.savez(sys.argv[2], **out)
    print("REF-MESH-OK")
"""

#: the reference's mesh steps: every arch at (2, 4), the MoE archs (held
#: to the reference only) at (2, 2) too, and Adafactor on qwen3-8b
REF_RUNS = ([f"{a}:2x4:adamw" for a in LM_ARCHS]
            + [f"{a}:2x2:adamw" for a in MOE_ARCHS]
            + ["qwen3-8b:2x4:adafactor"])


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    """The reference's mesh steps, started first in a subprocess of their
    own (they run while the ranks do)."""
    tmp = tmp_path_factory.mktemp("ref_mesh")
    np.savez(tmp / "in.npz", **{a: _tokens(a) for a in LM_ARCHS},
             **{"moe/" + k: v for k, v in _moe_edge().items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_SCRIPT), str(tmp / "in.npz"),
         str(tmp / "out.npz"), ",".join(REF_RUNS), str(ZERO_MIN), str(LR)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def ref_runs(ref_proc, mesh_runs):
    proc, tmp = ref_proc
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0 and "REF-MESH-OK" in out, \
        out[-2000:] + err[-3000:]
    return dict(np.load(tmp / "out.npz"))


# ------------------------------------------------------------ the ranks

@pytest.fixture(scope="module")
def mesh_runs(ref_proc, tmp_path_factory):
    """One launch per mesh: (2, 2) the collectives, the LM steps, the
    micro-batched step, the recsys and SchNet steps, the checkpoint round
    trips and the cut train_4k cell; (2, 4) the collectives, the LM
    steps, the MoE without its aux, Adafactor and the checkpoints."""
    helper = tmp_path_factory.mktemp("helper")
    (helper / "mesh_train_helper.py").write_text(HELPER)
    ck = tmp_path_factory.mktemp("ckpt")
    # a one-device checkpoint the (2, 2) ranks restore
    smollm = _lm_case("smollm-135m", (2, 2))
    checkpoint.AsyncCheckpointer(str(ck / "one")).save(
        params_from_numpy(smollm.params, "cpu"), 1, block=True)
    out = {"ckpt_dir": ck}
    for name, shape in MESHES.items():
        jobs = {}
        for kind in KINDS:
            for axes in GROUPS:
                X, W, _, _ = _collective_case(shape, kind, axes)
                jobs[("collective", kind, axes)] = Job(
                    "mesh_train_helper:collective_grad", None, None, (X, W),
                    (None, None), {"kind": kind, "axes": axes})
        for arch_id in LM_ARCHS:
            jobs[("lm", arch_id)] = _lm_case(arch_id, shape)
        lm = _lm_case("smollm-135m", shape)
        if name == "2x2":
            jobs["micro"] = _lm_case(
                "smollm-135m", shape, n_micro=2,
                batches=[_tokens("smollm-135m", s) for s in (0, 1)])
            for rec in RECSYS:
                jobs[("rec", rec)] = _rec_case(rec)[0]
            for g in GNN_SHAPES:
                jobs[("gnn", g)] = _gnn_case(g)[0]
            jobs["ckpt"] = Job("mesh_train_helper:save_and_restore",
                               lm.params, lm.pspecs, (), (),
                               {"pspecs": lm.pspecs,
                                "save_to": str(ck / "from_2x2"),
                                "restore_from": str(ck / "one")})
            jobs["cut"] = Job("mesh_train_helper:cut_shape", None, None,
                              CUT, (None, None, None))
            jobs["cell"] = Job(params=CellDraw(CUT[0], CUT[1], reduced=True),
                               repeat=1)
        else:
            from repro_torch.configs.base import MoEConfig
            from repro_torch.models import moe
            edge = _moe_edge()
            mspecs = moe.moe_param_specs(None, f_sharded=False)
            jobs["moe_edge"] = Job(
                "mesh_train_helper:moe_edge_grad",
                {k: edge[k] for k in ("router", "w1", "w3", "w2")}, mspecs,
                (edge["x"], edge["w"]), (P("data", None), P("data", None)),
                {"cfg": MoEConfig(n_routed=8, top_k=2, d_ff_expert=15,
                                  capacity_factor=8.0), "pspecs": mspecs})
            jobs["moe_no_aux"] = _lm_case("deepseek-v2-lite-16b", shape,
                                          loss_kwargs={"aux_weight": 0.0})
            jobs["adafactor"] = _lm_case("qwen3-8b", shape,
                                         opt=("adafactor", {}))
            jobs["ckpt"] = Job("mesh_train_helper:save_and_restore",
                               lm.params, lm.pspecs, (), (),
                               {"pspecs": lm.pspecs,
                                "save_to": str(ck / "from_2x4"),
                                "restore_from": str(ck / "from_2x2")})
        sys.path.insert(0, str(helper))
        try:
            ranks = run_jobs(list(jobs.values()), shape, timeout=400)
        finally:
            sys.path.remove(str(helper))
        out[name] = {k: [r[i] for r in ranks] for i, k in enumerate(jobs)}
    return out


# ----------------------------------------------------------- one device

def _one_device_lm(arch_id, opt, n_micro=1, batches=None, aux_weight=1e-3):
    cfg = _reduced(registry, arch_id)
    params = params_from_numpy(_lm_weights(arch_id), "cpu")
    batches = batches or [_tokens(arch_id)]

    def loss_fn(p, t):
        return transformer.lm_loss(p, t, cfg, aux_weight=aux_weight)
    loss, grads = value_and_grad(loss_fn, params, torch.as_tensor(batches[0]))
    step, init = build_train_step(loss_fn, opt, n_micro=n_micro)
    state, losses = init(params), []
    for b in batches:
        params, state, l = step(params, state, torch.as_tensor(b))
        losses.append(float(l))
    return float(loss), grads, params, losses


def _leaves(tree) -> list:
    """A tree's leaves (or a list of leaves) in JAX's order, as numpy."""
    leaves = tree if isinstance(tree, list) else tree_lib.leaves(tree)
    return [x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x) for x in leaves]


def _close(got, want, tol, leaf_scale=True, label=""):
    """Two trees (or a tree and a list of leaves in JAX's order) leaf by
    leaf; ``leaf_scale``: atol x max(1, max|want|) per leaf."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (label, i)
        scale = max(1.0, float(np.abs(b).max(initial=0))) if leaf_scale else 1
        np.testing.assert_allclose(a, b, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale,
                                   err_msg=f"{label} leaf {i}")


def _update_close(got, old, want, grads, label="", frac=1e-2):
    """The update ``got - old`` against ``want - old``, leaf by leaf, on
    the elements whose gradient (``grads``) is at least 1e-3 of the
    leaf's largest: within ``frac`` of the leaf's largest update there.
    AdamW's first step moves each such element by about lr whatever its
    gradient's size (a gradient near rounding may flip its sign, hence
    the mask), so a step skipped, or applied on one ZeRO shard of a leaf,
    fails here, where a hold of the parameters at TOL_LM (2e-3, twice
    lr) passes."""
    got, old, want, grads = ([a.astype(np.float32) for a in _leaves(t)]
                             for t in (got, old, want, grads))
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


def _ref_leaves(ref, key, what):
    n = sum(1 for k in ref if k.startswith(f"{key}/{what}/"))
    return [ref[f"{key}/{what}/{i}"] for i in range(n)]


# ------------------------------------------------------------ collectives

@pytest.mark.parametrize("axes", GROUPS, ids=["data", "model", "both"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_collective_backward_equals_the_whole_derivative(mesh, kind, axes,
                                                         mesh_runs):
    """Every rank's gradient through the collective equals the derivative
    of the same function run whole (each rank's part written out in one
    process), and every rank holds the same loss."""
    _, _, loss, want = _collective_case(MESHES[mesh], kind, axes)
    for r, rank in enumerate(mesh_runs[mesh][("collective", kind, axes)]):
        np.testing.assert_allclose(rank["out"]["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(rank["out"]["grad"], want[r], rtol=1e-6,
                                   atol=1e-6)


def test_backward_collectives_are_counted_by_kind(mesh_runs):
    """A backward's collectives count as ``kind/bwd``: reduce_scatter's
    all_gather, the partial gather's reduce_scatter, enter's all_reduce;
    an all_gather's own-block backward and an all_reduce's identity move
    nothing."""
    runs = mesh_runs["2x2"]

    def kinds(kind):
        return {k for (k, _g) in runs[("collective", kind, ("data",))][0][
            "collectives"]}
    assert "all_gather/bwd" in kinds("reduce_scatter")
    assert "reduce_scatter/bwd" in kinds("all_gather_partial")
    assert "all_reduce/bwd" in kinds("enter")
    assert "all_to_all/bwd" in kinds("all_to_all")
    assert not any(k.endswith("/bwd") for k in kinds("all_gather"))
    assert not any(k.endswith("/bwd") for k in kinds("all_reduce"))


# --------------------------------------------------------------------- LM

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch_id", [a for a in LM_ARCHS
                                     if a not in MOE_ARCHS])
def test_lm_mesh_step_equals_one_device(arch_id, mesh, mesh_runs):
    """A dense arch's loss, every gradient leaf and the parameters after
    one ZeRO-2 AdamW step on every rank against the port's one-device
    step on the same weights and tokens."""
    loss, grads, params, _ = _one_device_lm(arch_id, optimizer.adamw(lr=LR))
    for rank in mesh_runs[mesh][("lm", arch_id)]:
        out = rank["out"]
        np.testing.assert_allclose(out["loss"], loss, **TOL_OPT)
        _close(out["grads"], grads, TOL_LM, label="grads")
        _close(out["params"], params, TOL_LM, label="params")
        _update_close(out["params"], _lm_weights(arch_id), params, grads,
                      label="params")


@pytest.mark.parametrize("run", [r for r in REF_RUNS
                                 if r.endswith(":adamw")])
def test_lm_mesh_step_equals_reference_mesh_step(run, mesh_runs, ref_runs):
    """The loss, every gradient leaf and the updated parameters of each
    rank's step against the reference's jitted step on its own mesh of
    the same shape (GSPMD's partitioning of value_and_grad and of the
    ZeRO-2 constrained accumulator), MoE archs included."""
    arch_id, mesh, _ = run.split(":")
    key = f"{arch_id}/{mesh}/adamw"
    for rank in mesh_runs[mesh][("lm", arch_id)]:
        out = rank["out"]
        np.testing.assert_allclose(out["loss"], ref_runs[key + "/loss"],
                                   **TOL_LM)
        _close(out["grads"], _ref_leaves(ref_runs, key, "grad"), TOL_LM,
               label="grads")
        _close(out["params"], _ref_leaves(ref_runs, key, "param"), TOL_LM,
               label="params")
        _update_close(out["params"], _lm_weights(arch_id),
                      _ref_leaves(ref_runs, key, "param"),
                      _ref_leaves(ref_runs, key, "grad"), label="params")


def test_update_hold_fails_a_skipped_or_one_shard_step():
    """The update hold sees what a hold of the parameters at TOL_LM does
    not: a step left out, and a step applied on the first half of each
    leaf's dim 0 only (one data shard of a ZeRO-2 step), both fail it;
    the one-device step itself passes."""
    old = params_from_numpy(_lm_weights("smollm-135m"), "cpu")
    _, grads, new, _ = _one_device_lm("smollm-135m", optimizer.adamw(lr=LR))
    _update_close(new, old, new, grads)

    def half(n, o):
        out = o.clone()
        if n.dim():
            k = (n.shape[0] + 1) // 2
            out[:k] = n[:k]
        return out
    for planted in (old, tree_lib.tree_map(half, new, old)):
        with pytest.raises(AssertionError):
            _update_close(planted, old, new, grads)


def test_moe_mesh_step_without_aux_equals_one_device(mesh_runs):
    """With the aux weight at 0 the expert-parallel step (tokens and gates
    entering ``model``, gathered over ``data`` with the partial backward)
    equals one device: the MoE's mesh difference is its aux alone."""
    loss, grads, params, _ = _one_device_lm(
        "deepseek-v2-lite-16b", optimizer.adamw(lr=LR), aux_weight=0.0)
    for rank in mesh_runs["2x4"]["moe_no_aux"]:
        np.testing.assert_allclose(rank["out"]["loss"], loss, **TOL_OPT)
        _close(rank["out"]["grads"], grads, TOL_LM, label="grads")


MOE_TOL = dict(rtol=5e-4, atol=5e-5)             # tests/test_distributed.py


def test_moe_mirrored_data_sum_gradient_equals_reference_mesh(mesh_runs,
                                                              ref_runs):
    """The MoE whose expert d_ff (15) does not split over data (2) on
    (2, 4): the token-sharded branch sums the data ranks' identical rows
    (``ROADMAP.md`` §C), and the gradient follows that forward: every
    gradient leaf (router, experts, tokens) equals the reference's on its
    own mesh. Against one device the expert weights' gradients are
    n_data = 2 times as large, as the outputs are."""
    got = mesh_runs["2x4"]["moe_edge"]
    want = _ref_leaves(ref_runs, "moe/2x4", "grad")
    single = _ref_leaves(ref_runs, "moe/single", "grad")
    for rank in got:
        np.testing.assert_allclose(rank["out"]["loss"],
                                   ref_runs["moe/2x4/loss"], **MOE_TOL)
        _close(rank["out"]["grads"], want, MOE_TOL, leaf_scale=False,
               label="moe grads")
    # leaves in JAX's order: p/router, p/w1, p/w2, p/w3, x
    for i in (1, 2, 3):
        ratio = np.abs(want[i]).sum() / np.abs(single[i]).sum()
        assert 1.5 < ratio < 2.5, ratio


def test_micro_batched_mesh_steps_equal_one_device(mesh_runs):
    """Two steps of two micro-batches each: the accumulator in the ZeRO
    shard, in the parameters' dtype, then divided; losses and parameters
    against one device."""
    batches = [_tokens("smollm-135m", s) for s in (0, 1)]
    _, _, params, losses = _one_device_lm(
        "smollm-135m", optimizer.adamw(lr=LR), n_micro=2, batches=batches)
    for rank in mesh_runs["2x2"]["micro"]:
        np.testing.assert_allclose(rank["out"]["losses"], losses, **TOL_OPT)
        _close(rank["out"]["params"], params, TOL_LM, label="params")


def test_zero_step_reduce_scatters_gradients(mesh_runs):
    """The ZeRO-2 step moves its leaves' gradients by reduce_scatter into
    the shards and all-gathers the new parameters over data; the TP
    regions' backward sums by enter's all_reduce."""
    rows = mesh_runs["2x4"][("lm", "qwen3-8b")][0]["collectives"]
    kinds = {k for (k, _g) in rows}
    assert {"reduce_scatter", "all_gather", "all_reduce/bwd"} <= kinds


def test_adafactor_on_a_mesh_equals_reference(mesh_runs, ref_runs):
    """One Adafactor step on (2, 4) (its row / column means and the
    update clip's RMS over leaves split over model and ZeRO-sharded over
    data) against the reference's Adafactor step on its mesh, and against
    the port's one-device Adafactor."""
    key = "qwen3-8b/2x4/adafactor"
    _, grads, params, _ = _one_device_lm("qwen3-8b", optimizer.adafactor())
    old = _lm_weights("qwen3-8b")
    for rank in mesh_runs["2x4"]["adafactor"]:
        got = rank["out"]["params"]
        _close(got, _ref_leaves(ref_runs, key, "param"), TOL_LM,
               label="params vs reference")
        _close(got, params, TOL_LM, label="params")
        _update_close(got, old, _ref_leaves(ref_runs, key, "param"), grads,
                      label="update vs reference")
        _update_close(got, old, params, grads, label="update")


# ----------------------------------------------------------------- recsys

@pytest.mark.parametrize("name", sorted(RECSYS))
def test_recsys_mesh_step_equals_one_device(name, mesh_runs):
    """Loss and every gradient leaf (the split tables' rows gathered
    whole) within 2e-5, leaf-scaled, of one device on the reference's
    weights; the parameters after one combined step (AdamW dense,
    row-wise Adagrad on each rank's rows) within TOL_LM."""
    _, weights, batch = _rec_case(name)
    cfg = _reduced(registry, name)
    mod = __import__(f"repro_torch.models.recsys.{RECSYS[name][1]}",
                     fromlist=["loss_fn"])
    params = params_from_numpy(weights, "cpu")
    tb = tree_lib.tree_map(lambda a: torch.as_tensor(
        a, dtype=torch.int64 if np.asarray(a).dtype.kind in "iu"
        else torch.float32), batch)

    def loss_fn(p, b):
        return mod.loss_fn(p, b, cfg)
    loss, grads = value_and_grad(loss_fn, params, tb)
    step, init = build_train_step(loss_fn, optimizer.for_family("recsys"))
    new, _, _ = step(params, init(params), tb)
    for rank in mesh_runs["2x2"][("rec", name)]:
        out = rank["out"]
        np.testing.assert_allclose(out["loss"], float(loss), **TOL)
        _close(out["grads"], grads, TOL, label="grads")
        _close(out["params"], new, TOL_LM, label="params")
        _update_close(out["params"], weights, new, grads, label="params")
    assert any(np.abs(g).max() > 0 for g in
               tree_lib.leaves(mesh_runs["2x2"][("rec", name)][0]["out"][
                   "grads"]["tables"]))


# ----------------------------------------------------------------- SchNet

@pytest.mark.parametrize("shape_name", GNN_SHAPES)
def test_schnet_edge_split_equals_reference(shape_name, mesh_runs):
    """SchNet with its edges split over (data, model) on (2, 2) (padded
    with sentinel edges; the partial node sums all-reduced): loss and
    every gradient against the reference's ``jax.value_and_grad`` within
    2e-5 (leaf-scaled), and one AdamW step against one device."""
    _, weights, batch, n_graphs = _gnn_case(shape_name)
    cfg = _reduced(registry, "schnet")
    jcfg = _reduced(jax_registry, "schnet")
    j_loss, j_grads = jax.jit(jax.value_and_grad(jax_schnet.loss_fn),
                              static_argnums=(3, 4))(
        jax.tree.map(jnp.asarray, weights),
        {k: jnp.asarray(v) for k, v in batch["inputs"].items()},
        jnp.asarray(batch["targets"]), jcfg, n_graphs)
    from repro_torch.models import schnet
    params = params_from_numpy(weights, "cpu")
    tb = {"inputs": {k: torch.as_tensor(v).long() if v.dtype.kind in "iu"
                     else torch.as_tensor(v)
                     for k, v in batch["inputs"].items()},
          "targets": torch.as_tensor(batch["targets"])}
    step, init = build_train_step(
        lambda p, b: schnet.batch_loss(p, b, cfg, n_graphs=n_graphs),
        optimizer.adamw())
    new, _, _ = step(params, init(params), tb)
    for rank in mesh_runs["2x2"][("gnn", shape_name)]:
        out = rank["out"]
        np.testing.assert_allclose(out["loss"], float(j_loss), **TOL)
        _close(out["grads"], [np.asarray(g) for g in
                              jax.tree.leaves(j_grads)], TOL, label="grads")
        _close(out["params"], new, TOL_LM, label="params")
        _update_close(out["params"], weights, new, list(
            jax.tree.leaves(j_grads)), label="params")


#: every train-step job of the launches: (mesh, job key)
RANK_RUNS = ([(m, ("lm", a)) for m in sorted(MESHES) for a in LM_ARCHS]
             + [("2x2", ("rec", r)) for r in sorted(RECSYS)]
             + [("2x2", ("gnn", g)) for g in GNN_SHAPES]
             + [("2x2", "micro"), ("2x4", "moe_no_aux"), ("2x4", "adafactor")])


@pytest.mark.parametrize("mesh,key", RANK_RUNS, ids=[
    f"{m}-{k if isinstance(k, str) else '-'.join(k)}" for m, k in RANK_RUNS])
def test_every_rank_ends_with_the_same_bits(mesh, key, mesh_runs):
    """The rule for gradients made good: every rank computes the same
    loss, gathers the same gradient and holds the same parameters after
    its steps, bit for bit (its own replicated parts included). A value
    a rank holds replicated but computes in another order than the
    others (a sum by ``index_add``) would part the replicas step by
    step."""
    ranks = [r["out"] for r in mesh_runs[mesh][key]]
    first = ranks[0]
    for rank in ranks[1:]:
        assert [rank["loss"]] + rank["losses"] == \
            [first["loss"]] + first["losses"]
        _bitwise(rank["grads"], first["grads"])
        _bitwise(rank["params"], first["params"])


# ------------------------------------------------------------ checkpoints

def _bitwise(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_saved_on_one_device_restores_on_2x2(mesh_runs):
    weights = _lm_case("smollm-135m", (2, 2)).params
    for rank in mesh_runs["2x2"]["ckpt"]:
        _bitwise(rank["out"], weights)


def test_checkpoint_saved_on_2x2_restores_on_one_device_and_2x4(mesh_runs):
    """The (2, 2) ranks' checkpoint (gathered, written by rank 0 in the
    one-device format) restored on one device and by the 8 ranks of
    (2, 4), each holding its part, gathered: bit for bit the weights."""
    weights = _lm_case("smollm-135m", (2, 2)).params
    ck = checkpoint.AsyncCheckpointer(str(mesh_runs["ckpt_dir"] / "from_2x2"))
    got, step = checkpoint.restore(ck.latest(), params_from_numpy(weights,
                                                                  "cpu"))
    assert step == 1
    _bitwise(got, weights)
    for rank in mesh_runs["2x4"]["ckpt"]:
        _bitwise(rank["out"], weights)


def test_checkpoint_saved_on_2x4_restores_on_one_device(mesh_runs):
    weights = _lm_case("smollm-135m", (2, 4)).params
    ck = checkpoint.AsyncCheckpointer(str(mesh_runs["ckpt_dir"] / "from_2x4"))
    got, _ = checkpoint.restore(ck.latest(), params_from_numpy(weights,
                                                               "cpu"))
    _bitwise(got, weights)


# --------------------------------------------------------------- launcher

def _train_args(ckpt_dir, steps, mesh):
    return argparse.Namespace(arch="smollm-135m", shape="train_4k",
                              steps=steps, mesh=mesh, multi_pod=False,
                              reduced=True, ckpt_dir=str(ckpt_dir),
                              ckpt_every=2, batch=None, n_micro=2)


def test_train_launcher_on_a_2x2_mesh_resumes_bit_for_bit(tmp_path):
    """``train`` with ``--mesh 2x2 --reduced`` (4 gloo ranks, 2
    micro-batches): the losses of 3 steps against the one-device run of
    the same seeded draw (TOL_OPT), the final parameters within TOL_LM;
    a resume on the mesh restores the saved parameters bit for bit and
    goes on; the mesh's newest checkpoint restores on one device bit for
    bit; every rank reports its step times."""
    one = train(_train_args(tmp_path / "one", 3, None), device="cpu")
    mesh = train(_train_args(tmp_path / "mesh", 3, "2x2"), device="cpu")
    np.testing.assert_allclose(mesh["losses"], one["losses"], **TOL_OPT)
    _close(mesh["params"], one["params"], TOL_LM, label="params")
    assert len(mesh["ranks"]) == 4
    assert all(len(r["step_s"]) == 3 for r in mesh["ranks"])
    assert sorted(os.listdir(tmp_path / "mesh")) == ["gen_2", "gen_3"]

    again = train(_train_args(tmp_path / "mesh", 2, "2x2"), device="cpu")
    assert again["start_step"] == 3 and again["end_step"] == 5
    _bitwise(again["restored"], mesh["params"])
    single = train(_train_args(tmp_path / "mesh", 1, None), device="cpu")
    assert single["start_step"] == 5
    _bitwise(single["restored"], again["params"])


def test_train_launcher_parses_multi_pod_and_reads_nothing(tmp_path):
    """``--multi-pod`` is parsed (as the reference's) and changes nothing:
    the run equals one without it."""
    from repro_torch.launch.train import parser
    args = parser().parse_args(["--reduced", "--multi-pod", "--steps", "1",
                                "--ckpt-dir", str(tmp_path / "a")])
    assert args.multi_pod
    a = train(args, device="cpu")
    b = train(parser().parse_args(["--reduced", "--steps", "1",
                                   "--ckpt-dir", str(tmp_path / "b")]),
              device="cpu")
    assert a["losses"] == b["losses"]


# ------------------------------------------------------------------ cells

@pytest.mark.parametrize("arch_id,shape_name", [("schnet", "molecule"),
                                                ("din", "train_batch")])
def test_run_cell_trains_on_a_2x2_mesh(arch_id, shape_name, tmp_path):
    """``run_cell`` of a training cell (reduced) on 4 gloo ranks: ``ok``,
    every rank's loss equal to the cell's one-device step on the same
    draw, and the step's collectives counted with the backward's."""
    rec = dryrun.run_cell(arch_id, shape_name, str(tmp_path), device="cpu",
                          reduced=True, mesh=(2, 2), steps=1, warmup=1)
    assert rec["ok"], rec.get("traceback")
    assert (tmp_path / f"{arch_id}__{shape_name}__2x2@cpu.json").exists()
    cell = specs.build_cell(arch_id, shape_name, device="cpu", reduced=True)
    want = cell.fn(*cell.materialize("cpu",
                                     torch.Generator().manual_seed(0)))[2]
    np.testing.assert_allclose(rec["output"][0], float(want), **TOL)
    for r in rec["ranks"]:
        assert any(k.endswith("/bwd") for k in r["collectives_per_step"])


def test_lm_train_cell_on_a_2x2_mesh(mesh_runs, monkeypatch):
    """smollm-135m x train_4k (reduced; its shape cut in the ranks to B=8,
    S=64) as a ``CellDraw`` job: every rank's first step's loss equals the
    cell's one-device step on the same draw, and the ZeRO step's
    collectives are counted."""
    from repro_torch.configs import registry as port_registry
    orig = port_registry.get_shape

    def get_shape(arch, name):
        s = orig(arch, name)
        if arch.arch_id == CUT[0] and name == CUT[1]:
            import dataclasses
            return dataclasses.replace(s, dims=dict(CUT[2]))
        return s
    monkeypatch.setattr(port_registry, "get_shape", get_shape)
    cell = specs.build_cell(CUT[0], CUT[1], device="cpu", reduced=True)
    want = cell.fn(*cell.materialize("cpu",
                                     torch.Generator().manual_seed(0)))[2]
    for rank in mesh_runs["2x2"]["cell"]:
        np.testing.assert_allclose(rank["out"][0], float(want), **TOL_OPT)
        kinds = {k for (k, _g) in rank["collectives"]}
        assert {"all_reduce", "all_reduce/bwd"} <= kinds
