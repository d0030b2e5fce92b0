"""The port's training path against the reference, on the CPU at small
sizes, with the reference's weights carried across through numpy:

  * the optimizers (AdamW, Adafactor with its per-slice path, row-wise
    Adagrad, the combined recsys optimizer) over 3 steps on the same
    gradients: params and state within 1e-6, step counters equal; table
    rows without a gradient unchanged bit for bit;
  * ``build_train_step`` at n_micro 1 and 2;
  * the loss and gradient of each recsys ``loss_fn`` (2e-5, the models'
    tolerance) and of ``lm_loss`` for the five reduced LM archs (2e-3, the
    LM tolerance of tests/test_models.py), deepseek-v3's MTP and the MoE
    aux term included, with and without remat;
  * checkpoints written by either package restored by the other, bit for
    bit, with equal names, order and crc32, bfloat16 included;
    ``AsyncCheckpointer``'s keep and ``latest``; ``CheckpointDiffEmitter``
    on the port's checkpoints;
  * ``launch/train.py::train`` on the CPU at ``--reduced`` with a resume.
"""
import argparse
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry
from repro.data import synthetic
from repro.models import transformer as jax_tf
from repro.models.recsys import dien as jax_dien
from repro.models.recsys import din as jax_din
from repro.models.recsys import mind as jax_mind
from repro.models.recsys import towers as jax_towers
from repro.train import checkpoint as jax_ckpt
from repro.train import optimizer as jax_opt
from repro.train.train_step import build_train_step as jax_build_train_step
from repro.update.delta import CheckpointDiffEmitter as JaxDiffEmitter
from repro_torch import tree as tree_lib
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch.train import train
from repro_torch.models import transformer
from repro_torch.models.recsys import dien, din, mind, towers
from repro_torch.train import checkpoint, optimizer
from repro_torch.train.train_step import build_train_step, value_and_grad
from repro_torch.update.delta import CheckpointDiffEmitter

TOL_OPT = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=2e-5, atol=2e-5)             # tests/test_torch_din.py
TOL_LM = dict(rtol=2e-3, atol=2e-3)          # tests/test_models.py
LM_ARCHS = ["qwen3-8b", "smollm-135m", "starcoder2-7b",
            "deepseek-v2-lite-16b", "deepseek-v3-671b"]


def _reduced(arch_id):
    a = registry.get(arch_id)
    return a.reduced(a.config)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(
        a.astype(np.int32) if a.dtype.kind in "iu" else a), tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return torch.as_tensor(a, dtype=torch.int64 if a.dtype.kind in "iu"
                           else torch.float32)


def _assert_trees_close(got, want, tol, leaf_scale=False):
    """The port's tree against the reference's, leaf by leaf in JAX's
    order (equal paths). ``leaf_scale``: the absolute part of the
    tolerance grows with the leaf's largest entry where that exceeds 1
    (atol x max(1, max|want|)), for gradients whose scale is set by a
    division by a small norm (MIND's squash and l2_normalize give
    gradients of order 1e3 at the reduced widths, where float32 sums in
    two orders part at 2.3e-5 of an entry's size)."""
    g = tree_lib.flatten_with_paths(params_to_numpy(got))
    w = jax.tree_util.tree_flatten_with_path(_np(want))[0]
    assert [tree_lib.path_name(p) for p, _ in g] == \
        jax_ckpt.tree_paths(_np(want))
    assert len(g) == len(w)
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, path
        scale = max(1.0, float(np.abs(b).max(initial=0))) if leaf_scale else 1
        np.testing.assert_allclose(a, b, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale, err_msg=str(path))


# -------------------------------------------------------------- optimizers

def _opt_params(rng):
    """A tree of every leaf kind the optimizers treat apart: a factored
    3-D stack, a factored matrix, a vector, a (n, 1) column, a list."""
    return {"stack": rng.normal(size=(3, 6, 5)).astype(np.float32),
            "m": {"w": rng.normal(size=(7, 4)).astype(np.float32),
                  "b": rng.normal(size=(4,)).astype(np.float32)},
            "col": rng.normal(size=(5, 1)).astype(np.float32),
            "l": [rng.normal(size=(2, 3)).astype(np.float32)]}


OPTIMIZERS = {
    "adamw": lambda m: m.adamw(lr=0.05),
    "adamw_defaults": lambda m: m.adamw(),
    "adafactor": lambda m: m.adafactor(lr=0.1),
    "rowwise_adagrad": lambda m: m.rowwise_adagrad(lr=0.3),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference_over_three_steps(name, rng):
    params = _opt_params(rng)
    if name == "rowwise_adagrad":        # one accumulator per row: 2-D leaves
        params = {"a": params["m"]["w"], "b": params["col"],
                  "c": params["l"][0]}
    j_init, j_update = OPTIMIZERS[name](jax_opt)
    t_init, t_update = OPTIMIZERS[name](optimizer)
    jp, tp = _to_jax(params), params_from_numpy(params, "cpu")
    js, ts = j_init(jp), t_init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                         params)
        jp, js = j_update(_to_jax(g), js, jp)
        tp, ts = t_update(params_from_numpy(g, "cpu"), ts, tp)
    _assert_trees_close(tp, jp, TOL_OPT)
    _assert_trees_close(ts.inner, js.inner, TOL_OPT)
    assert int(ts.step) == int(js.step) == 3
    assert ts.step.dtype == torch.int32


def test_adafactor_updates_a_large_stack_slice_by_slice(rng, monkeypatch):
    """Above the element threshold (the reference's 2^27, lowered here to
    reach the path at a small size) a factored stack is updated one
    leading slice at a time (the reference's ``lax.map``): each slice as
    its own leaf, its RMS clip its own."""
    p = rng.normal(size=(4, 16, 8)).astype(np.float32)
    g = (rng.normal(size=(4, 16, 8)) * 10).astype(np.float32)
    monkeypatch.setattr(optimizer, "ADAFACTOR_CHUNK_ELEMS", 100)
    t_init, t_update = optimizer.adafactor(lr=0.1)
    tp = params_from_numpy({"w": p}, "cpu")
    new, state = t_update(params_from_numpy({"w": g}, "cpu"), t_init(tp), tp)
    j_init, j_update = jax_opt.adafactor(lr=0.1)
    slices = {f"s{i}": jnp.asarray(p[i]) for i in range(4)}
    want, want_s = j_update({f"s{i}": jnp.asarray(g[i]) for i in range(4)},
                            j_init(slices), slices)
    np.testing.assert_allclose(new["w"].numpy(),
                               np.stack([want[f"s{i}"] for i in range(4)]),
                               **TOL_OPT)
    for k in ("vr", "vc"):
        np.testing.assert_allclose(
            state.inner["w"][k].numpy(),
            np.stack([want_s.inner[f"s{i}"][k] for i in range(4)]), **TOL_OPT)
    # the whole-leaf path clips once over the stack: another result
    monkeypatch.setattr(optimizer, "ADAFACTOR_CHUNK_ELEMS", 1 << 27)
    whole, _ = t_update(params_from_numpy({"w": g}, "cpu"), t_init(tp), tp)
    assert not torch.allclose(whole["w"], new["w"])


def test_combined_routes_tables_to_rowwise_adagrad(rng):
    """``for_family("recsys")``: tables by rowwise Adagrad (one float32
    accumulator per row), the rest by AdamW; rows without a gradient keep
    their bits; both match the reference over 3 steps."""
    params = {"tables": {"a": rng.normal(size=(12, 4)).astype(np.float32),
                         "b": rng.normal(size=(6, 4)).astype(np.float32)},
              "mlp": [{"w": rng.normal(size=(4, 3)).astype(np.float32),
                       "b": np.zeros(3, np.float32)}]}
    j_init, j_update = jax_opt.for_family("recsys")
    t_init, t_update = optimizer.for_family("recsys")
    jp, tp = _to_jax(params), params_from_numpy(params, "cpu")
    js, ts = j_init(jp), t_init(tp)
    untouched = {"a": [0, 3, 11], "b": [5]}
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                         params)
        for name, rows in untouched.items():
            g["tables"][name][rows] = 0.0
        jp, js = j_update(_to_jax(g), js, jp)
        tp, ts = t_update(params_from_numpy(g, "cpu"), ts, tp)
    _assert_trees_close(tp, jp, TOL_OPT)
    _assert_trees_close(ts.inner, js.inner, TOL_OPT)
    assert ts.inner["tables"].inner["tables"]["a"].shape == (12,)
    assert int(ts.step) == int(js.step) == 3
    for name, rows in untouched.items():
        old = params["tables"][name][rows]
        assert np.array_equal(tp["tables"][name][rows].numpy().view(np.uint32),
                              old.view(np.uint32))
        assert np.array_equal(np.asarray(jp["tables"][name])[rows], old)


@pytest.mark.parametrize("size,want", [(0, "adamw"), (10**9, "adamw"),
                                       (10**9 + 1, "adafactor")])
def test_for_family_picks_the_reference_optimizer(size, want, rng):
    """The LM optimizer by parameter count, as the reference picks it (the
    state's layout tells AdamW's m / v from Adafactor's factors)."""
    p = {"w": torch.zeros(4, 3)}
    state = optimizer.for_family("lm", size)[0](p)
    got = "adamw" if "m" in state.inner else "adafactor"
    ref = jax_opt.for_family("lm", size)[0]({"w": jnp.zeros((4, 3))})
    assert got == want == ("adamw" if "m" in ref.inner else "adafactor")


# -------------------------------------------------------------- train step

def _linear_problem(rng):
    params = {"w": rng.normal(size=(8, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    batch = {"x": rng.normal(size=(16, 8)).astype(np.float32),
             "y": rng.normal(size=(16, 3)).astype(np.float32)}

    def jax_loss(p, b):
        return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    def port_loss(p, b):
        return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)
    return params, batch, jax_loss, port_loss


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(n_micro, rng):
    """Two steps of AdamW through each package's ``build_train_step``: the
    gradient accumulated over micro-batches in the param dtype, then
    divided, the loss the micro-batches' mean."""
    params, batch, jax_loss, port_loss = _linear_problem(rng)
    j_step, j_init = jax_build_train_step(jax_loss, jax_opt.adamw(lr=0.05),
                                          n_micro=n_micro)
    t_step, t_init = build_train_step(port_loss, optimizer.adamw(lr=0.05),
                                      n_micro=n_micro)
    jp, tp = _to_jax(params), params_from_numpy(params, "cpu")
    js, ts = j_init(jp), t_init(tp)
    jb, tb = _to_jax(batch), params_from_numpy(batch, "cpu")
    for _ in range(2):
        jp, js, jl = j_step(jp, js, jb)
        tp, ts, tl = t_step(tp, ts, tb)
        assert tl.dtype == torch.float32 and tl.dim() == 0
        np.testing.assert_allclose(float(tl), float(jl), **TOL_OPT)
    _assert_trees_close(tp, jp, TOL_OPT)
    _assert_trees_close(ts.inner, js.inner, TOL_OPT)
    assert all(not t.requires_grad for t in tree_lib.leaves(tp))


# ------------------------------------------------- recsys loss gradients

RECSYS = {"din": (jax_din, din), "dien": (jax_dien, dien),
          "mind": (jax_mind, mind),
          "two-tower-retrieval": (jax_towers, towers)}


@pytest.fixture(scope="module", params=sorted(RECSYS))
def recsys_model(request):
    cfg = _reduced(request.param)
    jmod, tmod = RECSYS[request.param]
    ref = jmod.init(jax.random.PRNGKey(0), cfg)
    return cfg, jmod, tmod, ref


def test_recsys_loss_and_gradient_match_reference(recsys_model, rng):
    """``jax.value_and_grad`` of the reference's loss_fn against the port's
    loss and ``torch.autograd`` gradient, every parameter leaf (tables,
    which take dense scatter-add gradients, included), at 2e-5 with the
    absolute part scaled to leaves whose entries exceed 1
    (``_assert_trees_close``)."""
    cfg, jmod, tmod, ref = recsys_model
    batch = synthetic.recsys_batch(rng, cfg, 16)
    lj, gj = jax.value_and_grad(jmod.loss_fn)(ref, _to_jax(batch), cfg)
    port = params_from_numpy(_np(ref), "cpu")
    lt, gt = value_and_grad(lambda p, b: tmod.loss_fn(p, b, cfg), port,
                            _to_torch(batch))
    np.testing.assert_allclose(float(lt), float(lj), **TOL)
    _assert_trees_close(gt, gj, TOL, leaf_scale=True)
    assert any(float(np.abs(np.asarray(g)).max()) > 0
               for g in jax.tree.leaves(gj["tables"]))


def test_din_history_padding_sends_no_gradient_to_row_zero(rng):
    """Padding (-1) is read as row 0 and masked after: row 0 of item_id
    gets a gradient only from real ids, exactly 0 when none reads it."""
    cfg = _reduced("din")
    ref = jax_din.init(jax.random.PRNGKey(0), cfg)
    batch = synthetic.recsys_batch(rng, cfg, 8)
    hist, item = batch["user"]["hist"], batch["item"]["item_id"]
    hist[hist == 0] = 1
    item[item == 0] = 1
    hist[:, cfg.seq_len // 2:] = -1
    port = params_from_numpy(_np(ref), "cpu")
    _, g = value_and_grad(lambda p, b: din.loss_fn(p, b, cfg), port,
                          _to_torch(batch))
    assert float(g["tables"]["item_id"][0].abs().max()) == 0.0
    _, gj = jax.value_and_grad(jax_din.loss_fn)(ref, _to_jax(batch), cfg)
    assert float(np.abs(np.asarray(gj["tables"]["item_id"][0])).max()) == 0.0


# ----------------------------------------------------- LM loss gradients

@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_gradient_match_reference(arch, remat):
    """``lm_loss`` and its gradient for each reduced LM arch (deepseek-v3
    with its MTP head; the deepseeks with the MoE aux term), through both
    the plain stack and the rematerialized one (``cfg.remat``), over two
    attention chunks (S=40, chunk 32)."""
    cfg = dataclasses.replace(_reduced(arch), remat=remat)
    ref = jax_tf.init(jax.random.PRNGKey(0), cfg)
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)).astype(
        np.int32)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p, t: jax_tf.lm_loss(p, t, cfg)))(ref, jnp.asarray(tok))
    port = params_from_numpy(_np(ref), "cpu")
    lt, gt = value_and_grad(lambda p, t: transformer.lm_loss(p, t, cfg), port,
                            torch.as_tensor(tok))
    np.testing.assert_allclose(float(lt), float(lj), **TOL_LM)
    _assert_trees_close(gt, gj, TOL_LM)
    if cfg.mtp:
        assert float(np.abs(np.asarray(gj["mtp"]["proj"])).max()) > 0
        assert float(gt["mtp"]["proj"].abs().max()) > 0


def test_moe_aux_term_enters_the_loss():
    """The MoE load-balance aux (x aux_weight) moves the loss as in the
    reference: the two weights' losses differ by the same amount."""
    cfg = _reduced("deepseek-v2-lite-16b")
    ref = jax_tf.init(jax.random.PRNGKey(0), cfg)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 24)).astype(
        np.int32)
    port = params_from_numpy(_np(ref), "cpu")
    d_ref = float(jax_tf.lm_loss(ref, jnp.asarray(tok), cfg, aux_weight=1.0)
                  - jax_tf.lm_loss(ref, jnp.asarray(tok), cfg, aux_weight=0.0))
    t = torch.as_tensor(tok)
    d_port = float(transformer.lm_loss(port, t, cfg, aux_weight=1.0)
                   - transformer.lm_loss(port, t, cfg, aux_weight=0.0))
    assert d_ref > 0
    np.testing.assert_allclose(d_port, d_ref, **TOL_LM)


# ------------------------------------------------------------ checkpoints

def _ckpt_tree(rng):
    """Insertion order unlike the sorted one, lists, an int leaf, a 0-d
    step and a bfloat16 leaf."""
    bf = rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
    return {"zeta": rng.normal(size=(4, 3)).astype(np.float32),
            "alpha": {"w": [rng.normal(size=(2,)).astype(np.float32),
                            rng.normal(size=(3, 2)).astype(np.float32)],
                      "ids": np.arange(7, dtype=np.int32)},
            "mid": {"bf": bf, "step": np.asarray(5, np.int32)}}


def _port_tree(tree):
    return params_from_numpy(tree, "cpu")


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    return m["step"], m["meta"], m["leaves"]


def test_checkpoint_written_by_reference_restores_in_port(tmp_path, rng):
    tree = _ckpt_tree(rng)
    p = str(tmp_path / "ref")
    jax_ckpt.save(p, _to_jax_keep(tree), step=11, meta={"k": 1})
    got, step = checkpoint.restore(p, _port_tree(tree))
    assert step == 11
    _bitwise_equal(got, tree)
    assert got["mid"]["bf"].dtype == torch.bfloat16
    assert got["alpha"]["ids"].dtype == torch.int32


def _to_jax_keep(tree):
    """The numpy tree as JAX arrays of the same dtypes (bfloat16 kept)."""
    return jax.tree.map(jnp.asarray, tree)


def _bitwise_equal(got, tree):
    g = params_to_numpy(got)
    for (path, a), (_, b) in zip(tree_lib.flatten_with_paths(g),
                                 tree_lib.flatten_with_paths(tree)):
        b = np.asarray(b)
        b = b.view(np.uint16) if b.dtype.name == "bfloat16" else b
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_checkpoint_written_by_port_equals_the_reference_file_by_file(
        tmp_path, rng):
    """The port's checkpoint of a tree has the reference's manifest (names
    in JAX's order, files, shapes, dtypes, crc32) and its files byte for
    byte, the bfloat16 leaf's ``<V2`` payload included; the reference
    restores its float and int leaves bit for bit (it refuses bfloat16
    leaves in any checkpoint, its own too: numpy loads ``<V2`` as void)."""
    tree = _ckpt_tree(rng)
    p_ref, p_port = str(tmp_path / "ref"), str(tmp_path / "port")
    jax_ckpt.save(p_ref, _to_jax_keep(tree), step=3, meta={"a": "b"})
    checkpoint.save(p_port, _port_tree(tree), step=3, meta={"a": "b"})
    assert _manifest(p_port) == _manifest(p_ref)
    assert checkpoint.tree_paths(_port_tree(tree)) == \
        jax_ckpt.tree_paths(_to_jax_keep(tree))
    assert sorted(os.listdir(p_port)) == sorted(os.listdir(p_ref))
    for name in os.listdir(p_ref):
        if name.endswith(".npy"):
            with open(os.path.join(p_ref, name), "rb") as a, \
                    open(os.path.join(p_port, name), "rb") as b:
                assert a.read() == b.read(), name
    no_bf = dict(tree)
    no_bf["mid"] = {"step": tree["mid"]["step"]}
    p2 = str(tmp_path / "port2")
    checkpoint.save(p2, _port_tree(no_bf), step=4)
    got, step = jax_ckpt.restore(p2, _to_jax_keep(no_bf))
    assert step == 4
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), got, _to_jax_keep(no_bf))
    with pytest.raises(TypeError):
        jax_ckpt.restore(p_ref, _to_jax_keep(tree))


def test_checkpoint_checksum_and_completeness(tmp_path, rng):
    tree = _port_tree(_ckpt_tree(rng))
    p = str(tmp_path / "ck")
    checkpoint.save(p, tree, step=1)
    got, _ = checkpoint.restore(p, tree)
    _bitwise_equal(got, params_to_numpy(tree))
    # specs with no mesh installed: the one-device restore, whole leaves
    from repro_torch.launch.sharding import P
    got, _ = checkpoint.restore(p, tree, shardings=tree_lib.tree_map(
        lambda t: P(*(None,) * t.dim()), tree))
    _bitwise_equal(got, params_to_numpy(tree))
    fn = os.path.join(p, "leaf_00000.npy")
    arr = np.load(fn)
    arr.flat[0] += 1
    np.save(fn, arr)
    with pytest.raises(IOError, match="checksum"):
        checkpoint.restore(p, tree)
    os.remove(os.path.join(p, "DONE"))
    with pytest.raises(FileNotFoundError, match="DONE"):
        checkpoint.restore(p, tree)


def test_async_checkpointer_keeps_the_newest_and_finds_latest(tmp_path):
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = {"w": torch.ones(4)}
    for step in (1, 2, 3):
        ck.save({"w": tree["w"] * step}, step, block=True)
    assert sorted(os.listdir(tmp_path)) == ["gen_2", "gen_3"]
    assert ck.latest().endswith("gen_3") and ck.saved_steps == [1, 2, 3]
    got, step = checkpoint.restore(ck.latest(), tree)
    assert step == 3 and torch.equal(got["w"], torch.full((4,), 3.0))
    # a generation without DONE is not the latest
    os.makedirs(tmp_path / "gen_9")
    assert ck.latest().endswith("gen_3")
    # the snapshot is taken at save(): later writes to the tensor miss it
    w = torch.zeros(2)
    ck.save({"w": w}, 5)
    w += 7
    ck.wait()
    assert torch.equal(checkpoint.restore(ck.latest(), {"w": w})[0]["w"],
                       torch.zeros(2))


def test_checkpoint_diff_emitter_reads_port_checkpoints(tmp_path, rng):
    """One DIN train step on the CPU, checkpointed by the port before and
    after: the delta log's emitter (the port's and the reference's, which
    read only the manifest) upserts exactly the table rows whose gradient
    was non-zero, with the new rows."""
    cfg = _reduced("din")
    ref = jax_din.init(jax.random.PRNGKey(0), cfg)
    params = params_from_numpy(_np(ref), "cpu")
    batch = _to_torch(synthetic.recsys_batch(rng, cfg, 16))
    loss = (lambda p, b: din.loss_fn(p, b, cfg))
    _, grads = value_and_grad(loss, params, batch)
    step, init = build_train_step(loss, optimizer.for_family("recsys"))
    new, _, _ = step(params, init(params), batch)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    checkpoint.save(a, params, step=0)
    checkpoint.save(b, new, step=1)
    names = {"tables/item_id": 0, "tables/user_id": 1}
    got = CheckpointDiffEmitter(str(tmp_path / "log"), names).diff(a, b)
    want = JaxDiffEmitter(str(tmp_path / "log2"), names).diff(a, b)
    assert [(d.group, d.ids.tolist()) for d in got] == \
        [(d.group, d.ids.tolist()) for d in want]
    for d, name in zip(got, sorted(names, key=names.get)):
        g = grads["tables"][name.split("/")[1]]
        assert d.ids.tolist() == torch.nonzero(
            g.abs().sum(1)).flatten().tolist()
        np.testing.assert_array_equal(d.rows, new["tables"][
            name.split("/")[1]][torch.as_tensor(d.ids)].numpy())
        assert d.delete_ids.size == 0


# ---------------------------------------------------------------- launcher

def _train_args(ckpt_dir, steps, every=2):
    return argparse.Namespace(arch="smollm-135m", shape="train_4k",
                              steps=steps, mesh=None, multi_pod=False,
                              reduced=True, ckpt_dir=str(ckpt_dir),
                              ckpt_every=every, batch=None, n_micro=None)


def test_train_launcher_runs_and_resumes_on_the_cpu(tmp_path):
    """``train`` at ``--reduced`` for 3 steps, then a second run resumes
    from the newest generation: its parameters equal the first run's final
    ones bit for bit and its steps continue; the first step's loss is the
    reference's ``lm_loss`` on the same weights and the pipeline's first
    batch (the reference draws the same batches from the same seed)."""
    cfg = _reduced("smollm-135m")
    ref = jax_tf.init(jax.random.PRNGKey(0), cfg)
    fig = train(_train_args(tmp_path, 3), device="cpu",
                params=params_from_numpy(_np(ref), "cpu"))
    assert fig["start_step"] == 0 and fig["end_step"] == 3
    assert len(fig["losses"]) == 3 and all(np.isfinite(fig["losses"]))
    assert fig["restored"] is None and fig["batch"] == 8 and fig["seq"] == 64
    assert sorted(os.listdir(tmp_path)) == ["gen_2", "gen_3"]
    assert fig["latest"].endswith("gen_3")
    first = synthetic.lm_batch(np.random.default_rng(0), cfg, 8, 64)
    want = jax_tf.lm_loss(ref, jnp.asarray(first["tokens"]), cfg)
    np.testing.assert_allclose(fig["losses"][0], float(want), **TOL_LM)

    again = train(_train_args(tmp_path, 2), device="cpu")
    assert again["start_step"] == 3 and again["end_step"] == 5
    _bitwise_equal(again["restored"], params_to_numpy(fig["params"]))
    assert again["latest"].endswith("gen_5")
    assert sorted(os.listdir(tmp_path)) == ["gen_3", "gen_4", "gen_5"]
