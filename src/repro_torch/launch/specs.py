"""Cell builder: (arch × shape × mesh) → step fn + abstract inputs +
shardings + analytic MODEL_FLOPS. The cell run (``launch/dryrun.py``), the
op counter and the roofline consume Cells.

The counterpart of the reference's ``launch/specs.py``. Every cell carries
``in_specs`` / ``out_specs`` from ``launch/sharding.py`` for its mesh (an
abstract (1, 1) mesh when none is given), as the reference's Cell does,
and ``meta["model_bytes_per_device"]`` divided by the mesh's size.
Abstract arguments are tensors on torch's ``meta`` device (nothing is
allocated); :meth:`Cell.materialize` draws real ones on a device:
parameters from the port's ``init``s with an explicit generator, token
ids, recsys ids by the port's copy of ``data/synthetic.py``, graphs by
``synthetic.molecule_batch`` / ``random_graph`` or
``sampler.sample_fanout``. Given a live mesh it draws the rank's part of
the same values: the recsys cells' tables as this rank's rows only
(``tables_init``), the batch whole and then its ``local_part``; the LM
cells' parameters and decode cache part by part and layer by layer, each
part from its own seeded generator (``transformer.init``,
:func:`draw_lm_cache`), keeping the rank's slice of each layer (a
``fsdp_params`` training cell's: its ZeRO-3 blocks); an
LM training cell's optimizer state as the rank's ZeRO-2 shards (its step
is ``build_train_step(..., grad_shardings=zero_specs)``; the recsys and
GNN steps, as the reference's, have no ZeRO split); a GNN cell's
parameters and graph whole (its forward splits the edges). The ``meta`` dict carries the reference's
keys and formulas.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import default_device, runtime
from repro_torch import tree as tree_lib
from repro_torch.configs import registry
from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig, ShapeSpec
from repro_torch.data import sampler, synthetic
from repro_torch.launch import sharding as shr
from repro_torch.launch.mesh import abstract_mesh, dry_mesh
from repro_torch.launch.sharding import P
from repro_torch.models import schnet, transformer
from repro_torch.models.recsys import dien, din, mind, towers
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_step import build_train_step

REC_MODULES = {"two_tower": towers, "mind": mind, "din": din, "dien": dien}
META = torch.device("meta")
#: the reference pads graph edge lists to a multiple of this (its
#: multi-pod mesh size); sentinel edges (src = dst = N) fill the tail
EDGE_PAD = 512


@dataclass
class Cell:
    arch_id: str
    shape_name: str
    fn: Callable                    # positional args match .args
    args: tuple                     # trees of tensors on the meta device
    draw: Callable                  # (device, generator, rng) → real args
    carry: int = 0                  # leading outputs fed back as leading args
    meta: dict = field(default_factory=dict)
    device: Any = None              # where materialize() draws by default
    in_specs: tuple = ()            # trees of sharding.P, like .args
    out_specs: Any = None
    mesh: Any = None                # the mesh the specs are for
    #: (device, generator, rng, live mesh) → the rank's part of the args
    #: (drawn inside the installed mesh: a train step's ``opt_init``
    #: draws the rank's ZeRO shards)
    draw_local: Optional[Callable] = None
    #: the layout the rank's arguments take on a live mesh, where it is
    #: not ``in_specs`` (the retrieval cells: the port's ranking calls
    #: take their candidates whole on every rank)
    local_specs: Optional[tuple] = None
    #: the leading outputs a mesh run gathers whole and returns (None:
    #: all): an LM cell's logits, not the cache its ranks hold in part
    mesh_outputs: Optional[int] = None
    #: a train step's optimizer init: (the rank's params) → its state,
    #: called inside the installed mesh (ZeRO-2 shards), as a live rank's
    #: ``draw_local`` calls it; the state's specs infer a layout by
    #: shape, as the reference's, which the port's ranks do not hold
    init_local: Optional[Callable] = None

    def materialize(self, device=None, generator: Optional[torch.Generator]
                    = None, mesh=None) -> tuple:
        """Real arguments on ``device`` (the cell's, else ``cuda``):
        parameters drawn from ``generator`` (a generator on that device;
        seed 0 if None), ids and graphs from a numpy generator seeded by
        its initial seed. With a live ``mesh``, this rank's part of the
        same values."""
        dev = default_device(device if device is not None else self.device)
        g = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        rng = np.random.default_rng(g.initial_seed())
        if mesh is None:
            return self.draw(dev, g, rng)
        return self.draw_local(dev, g, rng, mesh)

    def next_args(self, args: tuple, out) -> tuple:
        """The arguments of the next call after ``fn(*args)`` gave ``out``:
        a train step's new params and optimizer state replace the old."""
        return tuple(out[:self.carry]) + tuple(args[self.carry:])

    def local_args(self, mesh) -> tuple:
        """The rank's part of ``args`` on ``mesh`` (dry or live), on
        ``meta`` and drawn from nothing: each argument by its spec
        (``local_specs``, else ``in_specs``), a :class:`~sharding.Table`
        leaf as a ``RowShard`` (``shard_params``), every other leaf its
        ``local_part``, contiguous as a drawn part is; a train step's
        optimizer state by ``init_local`` on the rank's params. The
        layout :meth:`materialize` draws on a live mesh."""
        def contiguous(t):
            return t.contiguous() if isinstance(t, torch.Tensor) else t
        state = 1 if self.carry and self.init_local is not None else None
        parts = [None if i == state else tree_lib.tree_map(
                     contiguous, shr.shard_params(a, sp, mesh))
                 for i, (a, sp) in enumerate(zip(
                     self.args, self.local_specs or self.in_specs))]
        if state is not None:
            with runtime.use_mesh(mesh):
                parts[state] = self.init_local(parts[0])
        return tuple(parts)

    def arg_bytes(self) -> int:
        return tree_bytes(self.args)

    def arg_bytes_per_device(self) -> int:
        """The argument bytes one rank of the cell's mesh holds: those
        of :meth:`local_args` for rank 0 (every rank holds as many: a
        split dim must divide)."""
        return tree_bytes(self.local_args(
            dry_mesh(self.mesh.dims, self.mesh.axis_names, 0)))


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors (a ``RowShard``'s local rows)."""
    return int(sum(t.numel() * t.element_size()
                   for t in tree_lib.leaves(tree)
                   if isinstance(t, torch.Tensor)))


def _mesh(mesh):
    """The cell's mesh: an abstract (1, 1) one when none is given."""
    return abstract_mesh((1, 1), ("data", "model")) if mesh is None else mesh


def n_params(params) -> int:
    return int(sum(t.numel() for t in tree_lib.leaves(params)))


def _tensors(tree, dev):
    """numpy leaves → tensors on ``dev``: floats as they are, ids as int64
    (the port's index type)."""
    if isinstance(tree, dict):
        return {k: _tensors(v, dev) for k, v in tree.items()}
    t = torch.as_tensor(np.asarray(tree))
    return (t if t.is_floating_point() else t.long()).to(dev)


def _ids(*shape):
    return torch.empty(shape, dtype=torch.int64, device=META)


def _f32(*shape):
    return torch.empty(shape, dtype=torch.float32, device=META)


# ------------------------------------------------------------------ LM

def _lm_micro(cfg: LMConfig, batch: int, mesh) -> int:
    """Grad-accum microbatches: hold ~1-4 sequences per data shard."""
    per_shard = {"deepseek-v3-671b": 1, "qwen3-8b": 2, "starcoder2-7b": 2,
                 "deepseek-v2-lite-16b": 4, "smollm-135m": 2}.get(cfg.name, 2)
    ds = shr.data_size(mesh)
    n = max(1, batch // (per_shard * ds))
    while batch % n or (batch // n) % ds:
        n -= 1
    return max(1, n)


def lm_model_flops(cfg: LMConfig, shape: ShapeSpec) -> float:
    n_active = cfg.active_param_count()
    d = shape.dims
    if shape.kind == "train":
        return 6.0 * n_active * d["seq_len"] * d["global_batch"]
    if shape.kind == "prefill":
        return 2.0 * n_active * d["seq_len"] * d["global_batch"]
    return 2.0 * n_active * d["global_batch"]       # decode: 1 token/seq


def lm_model_bytes(cfg: LMConfig, shape: ShapeSpec, n_dev: int = 1) -> float:
    """Analytic minimum HBM traffic per device per step (roofline floor):
    weights read once + KV cache read (decode) / activations (train)."""
    d = shape.dims
    B, S = d["global_batch"], d["seq_len"]
    bpp = 2 if cfg.param_dtype == "bfloat16" else 4
    w = cfg.active_param_count() * bpp
    if cfg.mla:
        per_tok = (cfg.mla.kv_lora + cfg.mla.d_rope) * bpp * cfg.n_layers
    else:
        per_tok = 2 * cfg.n_kv * cfg.d_head * bpp * cfg.n_layers
    if shape.kind in ("decode", "decode_long"):
        return (w + B * S * per_tok) / n_dev
    if shape.kind == "prefill":
        return (w + 3 * B * S * cfg.d_model * bpp * cfg.n_layers) / n_dev
    # train: params+grads+opt traffic (~3 weight passes) + layer activations
    return (3 * w * 3 + 4 * B * S * cfg.d_model * bpp * cfg.n_layers) / n_dev


def draw_lm_cache(seed: int, cfg: LMConfig, batch: int, smax: int, device,
                  mesh=None, specs=None) -> "transformer.KVCache":
    """A decode cell's cache, N(0, 1) in the parameters' dtype: each layer
    of each stack (a, b) from its own generator
    (``transformer.part_generator``), so that on a live ``mesh`` a rank
    draws one layer at a time and keeps its part by ``specs`` (the
    cache's ``kv_cache_specs``), the same values as drawn whole. The
    length is smax - 1."""
    whole = transformer.KVCache.zeros(cfg, batch, smax, device=META)
    stacks = {}
    for name in ("a", "b"):
        t = getattr(whole, name)

        def draw(i, name=name, t=t):
            layer = torch.empty(t.shape[1:], dtype=t.dtype, device=device)
            layer.normal_(generator=transformer.part_generator(
                seed, "cache", name, i, device=device))
            if mesh is None:
                return layer
            return shr.local_part(layer, P(*getattr(specs, name)[1:]), mesh)
        stacks[name] = transformer.stack_layers(draw, cfg.n_layers)
    return transformer.KVCache(
        a=stacks["a"], b=stacks["b"],
        length=torch.full((), smax - 1, dtype=torch.int32, device=device))


def build_lm_cell(arch, shape: ShapeSpec, device=None, mesh=None) -> Cell:
    mesh = _mesh(mesh)
    cfg: LMConfig = arch.config
    dims = shape.dims
    B, S = dims["global_batch"], dims["seq_len"]
    params = transformer.init(torch.Generator(), cfg, device=META)
    pspecs = shr.param_specs(params, cfg, mesh)
    meta = {"model_flops": lm_model_flops(cfg, shape),
            "model_bytes_per_device": lm_model_bytes(cfg, shape, mesh.size),
            "param_dtype": cfg.param_dtype,
            "params": cfg.param_count(), "active_params": cfg.active_param_count()}

    def draw_params(dev, g, live=None, specs=None):
        return transformer.init(g, cfg, dev, mesh=live, specs=specs)

    def draw_tokens(rng, dev, seq):
        return _tensors(synthetic.lm_batch(rng, cfg, B, seq)["tokens"], dev)

    # a batch that does not split over the data axes is held whole by
    # every rank (the serving calls' batch_axes=())
    batch_axes = None if shr.batched_spec(mesh, (B,))[0] is not None else ()

    if shape.kind == "train":
        n_micro = _lm_micro(cfg, B, mesh)
        # ZeRO-2: grad accumulator + optimizer state pick up an extra
        # `data` sharding; updated params all-gather back to the compute
        # sharding. ZeRO-3 (fsdp_params): the params themselves stay
        # data-sharded, each a DataShard the model gathers on use, and
        # their gradients arrive reduce-scattered by those gathers
        zspecs = shr.zero_specs(params, pspecs, mesh)
        if getattr(cfg, "fsdp_params", False):
            pspecs = shr.zero_specs(params, pspecs, mesh, gathered=True)
        step, opt_init = build_train_step(
            lambda p, toks: transformer.lm_loss(p, toks, cfg),
            opt_lib.for_family("lm", cfg.param_count()), n_micro=n_micro,
            grad_shardings=zspecs, param_specs=pspecs)
        meta["n_micro"] = n_micro
        tspec = shr.batched_spec(mesh, (B, S))
        opt_state = opt_init(params)
        ospecs = shr.opt_state_specs(opt_state, params, zspecs)

        def draw(dev, g, rng):
            p = draw_params(dev, g)
            return p, opt_init(p), draw_tokens(rng, dev, S)

        def draw_local(dev, g, rng, live):
            p = draw_params(dev, g, live, pspecs)
            return (p, opt_init(p),
                    shr.local_part(draw_tokens(rng, dev, S), tspec, live))
        return Cell(arch.arch_id, shape.name, step,
                    (params, opt_state, _ids(B, S)), draw, carry=2,
                    meta=meta, device=device,
                    in_specs=(pspecs, ospecs, tspec),
                    out_specs=(pspecs, ospecs, P()), mesh=mesh,
                    draw_local=draw_local, init_local=opt_init)

    # the serving cells: parameters (and a decode cache) drawn part by
    # part and layer by layer, whole or, on a live mesh, the rank's slice
    # of the same values; a mesh run returns the logits gathered, not the
    # cache
    logits_spec = shr.batched_spec(mesh, (B, cfg.vocab))
    ca, cb, cl = shr.kv_cache_specs(cfg, B, mesh)
    cache_specs = transformer.KVCache(a=ca, b=cb, length=cl)
    tok_spec = shr.batched_spec(mesh, (B, S if shape.kind == "prefill" else 1))

    if shape.kind == "prefill":
        def draw(dev, g, rng, live=None):
            toks = draw_tokens(rng, dev, S)
            return (draw_params(dev, g, live),
                    toks if live is None else shr.local_part(toks, tok_spec,
                                                             live))
        return Cell(arch.arch_id, shape.name,
                    lambda p, toks: transformer.prefill(
                        p, toks, cfg, smax=S, batch_axes=batch_axes),
                    (params, _ids(B, S)), draw, meta=meta, device=device,
                    in_specs=(pspecs, tok_spec),
                    out_specs=(logits_spec, cache_specs), mesh=mesh,
                    draw_local=draw, mesh_outputs=1)

    # decode / decode_long: one new token against a seq_len KV cache whose
    # valid prefix is S - 1, so the step reads (and writes) all S rows;
    # the step's cache is not fed back (the next call repeats the step)
    def decode_fn(p, c, toks):
        return transformer.decode_step(p, c, toks, cfg, batch_axes=batch_axes)

    def draw(dev, g, rng, live=None):
        toks = draw_tokens(rng, dev, 1)
        cache = draw_lm_cache(g.initial_seed(), cfg, B, S, dev, live,
                              cache_specs)
        return (draw_params(dev, g, live), cache,
                toks if live is None else shr.local_part(toks, tok_spec, live))
    return Cell(arch.arch_id, shape.name, decode_fn,
                (params, transformer.KVCache.zeros(cfg, B, S, device=META),
                 _ids(B, 1)), draw, meta=meta, device=device,
                in_specs=(pspecs, cache_specs, tok_spec),
                out_specs=(logits_spec, cache_specs), mesh=mesh,
                draw_local=draw, mesh_outputs=1)


# ------------------------------------------------------------------ GNN

def gnn_model_flops(cfg: GNNConfig, n_nodes: int, n_edges: int, d_in: int,
                    train: bool = True) -> float:
    h, r = cfg.d_hidden, cfg.n_rbf
    per_edge = 2 * (r * h + h * h) + 2 * h
    per_node = 2 * (2 * h * h)
    fwd = cfg.n_interactions * (n_edges * per_edge + n_nodes * per_node) \
        + 2 * n_nodes * d_in * h
    return (3.0 if train else 1.0) * fwd


def _pad_edges(edges: np.ndarray, dist: np.ndarray, n_nodes: int, E: int):
    """Edge list and distances padded to E rows with sentinel edges."""
    pad = E - len(edges)
    edges = np.concatenate([edges, np.full((pad, 2), n_nodes)]).astype(np.int32)
    dist = np.concatenate([dist, np.zeros(pad)]).astype(np.float32)
    return edges, dist


def build_gnn_cell(arch, shape: ShapeSpec, device=None, mesh=None) -> Cell:
    mesh = _mesh(mesh)
    cfg: GNNConfig = arch.config
    d = shape.dims
    if shape.kind == "graph_batched":
        N = d["batch"] * d["n_nodes"]
        E = d["batch"] * d["n_edges"]
        n_graphs = d["batch"]
        inputs = {"atom_z": _ids(N), "positions": _f32(N, 3),
                  "edges": _ids(E, 2), "edge_dist": _f32(E),
                  "graph_ids": _ids(N)}
        targets = _f32(d["batch"])
        d_feat_in, d_in = None, cfg.d_hidden

        def draw_batch(rng):
            mol = synthetic.molecule_batch(rng, cfg, d["batch"], d["n_nodes"],
                                           d["n_edges"])
            return ({"atom_z": mol["atom_z"], "positions": mol["positions"],
                     "edges": mol["edges"],
                     "edge_dist": rng.uniform(0.5, 9.5, E).astype(np.float32),
                     "graph_ids": mol["graph_ids"]}, mol["targets"])
    else:
        if shape.kind == "graph_mini":
            f1, f2 = d["fanout"]
            bn = d["batch_nodes"]
            N = bn + bn * f1 + bn * f1 * f2
            E = bn * f1 + bn * f1 * f2
        else:
            N, E = d["n_nodes"], d["n_edges"]
        E = -(-E // EDGE_PAD) * EDGE_PAD
        inputs = {"node_feat": _f32(N, d["d_feat"]), "edges": _ids(E, 2),
                  "edge_dist": _f32(E), "graph_ids": _ids(N)}
        n_graphs = 1
        targets = _f32(1)
        d_feat_in = d_in = d["d_feat"]

        def draw_batch(rng):
            if shape.kind == "graph_mini":
                graph = sampler.CSRGraph.random(
                    rng, d["n_nodes"], round(d["n_edges"] / d["n_nodes"]))
                seeds = rng.integers(0, d["n_nodes"], d["batch_nodes"])
                _, edges, _ = sampler.sample_fanout(graph, seeds, d["fanout"],
                                                    rng)
                dist = rng.uniform(0.5, 9.5, len(edges))
                feat = rng.normal(0, 1, (N, d["d_feat"])).astype(np.float32)
            else:
                g = synthetic.random_graph(rng, N, d["n_edges"], d["d_feat"])
                edges, dist, feat = g["edges"], g["edge_dist"], g["node_feat"]
            edges, dist = _pad_edges(edges, dist, N, E)
            return ({"node_feat": feat, "edges": edges, "edge_dist": dist,
                     "graph_ids": np.zeros(N, np.int32)},
                    rng.normal(0, 1, 1).astype(np.float32))

    params = schnet.init(torch.Generator(), cfg, d_feat_in, device=META)
    pspecs = shr.param_specs(params, cfg, mesh)
    # the graph is whole on every rank (the forward splits the edges):
    # no gradient is summed over the data axes; no ZeRO split (the
    # reference's GNN step has none)
    step, opt_init = build_train_step(
        lambda p, b: schnet.batch_loss(p, b, cfg, n_graphs=n_graphs),
        opt_lib.adamw(), param_specs=pspecs, batch_axes=())
    opt_state = opt_init(params)
    ospecs = shr.opt_state_specs(opt_state, params, pspecs)
    in_spec = {k: (shr.edge_spec(mesh, v.dim()) if k in ("edges", "edge_dist")
                   else P(*(None,) * v.dim()))
               for k, v in inputs.items()}
    bspec = {"inputs": in_spec, "targets": P(None)}
    meta = {"model_flops": gnn_model_flops(cfg, N, E, d_in),
            "model_bytes_per_device":
                (E * (cfg.n_rbf + 3 * cfg.d_hidden) * 4 * cfg.n_interactions
                 + N * (d_in + 4 * cfg.d_hidden) * 4) / mesh.size,
            "param_dtype": "float32",
            "params": n_params(params)}

    def draw(dev, g, rng, live=None):
        p = schnet.init(g, cfg, d_feat_in, device=dev)
        inputs_np, targets_np = draw_batch(rng)
        batch = {"inputs": _tensors(inputs_np, dev),
                 "targets": _tensors(targets_np, dev)}
        return p, opt_init(p), batch
    # on a live mesh every rank draws the graph whole and the forward
    # takes its block of the edges (``schnet.py``'s mesh sites)
    whole = tree_lib.tree_map(lambda t: P(*(None,) * t.dim()),
                              {"inputs": inputs, "targets": targets})
    return Cell(arch.arch_id, shape.name, step,
                (params, opt_state, {"inputs": inputs, "targets": targets}),
                draw, carry=2, meta=meta, device=device,
                in_specs=(pspecs, ospecs, bspec),
                out_specs=(pspecs, ospecs, P()), mesh=mesh, draw_local=draw,
                local_specs=(pspecs, ospecs, whole), init_local=opt_init)


# --------------------------------------------------------------- recsys

def _rec_batch_abstract(cfg: RecsysConfig, batch: int, with_label=True):
    def fields(fs):
        return {f.name: _ids(batch) if f.bag == 1 else _ids(batch, f.bag)
                for f in fs}
    user = {"fields": fields(cfg.user_fields)}
    if cfg.seq_len:
        user["hist"] = _ids(batch, cfg.seq_len)
    b = {"user": user, "item": fields(cfg.item_fields)}
    if with_label:
        b["label"] = _f32(batch)
    return b


def _rec_batch_specs(batch: dict, mesh):
    """``batched_spec`` of every leaf of a (meta) recsys batch (the
    reference's ``_rec_batch_specs``)."""
    return tree_lib.tree_map(lambda t: shr.batched_spec(mesh, tuple(t.shape)),
                             batch)


def rec_dense_params(params) -> int:
    return int(sum(t.numel() for path, t in tree_lib.flatten_with_paths(params)
                   if "tables" not in path))


def build_rec_cell(arch, shape: ShapeSpec, device=None, mesh=None) -> Cell:
    mesh = _mesh(mesh)
    cfg: RecsysConfig = arch.config
    mod = REC_MODULES[cfg.model]
    params = mod.init(torch.Generator(), cfg, device=META)
    pspecs = shr.param_specs(params, cfg, mesh)
    n_dense = rec_dense_params(params)
    n_table = n_params(params) - n_dense
    d = shape.dims

    n_lookup_rows = sum(f.bag for f in cfg.user_fields + cfg.item_fields) \
        + (cfg.seq_len or 0)

    def rec_bytes(B):
        # embedding rows touched + dense params + activations (fp32)
        return (B * n_lookup_rows * cfg.embed_dim * 4 + n_dense * 4
                + B * n_lookup_rows * cfg.embed_dim * 4) / mesh.size

    def draw_params(dev, g):
        return mod.init(g, cfg, device=dev)

    def local_draw(draw_rest, in_specs):
        """The rank's part: its rows of the tables, the rest whole, then
        its local_part by ``in_specs``."""
        def draw_local(dev, g, rng, live):
            rest = draw_rest(rng, dev)
            return (mod.init(g, cfg, device=dev, mesh=live),
                    *shr.local_tree(rest, in_specs[1:], live))
        return draw_local

    if shape.kind in ("rec_train", "rec_serve"):
        B = d["batch"]
        train = shape.kind == "rec_train"

        def draw_batch(rng, dev):
            b = synthetic.recsys_batch(rng, cfg, B)
            if not train:
                b.pop("label")
            return _tensors(b, dev)
        batch = _rec_batch_abstract(cfg, B, with_label=train)
        bspec = _rec_batch_specs(batch, mesh)
        if train:
            # no ZeRO split (the reference's recsys step has none)
            step, opt_init = build_train_step(
                lambda p, b: mod.loss_fn(p, b, cfg), opt_lib.for_family("recsys"),
                param_specs=pspecs)
            opt_state = opt_init(params)
            meta = {"model_flops": 6.0 * n_dense * B, "params": n_dense + n_table,
                    "model_bytes_per_device": 3 * rec_bytes(B),
                    "param_dtype": "float32", "dense_params": n_dense}

            def draw(dev, g, rng):
                p = draw_params(dev, g)
                return p, opt_init(p), draw_batch(rng, dev)

            def draw_local(dev, g, rng, live):
                p = mod.init(g, cfg, device=dev, mesh=live)
                return (p, opt_init(p),
                        shr.local_tree(draw_batch(rng, dev), bspec, live))
            ospecs = shr.opt_state_specs(opt_state, params, pspecs)
            return Cell(arch.arch_id, shape.name, step,
                        (params, opt_state, batch), draw, carry=2,
                        meta=meta, device=device,
                        in_specs=(pspecs, ospecs, bspec),
                        out_specs=(pspecs, ospecs, P()), mesh=mesh,
                        draw_local=draw_local, init_local=opt_init)
        meta = {"model_flops": 2.0 * n_dense * B, "params": n_dense + n_table,
                "model_bytes_per_device": rec_bytes(B),
                "param_dtype": "float32"}
        in_specs = (pspecs, bspec)
        return Cell(arch.arch_id, shape.name,
                    lambda p, b: mod.serve_scores(p, b, cfg), (params, batch),
                    lambda dev, g, rng: (draw_params(dev, g),
                                         draw_batch(rng, dev)),
                    meta=meta, device=device, in_specs=in_specs,
                    out_specs=shr.batched_spec(mesh, (B,)), mesh=mesh,
                    draw_local=local_draw(
                        lambda rng, dev: (draw_batch(rng, dev),), in_specs))

    # rec_retrieval: 1 query vs n_candidates
    C = d["n_candidates"]
    user = _rec_batch_abstract(cfg, 1, with_label=False)["user"]
    cand = _rec_batch_abstract(cfg, C, with_label=False)["item"]
    uspec = tree_lib.tree_map(lambda t: P(*(None,) * t.dim()), user)
    cspec = _rec_batch_specs(cand, mesh)
    meta = {"model_flops": 2.0 * n_dense * C, "params": n_dense + n_table,
            "model_bytes_per_device": rec_bytes(C), "param_dtype": "float32"}
    if cfg.model == "two_tower":
        def fn(p, u, c):
            return towers.retrieve(p, u["fields"], c, cfg)
    elif cfg.model == "mind":
        def fn(p, u, c):
            return mind.retrieve(p, u, c, cfg)
    elif cfg.model == "din":
        # the reference pins its broadcast path here (the mesh-sharded
        # computation); in the port path="jnp" is that same math: the
        # history broadcast to every candidate, the din_attention kernel
        # over a batch of C, then the score MLP (not the fused
        # rerank_score kernel)
        def fn(p, u, c):
            return din.score_candidates(p, u, c, cfg, path="jnp")
    else:
        def fn(p, u, c):
            return mod.score_candidates(p, u, c, cfg)

    def draw_rest(rng, dev):
        u = synthetic.recsys_batch(rng, cfg, 1)["user"]
        c = synthetic.recsys_ids(rng, cfg.item_fields, C)
        return _tensors(u, dev), _tensors(c, dev)

    def draw(dev, g, rng):
        return (draw_params(dev, g), *draw_rest(rng, dev))
    # the reference's layout splits the candidates over data; the port's
    # ranking calls take them whole on every rank and split them
    # themselves where the reference's model code does (a local slice),
    # so each rank draws them whole and no collective undoes the layout
    in_specs = (pspecs, uspec, cspec)
    local_specs = (pspecs, uspec,
                   tree_lib.tree_map(lambda t: P(*(None,) * t.dim()), cand))
    return Cell(arch.arch_id, shape.name, fn, (params, user, cand), draw,
                meta=meta, device=device, in_specs=in_specs,
                out_specs=(P(None), P(None)), mesh=mesh,
                draw_local=local_draw(draw_rest, local_specs),
                local_specs=local_specs)


def build_cell(arch_id: str, shape_name: str, device=None,
               reduced: bool = False, mesh=None) -> Cell:
    """The cell of ``arch_id`` × ``shape_name`` on ``mesh`` (an abstract
    or live ``launch.mesh.Mesh``; an abstract (1, 1) mesh if None), which
    sets its specs and per-device bytes; ``reduced`` takes the arch's
    reduced config (the shapes stay as published). ``device`` is where
    :meth:`Cell.materialize` draws by default (``cuda`` if None)."""
    arch = registry.get(arch_id)
    shape = registry.get_shape(arch, shape_name)
    if reduced:
        arch = registry.ArchDef(arch.arch_id, arch.family,
                                arch.reduced(arch.config), arch.shapes,
                                arch.reduced)
    builder = {"lm": build_lm_cell, "gnn": build_gnn_cell,
               "recsys": build_rec_cell}[arch.family]
    return builder(arch, shape, device, mesh=mesh)
