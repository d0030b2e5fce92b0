"""SchNet [arXiv:1706.08566] — continuous-filter convolution GNN.

Message passing is an edge gather (``index_select``, whose gradient is an
``index_add_``) and a node scatter (``index_add``), the counterparts of the
reference's ``jnp.take`` and ``jax.ops.segment_sum``; the reference builds
them outside any Pallas call, so no hand-written kernel stands in for them.
Two input modes:

  * molecular: atom types (embedding) + 3-D positions → pairwise distances
  * generic feature graphs (cora / ogb-products shapes): node features →
    linear projection; per-edge scalar "distances" supplied as input

Edges are an explicit (E, 2) integer [src, dst] list; padding edges point
at a sentinel node (n_nodes), whose row rides along through every
interaction and is stripped before the readout. The reference's index
semantics are kept exactly: gathers clamp their indices (``mode="clip"``)
and scatters drop ids outside ``[0, num_segments)``, where ``index_select``
and ``index_add_`` would raise (CPU) or assert on the device.

Parameters keep the reference's layout: ``interactions`` is one dict of
leaves stacked on a leading axis of length ``n_interactions`` (the
reference's ``jax.vmap`` of the per-interaction init).

On a device mesh (``runtime.current_mesh()``) the reference's two
sharding sites (``schnet.py:79,109-110``) are written out by rank: the
edge list and its distances split over ("data", "model") (every rank
holds the graph whole and takes its block, the tail padded with
sentinel edges), each rank computes the filter ``w`` and the messages of
its edges, and the partial node sums are summed over ("data", "model")
(one all_reduce an interaction, where XLA's partitioner inserts one).
The node-wise layers stay replicated. In training the filter weights and
the node features the edges gather enter the edge split
(``runtime.enter``), so their gradients are summed over it; the graph is
not a batch split over ranks, so the train step sums no gradient over the
data axes (``batch_axes=()``).

Every rank must then hold the same bits in every replicated value, or
the ranks' losses part and the replicated parameters drift apart step by
step. CUDA's ``index_add`` sums in no fixed order, so no rank sums a
replicated whole with it: the readout's per-graph sums and the
atom-type embedding's lookup (whose gradient is an ``index_add``) split
their rows over the edge axes too, each rank's partial summed by one
collective, whose result is the same on every rank.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import default_device, runtime
from repro_torch.configs.base import GNNConfig
from repro_torch.models.layers import dense_apply, dense_init

_LOG2 = math.log(2.0)
#: the mesh axes the edges split over (the reference's ``P(("data",
#: "model"))``)
EDGE_AXES = ("data", "model")


def shifted_softplus(x):
    # jax.nn.softplus is logaddexp(x, 0), which torch.logaddexp computes by
    # the same formula (max + log1p(exp(-|x - 0|))) with the same gradient
    # (exp(x - out), 0.5 at x = 0); F.softplus switches to x above its
    # threshold of 20, where log1p(exp(-20)) is below float32's resolution
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device)) - _LOG2


def rbf_centers(n_rbf: int, cutoff: float, device=None) -> torch.Tensor:
    """float32 centres equal to ``jnp.linspace(0.0, cutoff, n_rbf)`` bit for
    bit. XLA folds that linspace (start 0) into ``iota × f32(f32(1/(n-1)) ·
    cutoff)`` with the endpoint appended; at n_rbf = 300, cutoff = 10
    (gamma 900) one ulp of a centre moves an RBF value by up to ~2.4e-5,
    so the centres are built by the same products."""
    if n_rbf == 1:
        return torch.zeros((1,), dtype=torch.float32, device=device)
    # a float32 value, exact as a Python float: the products below round
    # once, in float32, on either device
    step = float(torch.tensor(1.0, dtype=torch.float32) / (n_rbf - 1) * cutoff)
    return torch.cat([
        torch.arange(n_rbf - 1, dtype=torch.float32, device=device) * step,
        torch.full((1,), cutoff, dtype=torch.float32, device=device)])


def gaussian_rbf(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """(E,) → (E, n_rbf): Gaussian radial basis on [0, cutoff]."""
    centers = rbf_centers(n_rbf, cutoff, dist.device)
    gamma = 1.0 / ((cutoff / n_rbf) ** 2)
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    c = 0.5 * (torch.cos(math.pi * dist / cutoff) + 1.0)
    return torch.where(dist < cutoff, c, torch.zeros((), dtype=c.dtype,
                                                     device=c.device))


def take_clip(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, idx, axis=0, mode="clip")``: rows of ``x`` at ``idx``
    clamped to ``[0, len(x) - 1]``."""
    return x.index_select(0, idx.clamp(0, x.shape[0] - 1))


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``data`` summed by ``ids`` into
    ``num_segments`` rows; ids outside ``[0, num_segments)`` (negative ones
    too) are dropped: they land on a scratch row that is sliced off."""
    ids = torch.where((ids >= 0) & (ids < num_segments), ids,
                      torch.full_like(ids, num_segments))
    out = torch.zeros((num_segments + 1, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, ids, data)[:num_segments]


def init(generator_or_seed, cfg: GNNConfig, d_feat_in: Optional[int] = None,
         device=None) -> dict:
    """Random SchNet parameters in the reference's layout. ``generator_or_seed``
    is a ``torch.Generator`` on ``device`` or an int seed for one."""
    dev = default_device(device)
    g = generator_or_seed
    if not isinstance(g, torch.Generator):
        g = torch.Generator(device=dev).manual_seed(int(g))
    h, r = cfg.d_hidden, cfg.n_rbf
    params: dict = {}
    if d_feat_in is None:
        params["embed"] = torch.randn((cfg.n_atom_types, h), generator=g,
                                      device=dev) * 0.1
    else:
        params["in_proj"] = dense_init(g, d_feat_in, h, device=dev)

    def interaction_init():
        return {"filt1": dense_init(g, r, h, device=dev),
                "filt2": dense_init(g, h, h, device=dev),
                "w_in": dense_init(g, h, h, bias=False, device=dev),
                "w_out1": dense_init(g, h, h, device=dev),
                "w_out2": dense_init(g, h, h, device=dev)}

    per = [interaction_init() for _ in range(cfg.n_interactions)]
    params["interactions"] = {
        name: {k: torch.stack([p[name][k] for p in per]) for k in layer}
        for name, layer in per[0].items()}
    params["head1"] = dense_init(g, h, h // 2, device=dev)
    params["head2"] = dense_init(g, h // 2, 1, device=dev)
    return params


def _split_edges() -> bool:
    return runtime.current_mesh() is not None and \
        runtime.axes_size(EDGE_AXES) > 1


def _edge_block(edges, dist, n_nodes: int):
    """The rank's block of the edge list and distances split over
    ``EDGE_AXES``, the whole padded to a multiple of the ranks with
    sentinel edges (src = dst = N, distance 0)."""
    E = edges.shape[0]
    pad = runtime.pad_to_multiple(E, runtime.axes_size(EDGE_AXES)) - E
    if pad:
        edges = torch.cat([edges, torch.full((pad, 2), n_nodes,
                                             dtype=edges.dtype,
                                             device=edges.device)])
        dist = torch.cat([dist, dist.new_zeros((pad,))])
    start, per = runtime.block(E + pad, EDGE_AXES)
    return edges[start:start + per], dist[start:start + per]


def _take_rows(table, ids):
    """``take_clip(table, ids)``, replicated. On a mesh each rank gathers
    its block of ``ids`` from the table entering the edge split, and the
    blocks are all-gathered: the table's gradient is each rank's partial
    ``index_add``, summed by ``enter``'s all_reduce."""
    if not _split_edges():
        return take_clip(table, ids)
    rows = take_clip(runtime.enter(table, EDGE_AXES),
                     runtime.shard(ids, EDGE_AXES))
    return runtime.gather_rows(rows, EDGE_AXES, ids.shape[0])


def _readout(atom_e, graph_ids, n_graphs: int):
    """``segment_sum(atom_e, graph_ids, n_graphs)``, replicated. On a mesh
    each rank sums its block of the atoms (the padded tail adds zeros to
    graph 0) and the partial sums are summed over the edge axes."""
    if not _split_edges():
        return segment_sum(atom_e, graph_ids, n_graphs)
    part = segment_sum(runtime.shard(runtime.enter(atom_e, EDGE_AXES),
                                     EDGE_AXES),
                       runtime.shard(graph_ids, EDGE_AXES), n_graphs)
    return runtime.all_reduce(part, EDGE_AXES)


def _interaction(p, x, edges, edge_dist, n_nodes, cfg: GNNConfig):
    """One cfconv + atom-wise update. x (N+1, h) with sentinel row N. On
    a mesh ``edges`` / ``edge_dist`` are the rank's block
    (:func:`_edge_block`)."""
    split = _split_edges()
    filt = {k: {n: runtime.enter(t, EDGE_AXES) for n, t in p[k].items()}
            for k in ("filt1", "filt2")} if split else p
    src, dst = edges[:, 0], edges[:, 1]
    rbf = gaussian_rbf(edge_dist, cfg.n_rbf, cfg.cutoff)            # (E, r)
    w = shifted_softplus(dense_apply(filt["filt1"], rbf))
    w = dense_apply(filt["filt2"], w)                                # (E, h)
    w = w * cosine_cutoff(edge_dist, cfg.cutoff)[:, None]           # rank's edges
    xin = dense_apply(p["w_in"], x)
    if split:
        xin = runtime.enter(xin, EDGE_AXES)
    msg = take_clip(xin, src) * w                                    # (E, h)
    agg = segment_sum(msg, dst, n_nodes + 1)
    if split:                      # the ranks' partial node sums
        agg = runtime.all_reduce(agg, EDGE_AXES)
    v = dense_apply(p["w_out1"], agg)
    v = shifted_softplus(v)
    v = dense_apply(p["w_out2"], v)
    return x + v


def forward(params, inputs: dict, cfg: GNNConfig, n_graphs: int = 1):
    """Per-graph energies.

    inputs: either {atom_z (N,), positions (N,3)} or {node_feat (N, d)};
    always {edges (E,2), edge_dist (E,) or None, graph_ids (N,)}.
    Sentinel node index N marks padding (edges to N land on the sentinel
    row, which is stripped before the readout)."""
    edges = inputs["edges"]
    if "node_feat" in inputs:
        x = dense_apply(params["in_proj"], inputs["node_feat"])
        n_nodes = inputs["node_feat"].shape[0]
        dist = inputs["edge_dist"]
    else:
        z = inputs["atom_z"]
        x = _take_rows(params["embed"], z)
        n_nodes = z.shape[0]
        pos = inputs["positions"]
        d = take_clip(pos, edges[:, 0]) - take_clip(pos, edges[:, 1])
        dist = torch.sqrt(torch.sum(d * d, -1) + 1e-12)
    if _split_edges():
        edges, dist = _edge_block(edges, dist, n_nodes)
    x = torch.cat([x, torch.zeros((1, x.shape[1]), dtype=x.dtype,
                                  device=x.device)])                 # sentinel

    stacked = params["interactions"]
    n_int = stacked["w_in"]["w"].shape[0]
    for i in range(n_int):
        p_i = {name: {k: v[i] for k, v in layer.items()}
               for name, layer in stacked.items()}
        x = _interaction(p_i, x, edges, dist, n_nodes, cfg)

    x = x[:n_nodes]
    h = shifted_softplus(dense_apply(params["head1"], x))
    atom_e = dense_apply(params["head2"], h)[:, 0]                   # (N,)
    graph_ids = inputs.get("graph_ids")
    if graph_ids is None:
        return torch.sum(atom_e)[None]
    return _readout(atom_e, graph_ids, n_graphs)


def loss_fn(params, inputs: dict, targets, cfg: GNNConfig,
            n_graphs: int = 1):
    pred = forward(params, inputs, cfg, n_graphs=n_graphs)
    return torch.mean((pred - targets) ** 2)


def batch_loss(params, batch: dict, cfg: GNNConfig, n_graphs: int = 1):
    """:func:`loss_fn` of a batch {"inputs", "targets"}: the train step's
    ``loss_fn(params, batch)`` form."""
    return loss_fn(params, batch["inputs"], batch["targets"], cfg,
                   n_graphs=n_graphs)
