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
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import default_device
from repro_torch.configs.base import GNNConfig
from repro_torch.models.layers import dense_apply, dense_init

_LOG2 = math.log(2.0)


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


def _interaction(p, x, edges, edge_dist, n_nodes, cfg: GNNConfig):
    """One cfconv + atom-wise update. x (N+1, h) with sentinel row N."""
    src, dst = edges[:, 0], edges[:, 1]
    rbf = gaussian_rbf(edge_dist, cfg.n_rbf, cfg.cutoff)            # (E, r)
    w = shifted_softplus(dense_apply(p["filt1"], rbf))
    w = dense_apply(p["filt2"], w)                                   # (E, h)
    w = w * cosine_cutoff(edge_dist, cfg.cutoff)[:, None]
    # (the reference shards w over the mesh here: ROADMAP A8)
    xin = dense_apply(p["w_in"], x)
    msg = take_clip(xin, src) * w                                    # (E, h)
    agg = segment_sum(msg, dst, n_nodes + 1)
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
        x = take_clip(params["embed"], z)
        n_nodes = z.shape[0]
        pos = inputs["positions"]
        d = take_clip(pos, edges[:, 0]) - take_clip(pos, edges[:, 1])
        dist = torch.sqrt(torch.sum(d * d, -1) + 1e-12)
    # (the reference shards edges and dist over the mesh here: ROADMAP A8)
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
    return segment_sum(atom_e, graph_ids, n_graphs)


def loss_fn(params, inputs: dict, targets, cfg: GNNConfig,
            n_graphs: int = 1):
    pred = forward(params, inputs, cfg, n_graphs=n_graphs)
    return torch.mean((pred - targets) ** 2)
