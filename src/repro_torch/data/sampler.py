"""Neighbor sampler for sampled-training GNN shapes (minibatch_lg).

A real GraphSAGE-style fanout sampler over a CSR adjacency (numpy,
host-side): seeds → fanout₁ neighbors → fanout₂ neighbors, with padded
fixed-size outputs (XLA needs static shapes) and sentinel edges masked via
the model's sentinel-node convention.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray      # (N+1,)
    indices: np.ndarray     # (E,)
    n_nodes: int

    @staticmethod
    def random(rng: np.random.Generator, n_nodes: int, avg_degree: int,
               power_law: float = 1.5) -> "CSRGraph":
        # heavy-tailed degrees (capped), like real social/product graphs
        deg = np.minimum(
            rng.zipf(power_law, n_nodes) + avg_degree // 2,
            10 * avg_degree).astype(np.int64)
        indptr = np.concatenate([[0], np.cumsum(deg)])
        indices = rng.integers(0, n_nodes, indptr[-1], dtype=np.int64)
        return CSRGraph(indptr.astype(np.int64), indices, n_nodes)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]: self.indptr[v + 1]]


def sample_fanout(graph: CSRGraph, seeds: np.ndarray, fanouts: tuple,
                  rng: np.random.Generator):
    """Returns a padded subgraph:
      nodes     (N_sub,) original node ids (padded with -1)
      edges     (E_sub, 2) LOCAL indices [src=neighbor, dst=target]
                (padded edges point at the sentinel N_sub)
      edge_mask (E_sub,) bool
    Sizes are the static worst case: N = B + B·f1 + B·f1·f2; E = B·f1 + B·f1·f2.
    """
    B = len(seeds)
    layer_nodes = [np.asarray(seeds, np.int64)]
    edges_src_local, edges_dst_local, valid = [], [], []
    offset = 0
    next_offset = B
    for fan in fanouts:
        frontier = layer_nodes[-1]
        n_f = len(frontier)
        sampled = np.full((n_f, fan), -1, np.int64)
        for i, v in enumerate(frontier):
            if v < 0:
                continue
            nbrs = graph.neighbors(int(v))
            if len(nbrs) == 0:
                continue
            take = rng.choice(nbrs, size=fan, replace=len(nbrs) < fan)
            sampled[i] = take
        src_local = next_offset + np.arange(n_f * fan)
        dst_local = np.repeat(offset + np.arange(n_f), fan)
        ok = sampled.reshape(-1) >= 0
        edges_src_local.append(src_local)
        edges_dst_local.append(dst_local)
        valid.append(ok)
        layer_nodes.append(sampled.reshape(-1))
        offset = next_offset
        next_offset += n_f * fan
    nodes = np.concatenate(layer_nodes)
    src = np.concatenate(edges_src_local)
    dst = np.concatenate(edges_dst_local)
    mask = np.concatenate(valid)
    n_sub = len(nodes)
    edges = np.stack([np.where(mask, src, n_sub),
                      np.where(mask, dst, n_sub)], axis=1).astype(np.int32)
    return nodes.astype(np.int64), edges, mask


def subgraph_sizes(batch_nodes: int, fanouts: tuple) -> tuple[int, int]:
    n, e, frontier = batch_nodes, 0, batch_nodes
    for f in fanouts:
        e += frontier * f
        frontier *= f
        n += frontier
    return n, e
