"""The port's SchNet and neighbour sampler against the reference, on the
CPU, with the reference's weights carried across through numpy:

  * ``forward``, ``loss_fn`` and every gradient leaf against
    ``jax.value_and_grad(repro.models.schnet.loss_fn)`` within 2e-5 (the
    models' tolerance, tests/test_torch_din.py), in both input modes, with
    padding edges into the sentinel node, an edge whose src is the
    sentinel (its position gather clips to row N-1), graph ids at and past
    ``n_graphs`` and below 0 (dropped), and several graphs, at the reduced
    widths and at the published ones (n_rbf 300, cutoff 10: gamma 900);
  * the RBF centres equal ``jnp.linspace`` bit for bit;
  * ``init`` builds the reference's leaves, names and shapes, with the
    interactions stacked on a leading axis;
  * the sampler's padded subgraph feeds the port's model as it feeds the
    reference's (its gradients, of order 1e2, with the absolute part of
    the tolerance scaled by the leaf's largest entry, as
    tests/test_torch_train.py holds gradients of that size).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry
from repro.data import synthetic
from repro.data.sampler import CSRGraph, sample_fanout
from repro.models import schnet as jax_schnet
from repro_torch import tree as tree_lib
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import schnet
from repro_torch.train.train_step import value_and_grad

TOL = dict(rtol=2e-5, atol=2e-5)             # tests/test_torch_din.py


def _cfg(published: bool):
    a = registry.get("schnet")
    return a.config if published else a.reduced(a.config)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carried(rng, cfg, d_feat_in=None):
    """The reference's init, with every bias drawn non-zero (the sentinel
    row then turns non-zero after the first interaction, as it does once
    trained), as numpy: the same values go to both packages."""
    params = _np(jax_schnet.init(jax.random.PRNGKey(0), cfg, d_feat_in))
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(0, 0.1, a.shape).astype(np.float32)
                      if p[-1].key == "b" else a), params)


def _to_torch(inputs):
    return {k: torch.as_tensor(v) for k, v in inputs.items()}


def _to_jax(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _molecular(rng, cfg, n_graphs=4, n_atoms=8, n_edges=16):
    mol = synthetic.molecule_batch(rng, cfg, n_graphs, n_atoms, n_edges)
    N = n_graphs * n_atoms
    edges = np.concatenate([mol["edges"],
                            [[N, N], [N, N],      # padding: sentinel → sentinel
                             [N, 3],              # src N: positions clip to N-1
                             [5, N]]]).astype(np.int32)
    gids = mol["graph_ids"].copy()
    gids[2] = n_graphs                            # at n_graphs: dropped
    gids[7] = n_graphs + 3                        # past it: dropped
    gids[11] = -1                                 # below 0: dropped
    inputs = {"atom_z": mol["atom_z"], "positions": mol["positions"],
              "edges": edges,
              "edge_dist": np.zeros(len(edges), np.float32),  # unused here
              "graph_ids": gids}
    return inputs, mol["targets"], n_graphs


def _feature_graph(rng, n_nodes=40, n_edges=96, d_feat=9, n_graphs=2):
    g = synthetic.random_graph(rng, n_nodes, n_edges, d_feat)
    pad = 4
    edges = np.concatenate([g["edges"], np.full((pad, 2), n_nodes)]
                           ).astype(np.int32)
    dist = np.concatenate([g["edge_dist"],
                           rng.uniform(0.5, 9.5, pad)]).astype(np.float32)
    dist[:3] = [10.0, 12.0, 9.999]                # at / past / below cutoff
    gids = (np.arange(n_nodes) * n_graphs // n_nodes).astype(np.int32)
    gids[0] = n_graphs                            # dropped
    inputs = {"node_feat": g["node_feat"], "edges": edges,
              "edge_dist": dist, "graph_ids": gids}
    return inputs, rng.normal(size=n_graphs).astype(np.float32), n_graphs


def _assert_trees_close(got, want, leaf_scale=False):
    """Leaf by leaf in JAX's order; ``leaf_scale``: the absolute part of
    the tolerance grows with the leaf's largest entry where that exceeds 1
    (tests/test_torch_train.py's rule for gradients of order 1e2, where
    float32 sums in two orders part by more than 2e-5 of an entry)."""
    g = tree_lib.flatten_with_paths(params_to_numpy(got))
    w = jax.tree_util.tree_flatten_with_path(_np(want))[0]
    assert [tree_lib.path_name(p) for p, _ in g] == \
        ["/".join(str(getattr(k, "key", k)) for k in p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, path
        scale = max(1.0, float(np.abs(b).max(initial=0))) if leaf_scale else 1
        np.testing.assert_allclose(a, b, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale, err_msg=str(path))


def _check_parity(params_np, inputs, targets, cfg, n_graphs,
                  leaf_scale=False):
    jp = jax.tree.map(jnp.asarray, params_np)
    j_out = jax_schnet.forward(jp, _to_jax(inputs), cfg, n_graphs=n_graphs)
    j_loss, j_grads = jax.value_and_grad(jax_schnet.loss_fn)(
        jp, _to_jax(inputs), jnp.asarray(targets), cfg, n_graphs=n_graphs)

    tp = params_from_numpy(params_np, "cpu")
    t_in = _to_torch(inputs)
    t_out = schnet.forward(tp, t_in, cfg, n_graphs=n_graphs)
    t_loss, t_grads = value_and_grad(
        lambda p, b: schnet.loss_fn(p, b, torch.as_tensor(targets), cfg,
                                    n_graphs=n_graphs), tp, t_in)
    assert t_out.shape == (n_graphs,)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(float(t_loss), float(j_loss), **TOL)
    _assert_trees_close(t_grads, j_grads, leaf_scale)
    return t_out


@pytest.mark.parametrize("published", [False, True],
                         ids=["reduced", "published"])
def test_molecular_forward_loss_and_gradients_match_reference(published, rng):
    cfg = _cfg(published)
    inputs, targets, n_graphs = _molecular(rng, cfg)
    out = _check_parity(_carried(rng, cfg), inputs, targets, cfg, n_graphs)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("published", [False, True],
                         ids=["reduced", "published"])
def test_feature_graph_forward_loss_and_gradients_match_reference(published,
                                                                  rng):
    cfg = _cfg(published)
    inputs, targets, n_graphs = _feature_graph(rng)
    _check_parity(_carried(rng, cfg, d_feat_in=9), inputs, targets, cfg,
                  n_graphs)


def test_dropped_graph_ids_and_padding_edges_change_nothing(rng):
    """Padding edges reach only the sentinel row and dropped graph ids
    reach no graph: removing the padding edges, and removing the dropped
    atoms from the readout, give the same energies."""
    cfg = _cfg(False)
    inputs, _, n_graphs = _feature_graph(rng)
    tp = params_from_numpy(_carried(rng, cfg, d_feat_in=9), "cpu")
    N = inputs["node_feat"].shape[0]
    out = schnet.forward(tp, _to_torch(inputs), cfg, n_graphs=n_graphs)
    keep = inputs["edges"][:, 0] < N
    no_pad = dict(inputs, edges=inputs["edges"][keep],
                  edge_dist=inputs["edge_dist"][keep])
    torch.testing.assert_close(
        schnet.forward(tp, _to_torch(no_pad), cfg, n_graphs=n_graphs), out,
        rtol=1e-6, atol=1e-6)
    # the dropped atom (id n_graphs) counts for no graph: giving it the
    # id -5 instead changes nothing either
    neg = dict(inputs, graph_ids=np.where(inputs["graph_ids"] >= n_graphs, -5,
                                          inputs["graph_ids"]))
    torch.testing.assert_close(
        schnet.forward(tp, _to_torch(neg), cfg, n_graphs=n_graphs), out,
        rtol=0, atol=0)


def test_no_graph_ids_sums_every_atom(rng):
    cfg = _cfg(False)
    inputs, _, _ = _molecular(rng, cfg)
    inputs.pop("graph_ids")
    params = _carried(rng, cfg)
    want = jax_schnet.forward(jax.tree.map(jnp.asarray, params),
                              _to_jax(inputs), cfg)
    got = schnet.forward(params_from_numpy(params, "cpu"), _to_torch(inputs),
                         cfg)
    assert got.shape == (1,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_rbf,cutoff", [(300, 10.0), (20, 10.0), (50, 5.0),
                                          (2, 3.3)])
def test_rbf_centers_equal_jnp_linspace_bit_for_bit(n_rbf, cutoff):
    want = np.asarray(jnp.linspace(0.0, cutoff, n_rbf))
    got = schnet.rbf_centers(n_rbf, cutoff).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_rbf_and_cutoff_match_reference_at_published_widths(rng):
    cfg = _cfg(True)
    dist = np.concatenate([rng.uniform(0, 10.5, 500),
                           np.linspace(0, 10, 300)]).astype(np.float32)
    np.testing.assert_allclose(
        schnet.gaussian_rbf(torch.as_tensor(dist), cfg.n_rbf, cfg.cutoff),
        np.asarray(jax_schnet.gaussian_rbf(jnp.asarray(dist), cfg.n_rbf,
                                           cfg.cutoff)), **TOL)
    np.testing.assert_allclose(
        schnet.cosine_cutoff(torch.as_tensor(dist), cfg.cutoff),
        np.asarray(jax_schnet.cosine_cutoff(jnp.asarray(dist), cfg.cutoff)),
        **TOL)


@pytest.mark.parametrize("d_feat_in", [None, 7])
def test_init_has_the_reference_layout(d_feat_in):
    cfg = _cfg(True)
    want = jax.eval_shape(lambda: jax_schnet.init(jax.random.PRNGKey(0), cfg,
                                                  d_feat_in))
    got = schnet.init(3, cfg, d_feat_in, device="cpu")
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    g = tree_lib.flatten_with_paths(got)
    assert [tree_lib.path_name(p) for p, _ in g] == \
        ["/".join(str(getattr(k, "key", k)) for k in p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape), path
        assert a.dtype == torch.float32
    assert got["interactions"]["filt1"]["w"].shape == \
        (cfg.n_interactions, cfg.n_rbf, cfg.d_hidden)
    # a generator and its seed give the same draw
    again = schnet.init(torch.Generator().manual_seed(3), cfg, d_feat_in,
                        device="cpu")
    for a, b in zip(tree_lib.leaves(got), tree_lib.leaves(again)):
        assert torch.equal(a, b)


def test_sampled_subgraph_matches_reference(rng):
    """The port's sampler (a verbatim copy) draws the reference's subgraph
    from the same seed, and the padded subgraph gives equal energies and
    gradients through both models."""
    from repro_torch.data import sampler
    cfg = _cfg(False)
    graph = CSRGraph.random(np.random.default_rng(5), 300, avg_degree=6)
    seeds = np.random.default_rng(6).integers(0, 300, 8)
    want = sample_fanout(graph, seeds, (3, 2), np.random.default_rng(7))
    port_graph = sampler.CSRGraph.random(np.random.default_rng(5), 300,
                                         avg_degree=6)
    got = sampler.sample_fanout(port_graph, seeds, (3, 2),
                                np.random.default_rng(7))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    nodes, edges, mask = got
    n_sub = len(nodes)
    inputs = {"node_feat": rng.normal(size=(n_sub, 9)).astype(np.float32),
              "edges": edges,
              "edge_dist": rng.uniform(0.5, 9.5, len(edges)).astype(np.float32),
              "graph_ids": np.zeros(n_sub, np.int32)}
    # one graph of 336 nodes: its energy, and so the gradients, reach ~1e2
    _check_parity(_carried(rng, cfg, d_feat_in=9), inputs,
                  np.ones(1, np.float32), cfg, 1, leaf_scale=True)
