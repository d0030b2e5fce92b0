"""The port's DIN re-rank service against the reference service.

Both are built at the reduced config with seed 0; the reference's DIN
weights and its trained pruning DNN are carried into the port's service
(device="cpu", the kernels' plain versions) through numpy. The same
requests then run through both on the SimExecutor (virtual clock, so the
micro-batching and shedding decisions are the same): every answer's top-k
ids match, scores agree within 2e-5 (tests/test_rerank_fused.py), and the
cube_version / generation / degraded_tier stamps are equal.
"""
import math

import jax
import numpy as np
import pytest

from repro.core.executors import SimExecutor as JaxSimExecutor
from repro.core.irm.shedding import PruningDNN as JaxPruningDNN
from repro.core.service import InferenceService as JaxInferenceService
from repro.core.service import ServiceConfig as JaxServiceConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.executors import SimExecutor
from repro_torch.core.irm.shedding import PruningDNN
from repro_torch.core.service import InferenceService, ServiceConfig

TOL = dict(rel=2e-5, abs=2e-5)
N_REQUESTS = 48


def _carry(ref_svc) -> dict:
    """The reference service's DIN weights and pruning DNN as the port's
    injection keywords (CPU tensors)."""
    params = params_from_numpy(
        jax.tree.map(np.asarray, ref_svc.buffer.active.payload), "cpu")
    ref_dnn = ref_svc.shedder.dnn
    dnn = PruningDNN(device="cpu")
    dnn.params = params_from_numpy(jax.tree.map(np.asarray, ref_dnn.params),
                                   "cpu")
    dnn.x_mean = params_from_numpy(np.asarray(ref_dnn.x_mean), "cpu")
    dnn.x_std = params_from_numpy(np.asarray(ref_dnn.x_std), "cpu")
    return dict(model_cfg=ref_svc.model_cfg, params=params, pruning_dnn=dnn)


@pytest.fixture(scope="module")
def services():
    ref = JaxInferenceService(JaxServiceConfig(arch_id="din", seed=0))
    port = InferenceService(ServiceConfig(arch_id="din", seed=0),
                            device="cpu", **_carry(ref))
    return ref, port


def _sim_run(svc, executor_cls, rate_qps=500.0):
    """``svc.run(executor="sim")`` with the requests numbered 0..N-1: each
    package numbers events from its own process-wide counter, and the
    shedder's features read the request id."""
    reqs = svc.make_requests(N_REQUESTS, seed=0)
    for i, ev in enumerate(reqs):
        ev.req_id = i
    ex = executor_cls(svc.plan, overflow_policy=svc._overflow_policy())
    return ex.run([(i / rate_qps, ev) for i, ev in enumerate(reqs)])


@pytest.fixture(scope="module")
def sim_reports(services):
    ref, port = services
    return _sim_run(ref, JaxSimExecutor), _sim_run(port, SimExecutor)


def _by_request(rep, view=lambda ev: ev.meta["response"]) -> dict:
    return {ev.req_id: view(ev) for ev in rep.results}


def test_port_service_runs_on_the_cpu_when_asked(services):
    _ref, port = services
    assert port.device.type == "cpu"
    leaves = [port.buffer.active.payload["tables"]["item_id"],
              port.buffer.active.payload["mlp"][0]["w"],
              port.shedder.dnn.params[0]["w"]]
    assert all(t.device.type == "cpu" for t in leaves)


def test_sim_answers_match_reference(sim_reports):
    rep_ref, rep = sim_reports
    want, got = _by_request(rep_ref), _by_request(rep)
    assert got.keys() == want.keys() and len(got) == N_REQUESTS
    assert rep.errors == rep_ref.errors == 0
    reranked = 0
    for rid, w in want.items():
        g = got[rid]
        assert (g.user_id, g.item_id, g.from_cache, g.timed_out) == \
            (w.user_id, w.item_id, w.from_cache, w.timed_out)
        assert g.score == pytest.approx(w.score, **TOL)
        if w.topk is None:
            assert g.topk is None
            continue
        reranked += 1
        assert [i for i, _ in g.topk] == [i for i, _ in w.topk]
        assert [s for _, s in g.topk] == pytest.approx(
            [s for _, s in w.topk], **TOL)
    assert reranked > 0


def test_sim_stamps_match_reference(sim_reports):
    rep_ref, rep = sim_reports
    want, got = _by_request(rep_ref), _by_request(rep)
    for rid, w in want.items():
        g = got[rid]
        assert (g.cube_version, g.generation, g.degraded_tier) == \
            (w.cube_version, w.generation, w.degraded_tier)


def test_sim_shedding_matches_reference(sim_reports):
    """The carried pruning DNN keeps the same candidates as the reference:
    the re-ranked sets, not only their heads, are equal."""
    rep_ref, rep = sim_reports
    def cands(ev):
        return ev.payload.get("candidates")
    want, got = _by_request(rep_ref, cands), _by_request(rep, cands)
    assert {k: None if v is None else len(v) for k, v in got.items()} == \
        {k: None if v is None else len(v) for k, v in want.items()}


def test_trace_count_bounded(services, sim_reports):
    """As tests/test_bucketing.py: distinct input signatures of the model
    calls stay within the bucket menus, and the bound is not vacuous."""
    _ref, port = services
    assert 1 <= port._serve.n_traces <= len(port.rerank_buckets.sizes)
    assert 1 <= port._rerank.n_traces <= (len(port.cand_buckets.sizes)
                                          * len(port.hist_buckets.sizes))


@pytest.mark.parametrize("steps", [1, 200])
def test_pruning_dnn_fit_matches_reference(steps, rng):
    """From the same initial weights, the port's fit follows the
    reference's update (Adam-like moments, no bias correction) step for
    step: the same loss, the same predictions. Features are float64, as
    the shedder hands them over."""
    X = rng.normal(size=(300, 7)) * np.arange(1, 8)
    y = rng.random(300).astype(np.float32)
    ref = JaxPruningDNN(seed=0)
    port = PruningDNN(device="cpu")
    port.params = params_from_numpy(jax.tree.map(np.asarray, ref.params),
                                    "cpu")
    assert port.fit(X, y, steps=steps) == pytest.approx(
        ref.fit(X, y, steps=steps), **TOL)
    np.testing.assert_allclose(port(X[:64]), np.asarray(ref(X[:64])),
                               rtol=2e-5, atol=2e-5)
    for a, b in zip(jax.tree_util.tree_leaves(ref.params),
                    jax.tree_util.tree_leaves(port.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-5,
                                   atol=2e-5)


def test_async_executor_answers_every_request(services):
    _ref, port = services
    rep = port.run(n_requests=16, executor="async")
    assert rep.errors == 0 and rep.completed == 16 and len(rep.results) == 16
    for ev in rep.results:
        r = ev.meta["response"]
        assert not r.timed_out
        assert r.score is not None and math.isfinite(r.score)
        assert 0.0 <= r.score <= 1.0
        if not r.from_cache:
            assert r.topk and all(0.0 <= s <= 1.0 for _i, s in r.topk)
