"""The port's services against the reference services.

Both are built at the reduced configs with seed 0; the reference's model
weights and its trained pruning DNN are carried into the port's service
(device="cpu", the kernels' plain versions) through numpy. The same
requests then run through both on the SimExecutor (virtual clock, so the
micro-batching, fanout and shedding decisions are the same): every
answer's top-k ids match (up to the order of equal scores), scores agree
within 2e-5 (tests/test_rerank_fused.py), and the cube_version /
generation / degraded_tier stamps are equal. That holds for the DIN
re-rank ``InferenceService`` and for the ``MultiScenarioService`` with the
default scenarios (DIN + DIEN + MIND) and with two-tower retrieval added.
"""
import math

import jax
import numpy as np
import pytest

from repro.core.executors import SimExecutor as JaxSimExecutor
from repro.core.irm.shedding import PruningDNN as JaxPruningDNN
from repro.core.service import InferenceService as JaxInferenceService
from repro.core.service import MultiScenarioService as JaxMultiService
from repro.core.service import MultiServiceConfig as JaxMultiServiceConfig
from repro.core.service import ServiceConfig as JaxServiceConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.executors import SimExecutor
from repro_torch.core.irm.shedding import PruningDNN
from repro_torch.core.service import (InferenceService, MultiScenarioService,
                                      MultiServiceConfig, ServiceConfig)

TOL = dict(rel=2e-5, abs=2e-5)
N_REQUESTS = 48


def _carry_dnn(ref_dnn) -> PruningDNN:
    dnn = PruningDNN(device="cpu")
    dnn.params = params_from_numpy(jax.tree.map(np.asarray, ref_dnn.params),
                                   "cpu")
    dnn.x_mean = params_from_numpy(np.asarray(ref_dnn.x_mean), "cpu")
    dnn.x_std = params_from_numpy(np.asarray(ref_dnn.x_std), "cpu")
    return dnn


def _carry_params(buffer):
    return params_from_numpy(jax.tree.map(np.asarray, buffer.active.payload),
                             "cpu")


def _carry(ref_svc) -> dict:
    """The reference service's DIN weights and pruning DNN as the port's
    injection keywords (CPU tensors)."""
    return dict(model_cfg=ref_svc.model_cfg,
                params=_carry_params(ref_svc.buffer),
                pruning_dnn=_carry_dnn(ref_svc.shedder.dnn))


def _carry_multi(ref_svc) -> dict:
    """Every scenario's config and weights, and the shared pruning DNN, of
    a reference MultiScenarioService as the port's injection keywords."""
    rts = ref_svc.runtimes
    dnns = {id(rt.shedder.dnn) for rt in rts.values() if rt.shedder}
    assert len(dnns) == 1                 # one DNN shared by every shedder
    shed = next(rt.shedder.dnn for rt in rts.values() if rt.shedder)
    return dict(model_cfgs={n: rt.model_cfg for n, rt in rts.items()},
                params={n: _carry_params(rt.buffer) for n, rt in rts.items()},
                pruning_dnn=_carry_dnn(shed))


@pytest.fixture(scope="module")
def services():
    ref = JaxInferenceService(JaxServiceConfig(arch_id="din", seed=0))
    port = InferenceService(ServiceConfig(arch_id="din", seed=0),
                            device="cpu", **_carry(ref))
    return ref, port


def _sim_run(svc, executor_cls, rate_qps=500.0, seed=0):
    """``svc.run(executor="sim")`` with the requests numbered 0..N-1: each
    package numbers events from its own process-wide counter, and the
    shedder's features read the request id."""
    reqs = svc.make_requests(N_REQUESTS, seed=seed)
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


# --------------------------------------------------- multi-scenario service

MULTI = {"default": (),
         "with_towers": ("din-rerank", "dien-rerank", "mind-retrieval",
                         "towers-retrieval")}


@pytest.fixture(scope="module", params=sorted(MULTI))
def multi_reports(request):
    """(reference service, port service, reference report, port report)
    of one SimExecutor run of the same requests."""
    scenarios = MULTI[request.param]
    ref = JaxMultiService(JaxMultiServiceConfig(scenarios=scenarios, seed=0))
    port = MultiScenarioService(MultiServiceConfig(scenarios=scenarios,
                                                   seed=0),
                                device="cpu", **_carry_multi(ref))
    return ref, port, _sim_run(ref, JaxSimExecutor), _sim_run(port, SimExecutor)


def _by_scenario_request(rep) -> dict:
    return {(ev.payload["scenario"], ev.req_id): ev for ev in rep.results}


def _assert_same_topk(got, want):
    """Same scores (2e-5) rank by rank, and the same ids wherever the
    reference's score is not tied with another rank's within 2e-5."""
    assert len(got) == len(want)
    g_ids, g_s = [i for i, _ in got], [s for _, s in got]
    w_ids, w_s = [i for i, _ in want], [s for _, s in want]
    assert g_s == pytest.approx(w_s, **TOL)
    for r, (g, w) in enumerate(zip(g_ids, w_ids)):
        if g == w:
            continue
        tied = [q for q, s in enumerate(w_s)
                if q != r and abs(s - w_s[r]) <= 2e-5]
        assert tied, f"rank {r}: id {g} vs {w} with no tie in the reference"
        assert g in {w_ids[q] for q in tied} or r == len(w_ids) - 1


def test_multi_service_runs_on_the_cpu_with_the_scenarios_asked(
        multi_reports):
    ref, port, _rep_ref, _rep = multi_reports
    assert port.device.type == "cpu"
    assert list(port.runtimes) == list(ref.runtimes)
    assert len(port.substrate.groups) == len(ref.substrate.groups)
    for name, rt in port.runtimes.items():
        assert rt.model_cfg == ref.runtimes[name].model_cfg
        leaves = jax.tree_util.tree_leaves(rt.buffer.active.payload)
        assert all(t.device.type == "cpu" for t in leaves)


def test_multi_sim_answers_match_reference(multi_reports):
    _ref, _port, rep_ref, rep = multi_reports
    want, got = _by_scenario_request(rep_ref), _by_scenario_request(rep)
    assert got.keys() == want.keys()
    assert rep.errors == rep_ref.errors == 0
    answered = {}
    for key, w_ev in want.items():
        g, w = got[key].meta["response"], w_ev.meta["response"]
        assert (g.user_id, g.item_id, g.from_cache, g.timed_out) == \
            (w.user_id, w.item_id, w.from_cache, w.timed_out)
        if w.score is None:
            assert g.score is None
        else:
            assert g.score == pytest.approx(w.score, **TOL)
        if w.topk is None:
            assert g.topk is None
            continue
        _assert_same_topk(g.topk, w.topk)
        answered[key[0]] = answered.get(key[0], 0) + 1
    # every scenario ranked candidates for some request
    assert set(answered) == {k[0] for k in want}


def test_multi_sim_stamps_and_shedding_match_reference(multi_reports):
    """The same cube_version / generation / degraded_tier stamps, the same
    tenants shed by the fanout's quota gate, and the same surviving
    candidate counts per scenario and request."""
    _ref, _port, rep_ref, rep = multi_reports
    want, got = _by_scenario_request(rep_ref), _by_scenario_request(rep)
    for key, w_ev in want.items():
        g_ev = got[key]
        g, w = g_ev.meta["response"], w_ev.meta["response"]
        assert (g.cube_version, g.generation, g.degraded_tier) == \
            (w.cube_version, w.generation, w.degraded_tier)
        assert g_ev.meta.get("tenants_shed") == w_ev.meta.get("tenants_shed")
        gc, wc = g_ev.payload.get("candidates"), w_ev.payload.get("candidates")
        assert (None if gc is None else len(gc)) == \
            (None if wc is None else len(wc))


def test_multi_quota_gate_sheds_the_same_tenants(multi_reports):
    """Both fanout quota controllers start from an overloaded reading
    (quota 0): the gate withholds the priority-1 scenarios' clones of the
    first requests, and exactly the same ones in both packages."""
    ref, port, _rep_ref, _rep = multi_reports
    ref.fanout_controller._q = port.fanout_controller._q = 0.0
    rep_ref = _sim_run(ref, JaxSimExecutor, seed=1)
    rep = _sim_run(port, SimExecutor, seed=1)
    def shed(r):
        return {ev.req_id: ev.meta.get("tenants_shed") for ev in r.results
                if ev.meta.get("tenants_shed")}
    assert shed(rep) == shed(rep_ref) and shed(rep_ref)
    assert {k: len(v) for k, v in port.by_scenario(rep).items()} == \
        {k: len(v) for k, v in ref.by_scenario(rep_ref).items()}
    want, got = _by_scenario_request(rep_ref), _by_scenario_request(rep)
    assert got.keys() == want.keys()
    for key, w_ev in want.items():
        g, w = got[key].meta["response"], w_ev.meta["response"]
        if w.topk:
            _assert_same_topk(g.topk, w.topk)
