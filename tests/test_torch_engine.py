"""The slice as a whole: ``repro_torch.api.ScopeEngine`` against
``repro.api.ScopeEngine`` on the same world and the bridged weights of the
SFT-trained tiny estimator — identical routing decisions, parsed fields and
cache accounting, confidences within float32 tolerance."""
import jax
import numpy as np
import pytest

from repro import api as japi
from repro.core.estimator import ReasoningEstimator as JEstimator
from repro.serving import sampler as JS
from repro_torch import api as tapi
from repro_torch import io
from repro_torch.configs.scope_estimator import TINY
from repro_torch.core.estimator import ReasoningEstimator as TEstimator
from repro_torch.core.fingerprint import FingerprintLibrary, build_anchor_set
from repro_torch.core.retrieval import AnchorRetriever
from repro_torch.data import tokenizer as tok
from repro_torch.data.datasets import build_scope_data, stratified_anchors
from repro_torch.data.worldsim import World
from repro_torch.serving import sampler as TS

F32_TOL = 2e-5
N_QUERIES = 8


@pytest.fixture(scope="module")
def port_world():
    """The conftest world, rebuilt from the port's numpy copies."""
    world = World(seed=0)
    data = build_scope_data(world, n_queries=200, seed=0)
    anchors = build_anchor_set(world, stratified_anchors(world, n=80, seed=7))
    lib = FingerprintLibrary(anchors)
    for m in world.pool:
        if m.seen:
            lib.onboard(world, m.name, seed=3)
    return world, data, lib, AnchorRetriever(anchors, device="cpu")


@pytest.fixture(scope="module")
def engines(tiny_trained, scope_data, anchor_set, retriever, port_world):
    """Both engines over their own fingerprint libraries (onboarding in
    these tests must not touch the session-wide ``library`` fixture)."""
    from repro.core.fingerprint import FingerprintLibrary as JLibrary
    cfg, params, _ = tiny_trained
    world, data, lib, retr = port_world
    library = JLibrary(anchor_set)
    for m in scope_data.world.pool:
        if m.seen:
            library.onboard(scope_data.world, m.name, seed=3)
    tparams = io.params_from_numpy(jax.tree.map(np.asarray, params), TINY,
                                   device="cpu")
    jeng = japi.ScopeEngine.build(japi.EngineConfig(
        estimator=JEstimator(cfg, params), retriever=retriever,
        library=library,
        models_meta={m: scope_data.world.models[m]
                     for m in scope_data.models}))
    teng = tapi.ScopeEngine.build(tapi.EngineConfig(
        estimator=TEstimator(TINY, tparams), retriever=retr, library=lib,
        models_meta={m: world.models[m] for m in data.models}))
    qids = [int(q) for q in scope_data.test_qids[:N_QUERIES]]
    assert qids == [int(q) for q in data.test_qids[:N_QUERIES]]
    return jeng, teng, scope_data, data, qids


def _same_report(jr, tr):
    assert [d.model for d in tr.decisions] == [d.model for d in jr.decisions]
    assert [d.query_id for d in tr.decisions] == \
        [d.query_id for d in jr.decisions]
    assert [d.status for d in tr.decisions] == [d.status for d in jr.decisions]
    np.testing.assert_allclose([d.p_hat for d in tr.decisions],
                               [d.p_hat for d in jr.decisions], atol=F32_TOL)
    np.testing.assert_allclose([d.cost_hat for d in tr.decisions],
                               [d.cost_hat for d in jr.decisions],
                               rtol=1e-12)
    assert (tr.cache_hits, tr.cache_misses) == (jr.cache_hits,
                                                jr.cache_misses)
    assert tr.overhead_tokens == jr.overhead_tokens
    assert tr.exec_tokens == jr.exec_tokens
    if jr.executed:                 # realized accuracy: the same records
        assert tr.accuracy == jr.accuracy
    else:                           # expected accuracy: mean of p_hat
        assert tr.accuracy == pytest.approx(jr.accuracy, abs=F32_TOL)
    # a budget alpha is a crossing point of p_hat-affine lines: it moves
    # with the float32 p_hat differences, the decisions above do not
    assert tr.alpha == pytest.approx(jr.alpha, abs=1e-5)


def test_pool_predictions_identical(engines):
    jeng, teng, jdata, tdata, qids = engines
    jreq = japi.RouteRequest([jdata.queries[q] for q in qids])
    treq = tapi.RouteRequest([tdata.queries[q] for q in qids])
    jp = jeng.predict(jreq, use_cache=False)
    tp = teng.predict(treq, use_cache=False)
    assert tp.models == jp.models
    for f in ("y_hat", "len_hat", "well_formed", "pred_overhead", "idx"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f)
    np.testing.assert_allclose(tp.p_hat, jp.p_hat, atol=F32_TOL)
    np.testing.assert_allclose(tp.sims, jp.sims, atol=1e-5)
    np.testing.assert_allclose(tp.cost_hat, jp.cost_hat, rtol=1e-12)
    assert tp.well_formed.mean() > 0.5      # the trained estimator parses


@pytest.mark.parametrize("policy", ["alpha0.0", "alpha0.7", "alpha1.0",
                                    "budget"])
def test_serve_decisions_and_cache_identical(engines, policy):
    jeng, teng, jdata, tdata, qids = engines
    if policy == "budget":
        pool = jeng.predict(japi.RouteRequest(
            [jdata.queries[q] for q in qids]), use_cache=False)
        budget = float(pool.cost_hat.min(axis=1).sum() * 1.5)
        jpol, tpol = japi.SetBudgetPolicy(budget), tapi.SetBudgetPolicy(budget)
    else:
        a = float(policy[5:])
        jpol, tpol = japi.FixedAlphaPolicy(a), tapi.FixedAlphaPolicy(a)
    jeng.cache.clear()
    teng.cache.clear()
    for _ in range(2):                      # cold, then all cache hits
        jr = jeng.serve(jdata, qids, jpol)
        tr = teng.serve(tdata, qids, tpol)
        _same_report(jr, tr)
    assert tr.cache_hits == len(qids) * len(tdata.models)
    assert teng.cache.stats.hits == jeng.cache.stats.hits
    assert teng.cache.stats.misses == jeng.cache.stats.misses


def test_route_and_onboard_identical(engines):
    jeng, teng, jdata, tdata, qids = engines
    unseen = next(m.name for m in jdata.world.pool if not m.seen)
    jeng.onboard(jdata.world, unseen, seed=99)
    teng.onboard(tdata.world, unseen, seed=99)
    jr = jeng.route(japi.RouteRequest([jdata.queries[q] for q in qids[:4]]),
                    japi.FixedAlphaPolicy(1.0))
    tr = teng.route(tapi.RouteRequest([tdata.queries[q] for q in qids[:4]]),
                    tapi.FixedAlphaPolicy(1.0))
    _same_report(jr, tr)
    assert unseen in tr.per_model_share
    teng.remove_model(unseen)
    jeng.remove_model(unseen)
    assert unseen not in teng.registry.routable()


def test_trained_generations_identical_and_pad_after_eos(engines):
    """Greedy streams of the trained estimator: equal token for token, and
    every row that emits EOS decodes PAD afterwards."""
    jeng, teng, jdata, tdata, qids = engines
    st = teng._prepare(tapi.RouteRequest([tdata.queries[q]
                                          for q in qids[:3]]), False)
    prompts = np.asarray(st.prompts, np.int32)
    jg, jd = JS.generate(jeng.estimator.params, jeng.estimator.cfg, prompts)
    tg, td = TS.generate(teng.estimator.params, teng.estimator.cfg, prompts)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_allclose(td, jd, atol=F32_TOL, rtol=F32_TOL)
    hit = (tg == tok.EOS).any(axis=1)
    assert hit.mean() > 0.5
    for row in np.flatnonzero(hit):
        f = int(np.argmax(tg[row] == tok.EOS))
        assert (tg[row, f + 1:] == tok.PAD).all()
