"""Drift-aware self-healing in the port: ``repro_torch.serving.feedback``,
``DriftAwarePolicy``, the engine's outcome injection, monitor, quarantine,
replay-buffer refresh and live ``hot_swap``, held to ``repro`` on the same
world and the bridged weights of the SFT-trained tiny estimator.

Tolerances: the monitor is numpy on both sides, fed the same rows, and
must give the same alarm indices, quarantine sets and percentiles exactly;
served outcomes (the world's records, faults applied) are equal; p_hat and
the residuals built from it within 2e-5; retrieval similarities within
1e-6 (the two retrievers differ by ~2e-7).  A hot-swapped engine's
post-swap ticks equal a fresh port engine's bit for bit."""
import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.estimator import Prediction as JPrediction
from repro.core.estimator import ReasoningEstimator as JEstimator
from repro.core.fingerprint import FingerprintLibrary as JLibrary
from repro.data.datasets import build_scope_data as jbuild_scope_data
from repro.models import model as JM
from repro.serving import faults as JF
from repro.serving import feedback as JFb
from repro.serving import scheduler as JSch
from repro_torch import api as tapi
from repro_torch import io
from repro_torch.configs.scope_estimator import TINY
from repro_torch.core.estimator import Prediction as TPrediction
from repro_torch.core.estimator import ReasoningEstimator as TEstimator
from repro_torch.core.fingerprint import FingerprintLibrary, build_anchor_set
from repro_torch.core.retrieval import AnchorRetriever
from repro_torch.core.status import STATUS_DRIFTED
from repro_torch.data.datasets import build_scope_data, stratified_anchors
from repro_torch.data.worldsim import World
from repro_torch.models import tier0 as TT0
from repro_torch.serving import faults as TF
from repro_torch.serving import feedback as TFb
from repro_torch.serving import scheduler as TSch

F32_TOL = 2e-5
SIM_TOL = 1e-6
DRIFT_VICTIM = "deepseek-r1t2-chimera"


def _tplan(plan):
    return None if plan is None else TF.FaultPlan(
        TF.FaultSpec(s.site, s.index, s.arg, s.model) for s in plan.specs)


@pytest.fixture(scope="module")
def port_world():
    world = World(seed=0)
    anchors = build_anchor_set(world, stratified_anchors(world, n=80, seed=7))
    lib = FingerprintLibrary(anchors)
    for m in world.pool:
        if m.seen:
            lib.onboard(world, m.name, seed=3)
    return world, anchors, lib, AnchorRetriever(anchors, device="cpu")


# ---------------------------------------------------------------------------
# The repair: served outcomes under a model_drift fault
# ---------------------------------------------------------------------------
class _Counting:
    """The deterministic stand-in of ``tests/test_api.py``: the prediction
    is a pure function of the prompt."""

    def __init__(self, prediction_cls):
        self.prediction_cls = prediction_cls

    def predict(self, prompts, rng=None, **kw):
        out = []
        for p in prompts:
            h = sum(p) % 97
            out.append(self.prediction_cls(
                y_hat=h % 2, len_hat=64.0 + h, well_formed=True,
                p_conf=0.25 + 0.5 * (h / 97.0), pred_tokens=6,
                rationale_len=4))
        return out


def test_model_drift_fault_degrades_served_outcomes_like_reference(
        world, scope_data, library, retriever, port_world):
    """``execute`` runs every served pair through the engine-lifetime
    injector: from outcome event 0 on, ``deepseek-r1t2-chimera``'s realized
    correctness is 0 and its cost doubles, on both sides alike."""
    tworld, _, tlib, tretr = port_world
    tdata = build_scope_data(tworld, n_queries=200, seed=0)
    plan = JF.FaultPlan([JF.FaultSpec("model_drift", 0, arg=1.0,
                                      model=DRIFT_VICTIM)])
    qids = [int(q) for q in scope_data.test_qids[:10]]
    reports = []
    for fault_plan, tfault in ((None, None), (plan, _tplan(plan))):
        jeng = japi.ScopeEngine.build(japi.EngineConfig(
            estimator=_Counting(JPrediction), retriever=retriever,
            library=library, fault_plan=fault_plan,
            models_meta={m: world.models[m] for m in scope_data.models}))
        teng = tapi.ScopeEngine.build(tapi.EngineConfig(
            estimator=_Counting(TPrediction), retriever=tretr, library=tlib,
            fault_plan=tfault,
            models_meta={m: tworld.models[m] for m in tdata.models}))
        pol = (japi.FixedAlphaPolicy(1.0), tapi.FixedAlphaPolicy(1.0))
        reports.append((jeng.serve(scope_data, qids, pol[0]),
                        teng.serve(tdata, qids, pol[1])))
    for jr, tr in reports:
        assert [d.model for d in tr.decisions] == \
            [d.model for d in jr.decisions]
        assert tr.accuracy == jr.accuracy
        assert tr.total_cost == pytest.approx(jr.total_cost, rel=1e-12)
        assert tr.exec_tokens == jr.exec_tokens
    (clean, _), (jr, tr) = reports
    # without the injection the port served the clean outcomes: 0.3, $0.0301
    assert (clean.accuracy, round(clean.total_cost, 4)) == (0.3, 0.0301)
    assert (tr.accuracy, round(tr.total_cost, 4)) == (0.0, 0.0595)
    assert tr.exec_tokens == clean.exec_tokens
    assert sum(d.model == DRIFT_VICTIM for d in tr.decisions) == 7


# ---------------------------------------------------------------------------
# serving.feedback: the same rows, the same alarms
# ---------------------------------------------------------------------------
def _outcomes(n, models=("a", "b", "c"), seed=0, drift_from=60):
    """A seeded outcome stream: calibrated Bernoulli residuals, then model
    "a" turns persistently overconfident from row ``drift_from``; one row in
    seven unparsed."""
    r = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        m = models[i % len(models)]
        p = float(r.uniform(0.2, 0.95))
        y = float(r.random() < p)
        if m == "a" and i >= drift_from:
            y = 0.0
        rows.append(dict(query_id=int(r.integers(0, 10**6)), model=m,
                         predicted_p=p, predicted_cost=float(r.uniform()),
                         observed_y=y, observed_cost=float(r.uniform()),
                         observed_tokens=int(r.integers(5, 900)),
                         sims=r.uniform(0.0, 1.0, 5), idx=r.permutation(80)[:5],
                         t=float(i + 1), well_formed=bool(i % 7)))
    return rows


def test_page_hinkley_like_reference():
    for kw in (dict(threshold=0.0), dict(min_obs=0)):
        with pytest.raises(ValueError):
            TFb.PageHinkley(**kw)
        with pytest.raises(ValueError):
            JFb.PageHinkley(**kw)
    r = np.random.default_rng(3)
    xs = np.concatenate([r.uniform(-0.5, 0.5, 80), r.uniform(0.2, 0.9, 40)])
    for kw in (dict(), dict(delta=0.0, threshold=1.0, min_obs=1),
               dict(delta=0.1, threshold=3.0, min_obs=20)):
        j, t = JFb.PageHinkley(**kw), TFb.PageHinkley(**kw)
        fired_j = [j.update(float(x)) for x in xs]
        fired_t = [t.update(float(x)) for x in xs]
        assert fired_t == fired_j and any(fired_t)
        assert (t.n, t.mean, t.m, t.m_min, t.score) == \
            (j.n, j.mean, j.m, j.m_min, j.score)
        t.reset()
        assert t.n == 0 and t.score == 0.0


def test_replay_buffer_like_reference():
    with pytest.raises(ValueError, match="capacity"):
        TFb.ReplayBuffer(0)
    jb, tb = JFb.ReplayBuffer(capacity=16), TFb.ReplayBuffer(capacity=16)
    for row in _outcomes(40):
        jb.append(JFb.Outcome(**row))
        tb.append(TFb.Outcome(**row))
    assert len(tb) == len(jb) == 16
    for m in (None, "a", "b", "nope"):
        assert [r.query_id for r in tb.rows(m)] == \
            [r.query_id for r in jb.rows(m)]
        np.testing.assert_array_equal(tb.residuals(m), jb.residuals(m))


def test_feedback_monitor_alarms_like_reference(library, port_world):
    """The same outcome rows through both monitors: the same alarm at the
    same row, quarantine sets, percentiles, clear, and the refreshed
    fingerprint."""
    _, _, tlib, _ = port_world
    kw = dict(capacity=64, delta=0.05, threshold=2.0, min_obs=4)
    jm, tm = JFb.FeedbackMonitor(**kw), TFb.FeedbackMonitor(**kw)
    seen = sorted(m.name for m in port_world[0].pool if m.seen)[:3]
    rows = [dict(r, model=seen[("a", "b", "c").index(r["model"])])
            for r in _outcomes(150)]
    alarms = []
    for i, row in enumerate(rows):
        a = jm.observe(JFb.Outcome(**row))
        b = tm.observe(TFb.Outcome(**row))
        assert b == a, i
        if b is not None:
            alarms.append((i, b))
        assert tm.drifted == jm.drifted and tm.alarms == jm.alarms
    assert alarms and alarms[0][1] == seen[0]
    assert tm.residual_percentiles() == jm.residual_percentiles()
    for m in seen:
        assert tm.can_refresh(m) == jm.can_refresh(m)
        jfp = jm.refresh_fingerprint(m, library)
        tfp = tm.refresh_fingerprint(m, tlib)
        np.testing.assert_array_equal(tfp.y, jfp.y)
        np.testing.assert_array_equal(tfp.tokens, jfp.tokens)
        np.testing.assert_array_equal(tfp.cost, jfp.cost)
    with pytest.raises(ValueError, match="no replay-buffer outcomes"):
        tm.refresh_fingerprint("never-seen", tlib)
    tm.clear(seen[0])
    jm.clear(seen[0])
    assert tm.drifted == jm.drifted and tm.detector(seen[0]).n == 0


# ---------------------------------------------------------------------------
# Engine integration: the closed self-healing loop
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup(tiny_trained, world, anchor_set, library, retriever, port_world):
    """The reference's ``drift_setup`` on both sides: engines with private
    fingerprint libraries (``onboard(refresh=True)`` mutates them) and a
    12-token budget; ``mk(**engine_config) -> (reference, port)``."""
    cfg, params, _ = tiny_trained
    tparams = io.params_from_numpy(jax.tree.map(np.asarray, params), TINY,
                                   device="cpu")
    tworld, anchors, _, tretr = port_world
    jdata = jbuild_scope_data(world, n_queries=160, seed=9)
    tdata = build_scope_data(tworld, n_queries=160, seed=9)

    def mk(**kw):
        jlib, tlib = JLibrary(anchor_set), FingerprintLibrary(anchors)
        for m in world.pool:
            if m.seen:
                jlib.add(library.get(m.name))
                tlib.onboard(tworld, m.name, seed=3)
        plan = kw.pop("fault_plan", None)
        jeng = japi.ScopeEngine.build(japi.EngineConfig(
            estimator=JEstimator(cfg, params, max_new_tokens=12),
            retriever=retriever, library=jlib, fault_plan=plan,
            models_meta={m: world.models[m] for m in jdata.models}, **kw))
        teng = tapi.ScopeEngine.build(tapi.EngineConfig(
            estimator=TEstimator(TINY, tparams, max_new_tokens=12),
            retriever=tretr, library=tlib, fault_plan=_tplan(plan),
            models_meta={m: tworld.models[m] for m in tdata.models}, **kw))
        return jeng, teng

    return mk, jdata, tdata


def _serve_both(jeng, teng, jdata, tdata, qids, alpha=0.6, **kw):
    jr = jeng.serve(jdata, qids, japi.FixedAlphaPolicy(alpha), **kw)
    tr = teng.serve(tdata, qids, tapi.FixedAlphaPolicy(alpha), **kw)
    assert [d.model for d in tr.decisions] == [d.model for d in jr.decisions]
    assert [d.status for d in tr.decisions] == \
        [d.status for d in jr.decisions]
    np.testing.assert_allclose([d.p_hat for d in tr.decisions],
                               [d.p_hat for d in jr.decisions], atol=F32_TOL)
    assert (tr.accuracy, tr.exec_tokens, tr.cache_hits, tr.cache_misses) == \
        (jr.accuracy, jr.exec_tokens, jr.cache_hits, jr.cache_misses)
    assert tr.total_cost == pytest.approx(jr.total_cost, rel=1e-12)
    return jr, tr


def _same_buffers(jm, tm):
    jrows, trows = jm.buffer.rows(), tm.buffer.rows()
    assert len(trows) == len(jrows)
    for a, b in zip(jrows, trows, strict=True):
        assert (b.query_id, b.model, b.observed_y, b.observed_tokens,
                b.well_formed) == (a.query_id, a.model, a.observed_y,
                                   a.observed_tokens, a.well_formed)
        assert b.observed_cost == pytest.approx(a.observed_cost, rel=1e-12)
        assert b.predicted_p == pytest.approx(a.predicted_p, abs=F32_TOL)
        np.testing.assert_array_equal(b.idx, a.idx)
        np.testing.assert_allclose(b.sims, a.sims, atol=SIM_TOL)


def test_engine_builds_monitor_only_when_drift_detect(setup):
    mk, _, _ = setup
    assert mk()[1].monitor is None
    _, eng = mk(drift_detect=True, drift_threshold=1.5, drift_min_obs=2,
                feedback_capacity=32)
    assert eng.monitor.buffer.capacity == 32
    det = eng.monitor.detector("any")
    assert det.threshold == 1.5 and det.min_obs == 2
    with pytest.raises(ValueError, match="capacity"):
        mk(drift_detect=True, feedback_capacity=0)


def test_serve_collects_outcomes_passively_like_reference(setup):
    """Detector on, no fault: the port's decisions equal its detector-off
    run bit for bit, one buffered outcome per executed query, the same
    rows as the reference's, no alarm."""
    mk, jdata, tdata = setup
    qids = [int(q) for q in jdata.test_qids[:6]]
    _, ref = mk()
    want = ref.serve(tdata, qids, tapi.FixedAlphaPolicy(0.6))
    jeng, teng = mk(drift_detect=True)
    _, got = _serve_both(jeng, teng, jdata, tdata, qids)
    assert [d.model for d in got.decisions] == \
        [d.model for d in want.decisions]
    np.testing.assert_array_equal([d.p_hat for d in got.decisions],
                                  [d.p_hat for d in want.decisions])
    assert len(teng.monitor.buffer) == len(qids)
    assert teng.monitor.alarms == 0 and teng.monitor.drifted == set()
    _same_buffers(jeng.monitor, teng.monitor)


def test_drift_closed_loop_like_reference(setup):
    """inject -> detect -> quarantine -> refresh -> recover on both sides:
    the alarm on the same serve, the same quarantine statuses, the same
    refreshed fingerprint and the same decisions after the heal."""
    mk, jdata, tdata = setup
    qids = [int(q) for q in jdata.test_qids[:8]]
    probe, _ = mk()
    pool = probe.predict(japi.RouteRequest([jdata.queries[q] for q in qids]))
    victim = pool.models[int(np.argmax(pool.well_formed.sum(axis=0)))]
    jeng, teng = mk(drift_detect=True, drift_threshold=3.0, drift_delta=0.05,
                    drift_min_obs=3,
                    fault_plan=JF.FaultPlan([JF.FaultSpec(
                        "model_drift", len(qids), arg=1.0, model=victim)]))
    ticks = []
    for tick in range(5):
        _serve_both(jeng, teng, jdata, tdata, qids, models=[victim])
        assert teng.monitor.alarms == jeng.monitor.alarms
        assert teng.monitor.drifted == jeng.monitor.drifted
        ticks.append(teng.monitor.alarms)
        if victim in teng.monitor.drifted:
            break
    assert ticks[0] == 0 and ticks[-1] == 1
    alarm_tick = len(ticks) - 1
    assert alarm_tick == next(i for i, a in enumerate(ticks) if a)
    _same_buffers(jeng.monitor, teng.monitor)
    ent = {k: e for k, e in teng.cache._store.items() if k[1] == victim}
    assert ent and all(e.status == STATUS_DRIFTED for e in ent.values())
    jp = jeng.predict(japi.RouteRequest([jdata.queries[q] for q in qids],
                                        models=[victim]))
    tp = teng.predict(tapi.RouteRequest([tdata.queries[q] for q in qids],
                                        models=[victim]))
    np.testing.assert_array_equal(tp.status, jp.status)
    assert (tp.status == STATUS_DRIFTED).all()
    # heal: replay-buffer re-fingerprint + live hot-swap
    jfp = jeng.onboard(jdata.world, victim, refresh=True)
    tfp = teng.onboard(tdata.world, victim, refresh=True)
    assert teng.library.get(victim) is tfp
    np.testing.assert_allclose(tfp.y, jfp.y, atol=F32_TOL)
    # similarity-weighted means: they carry the retrievers' sims difference
    np.testing.assert_allclose(tfp.cost, jfp.cost, rtol=1e-6)
    assert np.abs(tfp.tokens - jfp.tokens).max() <= 1
    assert victim not in teng.monitor.drifted
    assert all(k[1] != victim for k in teng.cache._store)
    jeng.hot_swap(jeng.estimator, "v0+heal")
    teng.hot_swap(teng.estimator, "v0+heal")
    jr, tr = _serve_both(jeng, teng, jdata, tdata, qids, models=[victim])
    assert tr.cache_hits == 0
    assert all(d.status != "DRIFTED" for d in tr.decisions)


def test_serve_stream_drift_block_like_reference(setup):
    """``serve_stream`` with the detector on and a drift fault armed: the
    per-tick ``as_dict()["drift"]`` block equals the reference's."""
    mk, jdata, tdata = setup
    qids = [int(q) for q in jdata.test_qids[:12]]
    ticks = [qids[:4], qids[4:8], qids[8:]]
    plan = JF.FaultPlan([JF.FaultSpec("model_drift", 2, arg=0.5,
                                      model=DRIFT_VICTIM)])
    jeng, teng = mk(drift_detect=True, drift_threshold=1.0, drift_min_obs=2,
                    fault_plan=plan, refill=True, kv_paged=True,
                    kv_page_size=8)
    js = JSch.MicrobatchScheduler(JSch.BucketConfig(batch_sizes=(1, 2, 4, 8)))
    ts = TSch.MicrobatchScheduler(TSch.BucketConfig(batch_sizes=(1, 2, 4, 8)))
    jit = jeng.serve_stream(jdata, ticks, japi.FixedAlphaPolicy(0.6),
                            scheduler=js)
    tit = teng.serve_stream(tdata, ticks, tapi.FixedAlphaPolicy(0.6),
                            scheduler=ts)
    for jr, tr in zip(jit, tit, strict=True):
        assert [d.model for d in tr.decisions] == \
            [d.model for d in jr.decisions]
        assert (tr.accuracy, tr.exec_tokens) == (jr.accuracy, jr.exec_tokens)
        jd, td = js.stats.as_dict()["drift"], ts.stats.as_dict()["drift"]
        for k in ("residual_p50", "residual_p95"):
            assert td.pop(k) == pytest.approx(jd.pop(k), abs=1e-4)
        assert td == jd
    assert ts.stats.replay_buffer_len == len(qids)
    _same_buffers(jeng.monitor, teng.monitor)


def test_hot_swap_version_bump_and_tier0_stamping(setup):
    mk, _, tdata = setup
    _, eng = mk()
    queries = [tdata.queries[int(q)] for q in tdata.test_qids[:3]]
    a = eng.predict(tapi.RouteRequest(queries))
    with pytest.raises(ValueError, match="new estimator_version"):
        eng.hot_swap(eng.estimator, "v0")
    eng.hot_swap(eng.estimator, "v0+swap")
    assert eng.config.estimator_version == "v0+swap" and eng._hot_swaps == 1
    b = eng.predict(tapi.RouteRequest(queries))
    assert b.cache_hits == 0 and b.cache_misses == a.cache_misses
    np.testing.assert_array_equal(a.p_hat, b.p_hat)
    head = TT0.Tier0Head(TT0.init_tier0(torch.Generator().manual_seed(5),
                                        device="cpu"))
    _, eng = mk(tier0=head, escalation_threshold=0.9)
    eng.hot_swap(eng.estimator, "v1")           # implicit: head dropped
    assert eng.config.tier0 is None
    head2 = TT0.Tier0Head(TT0.init_tier0(torch.Generator().manual_seed(6),
                                         device="cpu"))
    eng.hot_swap(eng.estimator, "v2", tier0=head2)
    assert eng.config.tier0 is head2 and head2.version == "v2"
    eng.set_estimator(eng.estimator, "v3")
    assert eng.config.estimator_version == "v3" and eng._hot_swaps == 2


@pytest.mark.parametrize("mode", ["whole_retire", "refill_paged"])
def test_hot_swap_at_tick_boundary_matches_fresh_engine(setup, mode):
    """Ticks served after a mid-stream ``hot_swap`` equal, bit for bit, a
    fresh port engine that started on the new params, and the reference's
    own swapped stream within tolerance.  The scheduler emits every tick
    at once (``max_queue_age=0``) and the stream runs it to the end before
    the next arrives — whole-retire with overlap off, or the refill path
    (paged KV) in one segment of the whole budget — so the swap lands
    exactly between two ticks."""
    from repro.configs.scope_estimator import TINY as JTINY
    mk, jdata, tdata = setup
    params_b = JM.init_params(jax.random.PRNGKey(1), JTINY)
    tparams_b = io.params_from_numpy(jax.tree.map(np.asarray, params_b),
                                     TINY, device="cpu")
    qids = [int(q) for q in jdata.test_qids[:12]]
    ticks = [qids[:4], qids[4:8], qids[8:]]
    if mode == "whole_retire":
        kw, skw = {}, dict(overlap=False, refill=False)
    else:
        kw = dict(refill=True, kv_paged=True, kv_page_size=8, segment_len=12)
        skw = {}

    def sched(lib):
        return lib.MicrobatchScheduler(lib.BucketConfig(
            batch_sizes=(1, 2, 4, 8)), max_queue_age=0.0)

    def stream(eng, api, data, sch, new_est, ticks_, swap_after=None):
        reports = []
        for i, r in enumerate(eng.serve_stream(
                data, [list(t) for t in ticks_], api.FixedAlphaPolicy(0.6),
                scheduler=sched(sch), use_cache=False, **skw)):
            reports.append(r)
            if i == swap_after:
                eng.hot_swap(new_est, "v0+swap")
        return reports

    jeng, teng = mk(**kw)
    jest_b = JEstimator(JTINY, params_b, max_new_tokens=12)
    test_b = TEstimator(TINY, tparams_b, max_new_tokens=12)
    jreps = stream(jeng, japi, jdata, JSch, jest_b, ticks, swap_after=0)
    treps = stream(teng, tapi, tdata, TSch, test_b, ticks, swap_after=0)
    _, fresh = mk(**kw)
    fresh.set_estimator(test_b, "v0+swap")
    want = stream(fresh, tapi, tdata, TSch, None, ticks[1:])
    for got, ref in zip(treps[1:], want, strict=True):
        assert [d.model for d in got.decisions] == \
            [d.model for d in ref.decisions]
        assert [d.p_hat for d in got.decisions] == \
            [d.p_hat for d in ref.decisions]
        assert [d.cost_hat for d in got.decisions] == \
            [d.cost_hat for d in ref.decisions]
        assert got.overhead_tokens == ref.overhead_tokens
    for jr, tr in zip(jreps, treps, strict=True):
        assert [d.model for d in tr.decisions] == \
            [d.model for d in jr.decisions]
        np.testing.assert_allclose([d.p_hat for d in tr.decisions],
                                   [d.p_hat for d in jr.decisions],
                                   atol=F32_TOL)
        assert tr.overhead_tokens == jr.overhead_tokens
    assert teng._hot_swaps == jeng._hot_swaps == 1


# ---------------------------------------------------------------------------
# DriftAwarePolicy
# ---------------------------------------------------------------------------
def test_drift_aware_policy_validation():
    inner = tapi.FixedAlphaPolicy(0.6)
    with pytest.raises(ValueError, match="unknown mode"):
        tapi.DriftAwarePolicy(inner, mode="bogus")
    with pytest.raises(ValueError, match="weight"):
        tapi.DriftAwarePolicy(inner, mode="downweight", weight=1.5)
    assert tapi.DriftAwarePolicy(inner).name == f"drift_aware({inner.name})"


def test_drift_aware_policy_decisions_like_reference(setup):
    """Pass-through, exclude, downweight and all-quarantined: equal choices
    and info on both sides, over their own pools."""
    mk, jdata, tdata = setup
    qids = [int(q) for q in jdata.test_qids[:6]]
    jeng, teng = mk(drift_detect=True)
    jpool = jeng.predict(japi.RouteRequest([jdata.queries[q] for q in qids]))
    tpool = teng.predict(tapi.RouteRequest([tdata.queries[q] for q in qids]))
    base = japi.FixedAlphaPolicy(0.6).decide(jpool, jeng)
    counts = np.bincount(np.asarray(base.choices, int),
                         minlength=len(jpool.models))
    victim = jpool.models[int(np.argmax(counts))]

    def decide(mode, drifted, **kw):
        out = []
        for eng, api, pool in ((jeng, japi, jpool), (teng, tapi, tpool)):
            eng.monitor.drifted.clear()
            eng.monitor.drifted.update(drifted)
            pol = api.DriftAwarePolicy(api.FixedAlphaPolicy(0.6), mode=mode,
                                       **kw)
            out.append(pol.decide(pool, eng))
        (j, t) = out
        np.testing.assert_array_equal(t.choices, j.choices)
        assert t.info == j.info and t.alpha == j.alpha
        return t

    thru = decide("exclude", set())
    np.testing.assert_array_equal(thru.choices, base.choices)
    excl = decide("exclude", {victim})
    assert victim not in {tpool.models[int(c)] for c in excl.choices}
    assert excl.info["drift_excluded"] == [victim]
    down = decide("downweight", {victim}, weight=0.5)
    assert down.info["drift_downweighted"] == [victim]
    allq = decide("exclude", set(tpool.models))
    assert allq.info["drift_all_quarantined"] is True
    _, plain = mk()                             # no monitor: pass-through
    np.testing.assert_array_equal(
        tapi.DriftAwarePolicy(tapi.FixedAlphaPolicy(0.6)).decide(
            tpool, plain).choices,
        tapi.FixedAlphaPolicy(0.6).decide(tpool, plain).choices)
    for eng in (jeng, teng):
        eng.monitor.drifted.clear()
