"""The streaming serve stack: ``repro_torch.api.ScopeEngine.predict_stream``
and ``serve_stream`` against ``repro.api.ScopeEngine``'s on the same world
and the bridged weights of the SFT-trained tiny estimator — whole-retire,
slot refill over a dense cache and over the paged KV pool, and chaos
streams under one seeded fault plan.  Streams are compared with streams:
identical token-derived fields, decisions, scheduler counters and fault
ledgers, confidences within float32 tolerance."""
import jax
import numpy as np
import pytest

from repro import api as japi
from repro.core.estimator import ReasoningEstimator as JEstimator
from repro.serving import faults as JF
from repro.serving import scheduler as JSch
from repro_torch import api as tapi
from repro_torch import io
from repro_torch.configs.scope_estimator import TINY
from repro_torch.core.estimator import ReasoningEstimator as TEstimator
from repro_torch.core.fingerprint import FingerprintLibrary, build_anchor_set
from repro_torch.core.retrieval import AnchorRetriever
from repro_torch.data.datasets import build_scope_data, stratified_anchors
from repro_torch.data.worldsim import World
from repro_torch.serving import faults as TF
from repro_torch.serving import scheduler as TSch

F32_TOL = 2e-5
BUCKETS = (1, 2, 4, 8)
MODES = {"whole_retire": {},
         "refill_dense": dict(refill=True),
         "refill_paged": dict(refill=True, kv_paged=True, kv_page_size=8)}
STAT_FIELDS = ("submitted", "emitted", "microbatches", "slots_refilled",
               "slot_steps_total", "slot_steps_active", "refill_steps_saved",
               "pages_peak", "kv_peak_tokens", "admissions_deferred_on_pages",
               "admissions_deferred_on_horizon")
FAULT_FIELDS = ("retries", "requeued", "quarantined", "degraded",
                "failed_pairs", "injected_faults", "kv_exhausted_rows",
                "deadline_expired")


@pytest.fixture(scope="module")
def make(tiny_trained, scope_data, anchor_set, retriever):
    """``make(**engine_config)`` -> (JAX engine, port engine, both data,
    ticks of query ids).  Each engine owns a fresh fingerprint library and
    prediction cache; the estimators decode 6 tokens."""
    from repro.core.fingerprint import FingerprintLibrary as JLibrary
    cfg, params, _ = tiny_trained
    tparams = io.params_from_numpy(jax.tree.map(np.asarray, params), TINY,
                                   device="cpu")
    world = World(seed=0)
    data = build_scope_data(world, n_queries=200, seed=0)
    anchors = build_anchor_set(world, stratified_anchors(world, n=80, seed=7))
    retr = AnchorRetriever(anchors, device="cpu")
    qids = [int(q) for q in scope_data.test_qids[:6]]
    assert qids == [int(q) for q in data.test_qids[:6]]
    ticks = [qids[:2], qids[2:3], qids[3:6]]

    def build(**kw):
        jlib = JLibrary(anchor_set)
        tlib = FingerprintLibrary(anchors)
        for m in world.pool:
            if m.seen:
                jlib.onboard(scope_data.world, m.name, seed=3)
                tlib.onboard(world, m.name, seed=3)
        jeng = japi.ScopeEngine.build(japi.EngineConfig(
            estimator=JEstimator(cfg, params, max_new_tokens=6),
            retriever=retriever, library=jlib,
            models_meta={m: scope_data.world.models[m]
                         for m in scope_data.models}, **kw))
        teng = tapi.ScopeEngine.build(tapi.EngineConfig(
            estimator=TEstimator(TINY, tparams, max_new_tokens=6),
            retriever=retr, library=tlib,
            models_meta={m: world.models[m] for m in data.models},
            **{k: (TF.FaultPlan(TF.FaultSpec(s.site, s.index, s.arg)
                                for s in v.specs)
                   if k == "fault_plan" and v is not None else v)
               for k, v in kw.items()}))
        return jeng, teng

    return build, scope_data, data, ticks


def _predict(eng, data, ticks, sched):
    api = japi if isinstance(eng, japi.ScopeEngine) else tapi
    return list(eng.predict_stream(
        (api.RouteRequest([data.queries[q] for q in t]) for t in ticks),
        scheduler=sched))


def _same_pools(jpools, tpools, jeng, teng):
    assert len(tpools) == len(jpools)
    for jp, tp in zip(jpools, tpools, strict=True):
        assert tp.models == jp.models
        for f in ("y_hat", "well_formed", "pred_overhead", "idx", "status"):
            np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                          err_msg=f)
        np.testing.assert_allclose(tp.p_hat, jp.p_hat, atol=F32_TOL)
        # a degraded pair's length estimate is a similarity-weighted mean,
        # so it carries the float32 retrieval scores' differences; a
        # decoded pair's is a parsed bucket center, equal
        ok = jp.status == 0
        np.testing.assert_array_equal(tp.len_hat[ok], jp.len_hat[ok])
        np.testing.assert_allclose(tp.len_hat, jp.len_hat, rtol=1e-5)
        np.testing.assert_allclose(tp.cost_hat[ok], jp.cost_hat[ok],
                                   rtol=1e-12)
        np.testing.assert_allclose(tp.cost_hat, jp.cost_hat, rtol=1e-5)
        assert (tp.cache_hits, tp.cache_misses) == (jp.cache_hits,
                                                    jp.cache_misses)
        jd = japi.FixedAlphaPolicy(0.6).decide(jp, jeng)
        td = tapi.FixedAlphaPolicy(0.6).decide(tp, teng)
        np.testing.assert_array_equal(td.choices, jd.choices)


def _same_stats(js, ts, fields):
    got = {f: getattr(ts, f) for f in fields}
    want = {f: getattr(js, f) for f in fields}
    assert got == want


@pytest.mark.parametrize("mode", list(MODES))
def test_predict_stream_matches_reference(make, mode):
    build, jdata, tdata, ticks = make
    jeng, teng = build(**MODES[mode])
    jsched = JSch.MicrobatchScheduler(JSch.BucketConfig(batch_sizes=BUCKETS))
    tsched = TSch.MicrobatchScheduler(TSch.BucketConfig(batch_sizes=BUCKETS))
    jpools = _predict(jeng, jdata, ticks, jsched)
    tpools = _predict(teng, tdata, ticks, tsched)
    _same_pools(jpools, tpools, jeng, teng)
    _same_stats(jsched.stats, tsched.stats, STAT_FIELDS)
    assert tsched.stats.slot_steps_total > 0
    if mode == "refill_paged":
        assert tsched.stats.pages_peak > 0
    if mode != "whole_retire":
        assert tsched.stats.slots_refilled > 0


def test_serve_stream_reports_match_reference(make):
    build, jdata, tdata, ticks = make
    jeng, teng = build(**MODES["refill_paged"])
    policy = (japi.FixedAlphaPolicy(0.6), tapi.FixedAlphaPolicy(0.6))
    jreps = list(jeng.serve_stream(jdata, ticks, policy[0]))
    treps = list(teng.serve_stream(tdata, ticks, policy[1]))
    assert len(treps) == len(jreps) == len(ticks)
    for jr, tr in zip(jreps, treps, strict=True):
        assert [d.model for d in tr.decisions] == \
            [d.model for d in jr.decisions]
        assert [d.query_id for d in tr.decisions] == \
            [d.query_id for d in jr.decisions]
        assert [d.status for d in tr.decisions] == \
            [d.status for d in jr.decisions]
        np.testing.assert_allclose([d.p_hat for d in tr.decisions],
                                   [d.p_hat for d in jr.decisions],
                                   atol=F32_TOL)
        assert (tr.accuracy, tr.exec_tokens, tr.overhead_tokens,
                tr.cache_hits, tr.cache_misses) == (
            jr.accuracy, jr.exec_tokens, jr.overhead_tokens, jr.cache_hits,
            jr.cache_misses)
        assert tr.total_cost == pytest.approx(jr.total_cost, rel=1e-12)


@pytest.mark.parametrize("mode", ["whole_retire", "refill_paged"])
def test_chaos_stream_fault_ledger_matches_reference(make, mode):
    """One seeded plan, its specs carried over spec by spec: the same
    boundaries fail, the same rows retry, requeue, quarantine and degrade,
    and the streams still answer every pair identically."""
    build, jdata, tdata, ticks = make
    plan = JF.FaultPlan.seeded(
        5, rates={"dispatch": 0.3, "segment": 0.3, "pool": 0.3,
                  "parse": 0.2})
    assert [(s.site, s.index, s.arg) for s in plan.specs] == [
        (s.site, s.index, s.arg) for s in TF.FaultPlan.seeded(
            5, rates={"dispatch": 0.3, "segment": 0.3, "pool": 0.3,
                      "parse": 0.2}).specs]
    jeng, teng = build(max_retries=1, fault_plan=plan, **MODES[mode])
    jsched = JSch.MicrobatchScheduler(JSch.BucketConfig(batch_sizes=BUCKETS))
    tsched = TSch.MicrobatchScheduler(TSch.BucketConfig(batch_sizes=BUCKETS))
    jpools = _predict(jeng, jdata, ticks, jsched)
    tpools = _predict(teng, tdata, ticks, tsched)
    _same_pools(jpools, tpools, jeng, teng)
    _same_stats(jsched.stats, tsched.stats, FAULT_FIELDS + STAT_FIELDS)
    assert tsched.stats.injected_faults > 0 and tsched.stats.retries > 0
    assert tsched.stats.as_dict()["faults"] == jsched.stats.as_dict()["faults"]


def test_fault_plan_none_is_no_plan(make):
    """``FaultPlan.none()`` changes nothing: equal predictions, scheduler
    counters and cache, bit for bit, against a stream with no plan."""
    build, _, tdata, ticks = make
    runs = []
    for plan in (None, TF.FaultPlan.none()):
        _, teng = build(fault_plan=plan, **MODES["refill_paged"])
        sched = TSch.MicrobatchScheduler(
            TSch.BucketConfig(batch_sizes=BUCKETS))
        runs.append((_predict(teng, tdata, ticks, sched), sched.stats,
                     teng.cache))
    (pa, sa, ca), (pb, sb, cb) = runs
    for a, b in zip(pa, pb, strict=True):
        for f in ("p_hat", "y_hat", "len_hat", "well_formed",
                  "pred_overhead", "status", "cost_hat"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    _same_stats(sa, sb, FAULT_FIELDS + STAT_FIELDS)
    assert sa.injected_faults == 0
    assert len(ca) == len(cb) > 0


def test_degrade_off_answers_failed(make):
    """With ``degrade=False`` a quarantined pair is answered FAILED, as in
    the reference; every pair is still answered exactly once."""
    build, jdata, tdata, ticks = make
    plan = JF.FaultPlan([JF.FaultSpec("segment", i) for i in range(8)])
    jeng, teng = build(max_retries=0, degrade=False, fault_plan=plan,
                       **MODES["refill_paged"])
    jsched = JSch.MicrobatchScheduler(JSch.BucketConfig(batch_sizes=BUCKETS))
    tsched = TSch.MicrobatchScheduler(TSch.BucketConfig(batch_sizes=BUCKETS))
    jpools = _predict(jeng, jdata, ticks, jsched)
    tpools = _predict(teng, tdata, ticks, tsched)
    _same_pools(jpools, tpools, jeng, teng)
    _same_stats(jsched.stats, tsched.stats, FAULT_FIELDS)
    assert tsched.stats.failed_pairs > 0


def test_kv_paged_requires_refill_and_known_kernel(make):
    build, _, tdata, ticks = make
    _, teng = build(kv_paged=True)
    with pytest.raises(ValueError, match="refill"):
        list(teng.predict_stream(
            iter([tapi.RouteRequest([tdata.queries[ticks[0][0]]])]),
            refill=False))
    _, teng = build(refill=True, kv_paged=True, kv_kernel="triton")
    with pytest.raises(ValueError, match="kv_kernel"):
        list(teng.predict_stream(
            iter([tapi.RouteRequest([tdata.queries[ticks[0][0]]])])))
    _, teng = build(refill=True, kv_paged=True, refill_horizon=32)
    with pytest.raises(ValueError, match="mutually exclusive"):
        list(teng.predict_stream(
            iter([tapi.RouteRequest([tdata.queries[ticks[0][0]]])])))


def test_serving_engine_matches_reference(tiny_trained):
    """``serving.engine.ServingEngine``: fixed-size batches, the last one
    padded, one result per request — the same tokens as the reference,
    decision logits within float32 tolerance."""
    from repro.serving.engine import ServingEngine as JServing
    from repro_torch.serving.engine import ServingEngine as TServing
    cfg, params, _ = tiny_trained
    tparams = io.params_from_numpy(jax.tree.map(np.asarray, params), TINY,
                                   device="cpu")
    rng = np.random.default_rng(21)
    prompts = [list(rng.integers(3, 100, size=n)) for n in (9, 12, 7, 12, 5)]
    engines = (JServing(params, cfg, batch_size=4, max_new_tokens=6),
               TServing(tparams, TINY, batch_size=4, max_new_tokens=6))
    for eng in engines:
        assert [eng.submit(p) for p in prompts] == list(range(len(prompts)))
    jres, tres = (eng.run() for eng in engines)
    assert sorted(tres) == sorted(jres) == list(range(len(prompts)))
    for rid in jres:
        np.testing.assert_array_equal(tres[rid].tokens, jres[rid].tokens)
        np.testing.assert_allclose(tres[rid].decision_logits,
                                   jres[rid].decision_logits, atol=F32_TOL)
    assert engines[1].run() == {}
