"""Two-tier routing in the port: ``repro_torch.models.tier0``,
``repro_torch.training.{optimizer,tier0}`` and the engine's tier-0 gate,
held to ``repro`` on the same world, the bridged weights of the
SFT-trained tiny estimator and a bridged tier-0 head.

Tolerances: the head's float32 logits and probabilities within 2e-5 of the
reference (retrieval similarities, a head input, already differ by ~2e-7
between the two retrievers); one AdamW update within 2e-5; ten
distillation steps: the first loss within 2e-5, the tenth within 1e-4.
Gate thresholds sit at a midpoint between two adjacent sorted head
confidences, never at a pair's own, so both sides answer and escalate the
same pairs; token-derived fields, decisions, cache tiers and the
scheduler's tier ledger are equal."""
import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.estimator import ReasoningEstimator as JEstimator
from repro.core.fingerprint import FingerprintLibrary as JLibrary
from repro.data.datasets import build_scope_data as jbuild_scope_data
from repro.models import tier0 as JT0
from repro.serving import faults as JF
from repro.serving import scheduler as JSch
from repro.training import optimizer as JOpt
from repro.training import tier0 as JTr
from repro_torch import api as tapi
from repro_torch import io
from repro_torch.api.engine import _StreamControl, _StreamEntry
from repro_torch.configs.scope_estimator import TINY
from repro_torch.core.estimator import ReasoningEstimator as TEstimator
from repro_torch.core.fingerprint import FingerprintLibrary, build_anchor_set
from repro_torch.core.retrieval import AnchorRetriever
from repro_torch.core.status import STATUS_DEGRADED, STATUS_OK
from repro_torch.data.datasets import build_scope_data, stratified_anchors
from repro_torch.data.pipeline import to_tensors
from repro_torch.data.worldsim import World
from repro_torch.models import tier0 as TT0
from repro_torch.serving import faults as TF
from repro_torch.serving import scheduler as TSch
from repro_torch.training import optimizer as TOpt
from repro_torch.training import tier0 as TTr

F32_TOL = 2e-5
STEP10_TOL = 1e-4
SIM_TOL = 1e-6          # retrieval similarity, between the two retrievers
BUCKETS = (1, 2, 4, 8)
TIER_FIELDS = ("tier0_answered", "escalated", "tier0_fallbacks",
               "tier0_decode_tokens_saved", "submitted", "emitted",
               "quarantined", "degraded")


def _bridge_head(jhead):
    params = io.tier0_params_from_numpy(
        jax.tree.map(np.asarray, jhead.params), device="cpu")
    return TT0.Tier0Head(params, temperature=jhead.temperature,
                         version=jhead.version)


def _rand_pairs(n, k=5, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, JT0.QUERY_FEATS)).astype(np.float32),
            r.normal(size=(n, k, JT0.ANCHOR_FEATS)).astype(np.float32),
            r.normal(size=(n, JT0.MODEL_FEATS)).astype(np.float32),
            r.integers(0, JT0.N_MODEL_SLOTS, size=n).astype(np.int32))


@pytest.fixture(scope="module")
def heads():
    """The reference's test head (``init_tier0(PRNGKey(3))``) and its
    bridge."""
    jhead = JT0.Tier0Head(JT0.init_tier0(jax.random.PRNGKey(3)))
    return jhead, _bridge_head(jhead)


# ---------------------------------------------------------------------------
# The head
# ---------------------------------------------------------------------------
def test_feature_widths_and_bucket_grid_match_reference():
    assert (TT0.QUERY_FEATS, TT0.ANCHOR_FEATS, TT0.MODEL_FEATS,
            TT0.N_MODEL_SLOTS, TT0.PAIR_BUCKETS) == (
        JT0.QUERY_FEATS, JT0.ANCHOR_FEATS, JT0.MODEL_FEATS,
        JT0.N_MODEL_SLOTS, JT0.PAIR_BUCKETS)
    assert TT0.Tier0Config() == TT0.Tier0Config(
        **vars(JT0.Tier0Config()))
    for n in range(0, 3 * JT0.PAIR_BUCKETS[-1] + 2):
        assert TT0.pair_bucket(n) == JT0.pair_bucket(n), n


def test_init_tier0_shapes_match_reference():
    want = {k: tuple(v.shape) for k, v in
            JT0.init_tier0(jax.random.PRNGKey(0)).items()}
    got = TT0.init_tier0(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert all(v.dtype == torch.float32 for v in got.values())
    # seeded: the same generator seed gives the same head
    again = TT0.init_tier0(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_tier0_params_bridge_checks_shapes(heads):
    jhead, _ = heads
    tree = jax.tree.map(np.asarray, jhead.params)
    with pytest.raises(ValueError, match="w1"):
        io.tier0_params_from_numpy(dict(tree, w1=tree["w1"][:-1]),
                                   device="cpu")
    with pytest.raises(ValueError, match="tier-0 params"):
        io.tier0_params_from_numpy({k: v for k, v in tree.items()
                                    if k != "b_p"}, device="cpu")


@pytest.mark.parametrize("n", [1, 7, 40, 300])
def test_tier0_forward_matches_reference(heads, n):
    jhead, thead = heads
    qf, af, mf, mid = _rand_pairs(n, seed=n)
    jp, jl = JT0.tier0_forward(jhead.params, qf, af, mf, mid)
    tp, tl = TT0.tier0_forward(
        thead.params, torch.from_numpy(qf), torch.from_numpy(af),
        torch.from_numpy(mf), torch.from_numpy(mid).long())
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=F32_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL)
    # bucket-padded forward and host calibration
    jb = jhead.predict_pairs(qf, af, mf, mid)
    tb = thead.predict_pairs(qf, af, mf, mid)
    np.testing.assert_allclose(tb.p, jb.p, atol=F32_TOL)
    np.testing.assert_array_equal(tb.len_hat, jb.len_hat)
    np.testing.assert_array_equal(tb.y_hat, (tb.p >= 0.5).astype(int))
    assert tb.p.dtype == np.float64 and len(tb) == n


def test_head_empty_batch_and_temperature_validation(heads):
    _, head = heads
    out = head.predict_pairs(np.zeros((0, TT0.QUERY_FEATS), np.float32),
                             np.zeros((0, 5, TT0.ANCHOR_FEATS), np.float32),
                             np.zeros((0, TT0.MODEL_FEATS), np.float32),
                             np.zeros(0, np.int32))
    assert len(out) == 0 and len(head.predict_features([])) == 0
    with pytest.raises(ValueError, match="temperature"):
        head.with_temperature(0.0)
    with pytest.raises(ValueError, match="temperature"):
        TT0.Tier0Head(head.params, temperature=-1.0)
    qf, af, mf, mid = _rand_pairs(8, seed=5)
    sharp = head.predict_pairs(qf, af, mf, mid)
    flat = head.with_temperature(50.0).predict_pairs(qf, af, mf, mid)
    assert head.with_temperature(50.0).params is head.params
    assert (flat.conf <= sharp.conf + 1e-12).all()
    np.testing.assert_array_equal(flat.y_hat, sharp.y_hat)


def test_head_pad_invariant_within_tolerance(heads):
    """The same rows padded into a larger bucket agree within the float32
    tolerance (the reference's bit-exact variant of this check is red)."""
    jhead, head = heads
    qf, af, mf, mid = _rand_pairs(7)
    a = head.predict_pairs(qf, af, mf, mid)
    np.testing.assert_array_equal(
        a.p, head.predict_pairs(qf, af, mf, mid).p)      # deterministic
    qf2, af2, mf2, mid2 = _rand_pairs(40, seed=1)
    qf2[:7], af2[:7], mf2[:7], mid2[:7] = qf, af, mf, mid
    c = head.predict_pairs(qf2, af2, mf2, mid2)
    np.testing.assert_allclose(a.p, c.p[:7], rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(c.p, jhead.predict_pairs(qf2, af2, mf2,
                                                        mid2).p,
                               atol=F32_TOL)


@pytest.fixture(scope="module")
def port_world():
    world = World(seed=0)
    anchors = build_anchor_set(world, stratified_anchors(world, n=80, seed=7))
    lib = FingerprintLibrary(anchors)
    for m in world.pool:
        if m.seen:
            lib.onboard(world, m.name, seed=3)
    return world, anchors, lib, AnchorRetriever(anchors, device="cpu")


def test_pair_features_equal_for_every_pair(world, library, scope_data,
                                            retriever, port_world):
    """8 queries x 7 models on the same retrieval (sims, idx): every
    feature array equal, and the shared UNK slot for an unseen model."""
    import dataclasses
    tworld, _, tlib, _ = port_world
    tdata = build_scope_data(tworld, n_queries=200, seed=0)
    qids = [int(q) for q in scope_data.test_qids[:8]]
    embs = np.stack([scope_data.queries[q].embedding for q in qids])
    sims, idx = retriever.retrieve(embs, 5)
    n = 0
    for i, q in enumerate(qids):
        for mi, m in enumerate(scope_data.models):
            want = JT0.pair_features(world.models[m], mi, library.anchor_set,
                                     library.get(m), sims[i], idx[i],
                                     scope_data.queries[q])
            got = TT0.pair_features(tworld.models[m], mi, tlib.anchor_set,
                                    tlib.get(m), sims[i], idx[i],
                                    tdata.queries[q])
            for a, b in zip(got, want, strict=True):
                np.testing.assert_array_equal(a, b)
            n += 1
    assert n == 8 * 7
    m = next(m for m in tworld.pool if m.seen)
    _, _, _, mid = TT0.pair_features(
        dataclasses.replace(m, seen=False), 2, tlib.anchor_set,
        tlib.get(m.name), sims[0], idx[0], tdata.queries[qids[0]])
    assert mid == TT0.N_MODEL_SLOTS - 1


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------
def _tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {"a": (r.normal(size=(5, 3)) * scale).astype(np.float32),
            "b": (r.normal(size=(3,)) * scale).astype(np.float32),
            "c": (r.normal(size=(4, 2, 2)) * scale).astype(np.float32)}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # unclipped, clipped
def test_adamw_update_matches_reference(grad_scale):
    cfg = JOpt.AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=20)
    tcfg = TOpt.AdamWConfig(**vars(cfg))
    params = _tree(0)
    jp, js = params, JOpt.adamw_init(params)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = TOpt.adamw_init(tp)
    for step in range(3):
        grads = _tree(10 + step, grad_scale)
        jp, js = JOpt.adamw_update(cfg, grads, js, jp)
        tp, ts = TOpt.adamw_update(
            tcfg, {k: torch.from_numpy(v) for k, v in grads.items()}, ts, tp)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=F32_TOL)
            np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]),
                                       rtol=0, atol=F32_TOL)
    assert ts.step == int(js.step) == 3
    np.testing.assert_allclose(
        float(TOpt.global_norm({k: torch.from_numpy(v) for k, v in
                                _tree(3).items()})),
        float(JOpt.global_norm(_tree(3))), rtol=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_at_matches_reference(schedule):
    cfg = JOpt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=300,
                           schedule=schedule)
    tcfg = TOpt.AdamWConfig(**vars(cfg))
    steps = list(range(0, 320))
    want = np.asarray([float(JOpt.lr_at(cfg, s)) for s in steps], np.float32)
    got = np.asarray([float(TOpt.lr_at(tcfg, s)) for s in steps], np.float32)
    # float32 on both sides; the cosine is the only transcendental, and
    # XLA's float32 cosine on the CPU is a polynomial a few ulps from
    # PyTorch's: within 4 ulps (rtol 5e-7), everything else exact
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)
    assert (got == want).mean() > 0.9
    assert got.max() == pytest.approx(3e-3, rel=1e-6)


def test_fit_temperature_and_recalibrate_equal(heads):
    r = np.random.default_rng(0)
    logit = r.normal(scale=4.0, size=4000)
    q = 1.0 / (1.0 + np.exp(-logit / 2.0))
    assert TTr.fit_temperature(logit, q) == JTr.fit_temperature(logit, q)
    assert TTr.fit_temperature(np.zeros(0), np.zeros(0)) == 1.0
    jhead, thead = heads
    for y in (np.zeros(64), np.ones(64), r.integers(0, 2, 64)):
        p = r.uniform(0.05, 0.95, 64)
        got = TTr.recalibrate_tier0(thead, p, y)
        assert got.temperature == JTr.recalibrate_tier0(jhead, p,
                                                        y).temperature
        assert got.params is thead.params
    assert thead.temperature == 1.0


# ---------------------------------------------------------------------------
# Distillation (shared trained setup)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup(tiny_trained, world, library, retriever, port_world):
    """The reference's ``tier0_setup`` on both sides: its 160-query world,
    its distilled head (60 steps) and its bridge, and an engine factory
    ``mk(tier0=..., threshold=..., **kw) -> (reference, port)``; each
    engine owns a fresh fingerprint library."""
    cfg, params, _ = tiny_trained
    tparams = io.params_from_numpy(jax.tree.map(np.asarray, params), TINY,
                                   device="cpu")
    tworld, anchors, _, tretr = port_world
    jdata = jbuild_scope_data(world, n_queries=160, seed=9)
    tdata = build_scope_data(tworld, n_queries=160, seed=9)
    jest = JEstimator(cfg, params, max_new_tokens=6)
    test_ = TEstimator(TINY, tparams, max_new_tokens=6)
    jds = JTr.build_tier0_dataset(jdata, library, retriever, jest,
                                  max_pairs=240, seed=0)
    jhead, jreport = JTr.train_tier0(jds, steps=60, batch_size=128, seed=0)
    thead = _bridge_head(jhead)

    def mk(tier0=False, threshold=0.9, **kw):
        jlib, tlib = JLibrary(library.anchor_set), FingerprintLibrary(anchors)
        for m in world.pool:
            if m.seen:
                jlib.add(library.get(m.name))
                tlib.onboard(tworld, m.name, seed=3)
        plan = kw.pop("fault_plan", None)
        tplan = (None if plan is None else TF.FaultPlan(
            TF.FaultSpec(s.site, s.index, s.arg, s.model)
            for s in plan.specs))
        jeng = japi.ScopeEngine.build(japi.EngineConfig(
            estimator=JEstimator(cfg, params, max_new_tokens=6),
            retriever=retriever, library=jlib,
            models_meta={m: world.models[m] for m in jdata.models},
            tier0=jhead if tier0 else None, escalation_threshold=threshold,
            fault_plan=plan, **kw))
        teng = tapi.ScopeEngine.build(tapi.EngineConfig(
            estimator=TEstimator(TINY, tparams, max_new_tokens=6),
            retriever=tretr, library=tlib,
            models_meta={m: tworld.models[m] for m in tdata.models},
            tier0=thead if tier0 else None, escalation_threshold=threshold,
            fault_plan=tplan, **kw))
        return jeng, teng

    return dict(mk=mk, jdata=jdata, tdata=tdata, jest=jest, test=test_,
                cfg=cfg, params=params, tparams=tparams,
                jds=jds, jhead=jhead, thead=thead, jreport=jreport,
                tretr=tretr, tworld=tworld, anchors=anchors)


def test_build_tier0_dataset_matches_reference(setup):
    """Teacher labels from the bridged estimator, at a 12-token budget so
    most teacher rows parse well-formed.  ``World.embed`` draws from the
    world's generator, so each side builds its world afresh and
    identically."""
    from repro.core.fingerprint import build_anchor_set as jbuild_anchor_set
    from repro.core.retrieval import AnchorRetriever as JRetriever
    from repro.data.datasets import stratified_anchors as jstratified
    from repro.data.worldsim import World as JWorld
    sides = []
    for W, bsd, bas, strat, Lib, Retr, build, est in (
            (JWorld, jbuild_scope_data, jbuild_anchor_set, jstratified,
             JLibrary, JRetriever, JTr.build_tier0_dataset,
             JEstimator(setup["cfg"], setup["params"], max_new_tokens=12)),
            (World, build_scope_data, build_anchor_set, stratified_anchors,
             FingerprintLibrary, AnchorRetriever, TTr.build_tier0_dataset,
             TEstimator(TINY, setup["tparams"], max_new_tokens=12))):
        w = W(seed=0)
        data = bsd(w, n_queries=160, seed=9)
        anchors = bas(w, strat(w, n=80, seed=7))
        lib = Lib(anchors)
        for m in w.pool:
            if m.seen:
                lib.onboard(w, m.name, seed=3)
        retr = (Retr(anchors) if Retr is JRetriever
                else Retr(anchors, device="cpu"))
        sides.append(build(data, lib, retr, est, max_pairs=240, seed=0))
    jds, tds = sides
    assert set(tds) == set(jds)
    for k in ("qf", "mf", "mid", "len_lb", "wf"):
        np.testing.assert_array_equal(tds[k], jds[k], err_msg=k)
    # the anchor slice: similarities from the two retrievers, the rest equal
    np.testing.assert_allclose(tds["af"][..., 0], jds["af"][..., 0],
                               atol=SIM_TOL)
    np.testing.assert_array_equal(tds["af"][..., 1:], jds["af"][..., 1:])
    np.testing.assert_allclose(tds["q"], jds["q"], atol=F32_TOL)
    assert tds["wf"].mean() > 0.5


def test_ten_tier0_steps_match_reference(setup):
    """``train_tier0`` on both sides from the same initial params
    (bridged), the same minibatch indices (``default_rng(seed)``) and the
    same dataset: losses, the held-out temperature and the trained head."""
    jds = setup["jds"]
    jhead, jrep = JTr.train_tier0(jds, steps=10, batch_size=128, seed=0)
    init = io.tier0_params_from_numpy(
        jax.tree.map(np.asarray, JT0.init_tier0(jax.random.PRNGKey(0))),
        device="cpu")
    thead, trep = TTr.train_tier0(jds, steps=10, batch_size=128, seed=0,
                                  device="cpu", init=init)
    assert (trep.n_train, trep.n_val) == (jrep.n_train, jrep.n_val)
    assert len(trep.losses) == 10
    assert trep.losses[0] == pytest.approx(jrep.losses[0], abs=F32_TOL)
    assert trep.losses[9] == pytest.approx(jrep.losses[9], abs=STEP10_TOL)
    np.testing.assert_allclose(trep.losses, jrep.losses, atol=STEP10_TOL)
    assert trep.temperature == jrep.temperature == thead.temperature
    for k, v in jhead.params.items():
        np.testing.assert_allclose(thead.params[k].numpy(), np.asarray(v),
                                   atol=STEP10_TOL, err_msg=k)


def test_tier0_step_loss_and_update_match_reference(setup):
    """One ``tier0_step`` on the first minibatch: the loss within 2e-5 and
    the updated params within 2e-5."""
    jds = setup["jds"]
    take = np.random.default_rng(0).integers(0, 200, size=64)
    mb = {k: v[take] for k, v in jds.items()}
    jparams = JT0.init_tier0(jax.random.PRNGKey(1))
    cfg = JOpt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=60)
    jp, _, jloss = JTr.tier0_step(jparams, JOpt.adamw_init(jparams), mb, cfg)
    tparams = io.tier0_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         device="cpu")
    tp, ts, tloss = TTr.tier0_step(
        tparams, TOpt.adamw_init(tparams), to_tensors(mb, "cpu"),
        TOpt.AdamWConfig(**vars(cfg)))
    assert float(tloss) == pytest.approx(float(jloss), abs=F32_TOL)
    assert ts.step == 1
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=F32_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# The gate in the engine
# ---------------------------------------------------------------------------
def _requests(api, data, qids):
    return api.RouteRequest([data.queries[int(q)] for q in qids])


def _same_pools(jp, tp):
    assert tp.models == jp.models
    assert (tp.tier0_answered, tp.escalated) == (jp.tier0_answered,
                                                 jp.escalated)
    for f in ("y_hat", "well_formed", "pred_overhead", "idx", "status"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f)
    np.testing.assert_allclose(tp.p_hat, jp.p_hat, atol=F32_TOL)
    ok = jp.status == STATUS_OK
    np.testing.assert_array_equal(tp.len_hat[ok], jp.len_hat[ok])
    np.testing.assert_allclose(tp.len_hat, jp.len_hat, rtol=1e-5)
    assert (tp.cache_hits, tp.cache_misses) == (jp.cache_hits,
                                                jp.cache_misses)


def _cache_tiers(eng):
    return sorted((k[0], k[1], e.tier, e.status)
                  for k, e in eng.cache._store.items())


def _midpoint_threshold(conf):
    """A threshold between the two adjacent sorted confidences with the
    widest gap in the middle half: both sides non-empty, no pair near it."""
    c = np.sort(np.asarray(conf).ravel())
    lo, hi = len(c) // 4, 3 * len(c) // 4
    i = lo + int(np.argmax(np.diff(c[lo:hi + 1])))
    assert c[i + 1] - c[i] > 1e-4, "no usable gap between confidences"
    return float((c[i] + c[i + 1]) / 2)


def _probe_conf(setup, qids):
    """The head's confidence for every (query, model) pair: a threshold-0
    engine answers everything from the head, so p_hat is the head's p."""
    jeng, _ = setup["mk"](tier0=True, threshold=0.0)
    pool = jeng.predict(_requests(japi, setup["jdata"], qids),
                        use_cache=False)
    return np.maximum(pool.p_hat, 1.0 - pool.p_hat)


def test_threshold_above_one_identical_to_no_tier0(setup):
    """Threshold 2.0: the gate runs and answers nothing; the port's pool
    and cache equal its own no-tier-0 run bit for bit and the reference's
    gated run within tolerance."""
    mk, jdata, tdata = setup["mk"], setup["jdata"], setup["tdata"]
    qids = jdata.test_qids[:6]
    _, tref = mk(tier0=False)
    jeng, teng = mk(tier0=True, threshold=2.0)
    want = tref.predict(_requests(tapi, tdata, qids))
    got = teng.predict(_requests(tapi, tdata, qids))
    for f in ("p_hat", "y_hat", "len_hat", "cost_hat", "well_formed",
              "pred_overhead", "sims", "idx"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.tier0_answered == 0 and got.escalated == got.cache_misses > 0
    assert teng.cache._store == tref.cache._store
    _same_pools(jeng.predict(_requests(japi, jdata, qids)), got)
    assert _cache_tiers(teng) == _cache_tiers(jeng)


def test_threshold_zero_answers_everything_like_reference(setup):
    """Threshold 0.0: every missing pair is answered by the head; nothing
    reaches the scheduler; equal tier ledger, pools and cache tiers."""
    mk, jdata, tdata = setup["mk"], setup["jdata"], setup["tdata"]
    qids = jdata.test_qids[:6]
    jeng, teng = mk(tier0=True, threshold=0.0)
    js = JSch.MicrobatchScheduler(JSch.BucketConfig(batch_sizes=BUCKETS))
    ts = TSch.MicrobatchScheduler(TSch.BucketConfig(batch_sizes=BUCKETS))
    jpools = list(jeng.predict_stream(iter([
        _requests(japi, jdata, qids[:3]), _requests(japi, jdata, qids[3:])]),
        scheduler=js))
    tpools = list(teng.predict_stream(iter([
        _requests(tapi, tdata, qids[:3]), _requests(tapi, tdata, qids[3:])]),
        scheduler=ts))
    n_pairs = 6 * len(tdata.models)
    st = ts.stats
    assert st.submitted == 0 and st.emitted == 0 and st.microbatches == 0
    assert st.tier0_answered == n_pairs and st.escalated == 0
    assert st.tier0_decode_tokens_saved == n_pairs * 6
    for jp, tp in zip(jpools, tpools, strict=True):
        _same_pools(jp, tp)
        assert (tp.pred_overhead == 0).all() and tp.well_formed.all()
    assert st.as_dict()["tiers"] == js.stats.as_dict()["tiers"]
    assert len(teng.cache) == n_pairs
    assert _cache_tiers(teng) == _cache_tiers(jeng)
    assert {t for _, _, t, _ in _cache_tiers(teng)} == {0}


@pytest.mark.parametrize("mode", ["whole_retire", "refill_paged"])
def test_midpoint_threshold_splits_traffic_like_reference(setup, mode):
    """A threshold between two adjacent head confidences: the same pairs
    answered and escalated on both sides, only the escalated ones
    submitted, equal decisions, cache tiers and tier ledger."""
    mk, jdata, tdata = setup["mk"], setup["jdata"], setup["tdata"]
    qids = jdata.test_qids[:6]
    thr = _midpoint_threshold(_probe_conf(setup, qids))
    kw = {} if mode == "whole_retire" else dict(refill=True, kv_paged=True,
                                                kv_page_size=8)
    jeng, teng = mk(tier0=True, threshold=thr, **kw)
    js = JSch.MicrobatchScheduler(JSch.BucketConfig(batch_sizes=BUCKETS))
    ts = TSch.MicrobatchScheduler(TSch.BucketConfig(batch_sizes=BUCKETS))
    jpools = list(jeng.predict_stream(iter([_requests(japi, jdata, qids)]),
                                      scheduler=js))
    tpools = list(teng.predict_stream(iter([_requests(tapi, tdata, qids)]),
                                      scheduler=ts))
    st = ts.stats
    assert st.tier0_answered > 0 and st.escalated > 0
    assert st.tier0_answered + st.escalated == 6 * len(tdata.models)
    assert st.submitted == st.escalated
    assert {f: getattr(st, f) for f in TIER_FIELDS} == \
        {f: getattr(js.stats, f) for f in TIER_FIELDS}
    assert st.as_dict()["tiers"] == js.stats.as_dict()["tiers"]
    _same_pools(jpools[0], tpools[0])
    np.testing.assert_array_equal(
        tapi.FixedAlphaPolicy(0.6).decide(tpools[0], teng).choices,
        japi.FixedAlphaPolicy(0.6).decide(jpools[0], jeng).choices)
    assert _cache_tiers(teng) == _cache_tiers(jeng)
    assert {t for _, _, t, _ in _cache_tiers(teng)} == {0, 1}


def test_quarantined_escalation_falls_back_to_tier0_row(setup):
    """A dispatch fault with ``max_retries=0``: the escalated pairs are
    answered DEGRADED from their stashed tier-0 rows on both sides, equal
    ledgers, p within tolerance of the head's own answer."""
    mk, jdata, tdata = setup["mk"], setup["jdata"], setup["tdata"]
    qids = jdata.test_qids[:4]
    _, t0 = mk(tier0=True, threshold=0.0)
    t0_pool = t0.predict(_requests(tapi, tdata, qids), use_cache=False)
    jeng, teng = mk(tier0=True, threshold=2.0, max_retries=0,
                    fault_plan=JF.FaultPlan([JF.FaultSpec("dispatch", 0)]))
    js = JSch.MicrobatchScheduler(JSch.BucketConfig(batch_sizes=BUCKETS))
    ts = TSch.MicrobatchScheduler(TSch.BucketConfig(batch_sizes=BUCKETS))
    jpools = list(jeng.predict_stream(iter([_requests(japi, jdata, qids)]),
                                      scheduler=js, use_cache=False))
    tpools = list(teng.predict_stream(iter([_requests(tapi, tdata, qids)]),
                                      scheduler=ts, use_cache=False))
    st = ts.stats
    assert st.quarantined > 0
    assert st.tier0_fallbacks == st.quarantined == st.degraded
    assert {f: getattr(st, f) for f in TIER_FIELDS} == \
        {f: getattr(js.stats, f) for f in TIER_FIELDS}
    _same_pools(jpools[0], tpools[0])
    deg = tpools[0].status == STATUS_DEGRADED
    assert int(deg.sum()) == st.quarantined
    np.testing.assert_array_equal(tpools[0].p_hat[deg], t0_pool.p_hat[deg])
    np.testing.assert_array_equal(tpools[0].len_hat[deg],
                                  t0_pool.len_hat[deg])
    assert (tpools[0].pred_overhead[deg] == 0).all()
    assert st.degraded + st.failed_pairs == \
        st.quarantined + st.deadline_expired


def test_degraded_tier0_cache_entry_is_tier0_like_reference(setup):
    mk, jdata, tdata = setup["mk"], setup["jdata"], setup["tdata"]
    qids = jdata.test_qids[:2]
    jeng, teng = mk(tier0=True, threshold=2.0, max_retries=0,
                    fault_plan=JF.FaultPlan([JF.FaultSpec("dispatch", 0)]))
    for eng, api, data, sch in ((jeng, japi, jdata, JSch),
                                (teng, tapi, tdata, TSch)):
        sched = sch.MicrobatchScheduler(sch.BucketConfig(batch_sizes=BUCKETS))
        list(eng.predict_stream(iter([_requests(api, data, qids)]),
                                scheduler=sched))
        assert sched.stats.tier0_fallbacks > 0
    assert _cache_tiers(teng) == _cache_tiers(jeng)
    deg = [(k, e) for k, e in teng.cache._store.items()
           if e.status == STATUS_DEGRADED]
    assert deg and all(e.tier == 0 for _, e in deg)


def test_stale_tier0_stash_refused_after_hot_swap(setup):
    """``degrade()`` refuses a tier-0 row stashed under a pre-swap version
    and falls to the retrieval prior, on both sides alike."""
    from repro.api.engine import _StreamControl as JControl
    from repro.api.engine import _StreamEntry as JEntry
    mk, jdata, tdata = setup["mk"], setup["jdata"], setup["tdata"]
    qids = jdata.test_qids[:1]

    def degrade_one(eng, api, data, sch, control_cls, entry_cls, swap):
        st = eng._prepare(_requests(api, data, qids), use_cache=False)
        assert st.t0_rows
        entry = entry_cls(st)
        sched = sch.MicrobatchScheduler(sch.BucketConfig(batch_sizes=BUCKETS))
        inflight = {}
        control = control_cls(eng, sched, inflight, use_cache=False)
        eng._submit_misses(st, entry, sched, inflight, False, 0, control)
        key = next(iter(control.t0_rows))
        assert control.t0_rows[key][0] == "v0"
        if swap:
            eng.hot_swap(eng.estimator, "v0+swap")
        control.degrade(key)
        assert entry.remaining == len(st.prompts) - 1
        assert entry.status[0] == STATUS_DEGRADED
        return (sched.stats.degraded, sched.stats.tier0_fallbacks,
                float(entry.p_conf[0]))

    for swap, want in ((False, (1, 1)), (True, (1, 0))):
        jeng, teng = mk(tier0=True, threshold=2.0)
        j = degrade_one(jeng, japi, jdata, JSch, JControl, JEntry, swap)
        t = degrade_one(teng, tapi, tdata, TSch, _StreamControl, _StreamEntry,
                        swap)
        assert t[:2] == j[:2] == want
        assert t[2] == pytest.approx(j[2], abs=F32_TOL)
