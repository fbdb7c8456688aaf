"""The port's zamba2 hybrid against the JAX package on the same inputs.

zamba2-7b runs Mamba2 layers with one tied attention + MLP block after
every ``shared_attn_every``-th of them.  Here it is cut to
``reduced(num_layers=5, d_model=448)``: two units of (mamba, mamba,
shared_attn) and one trailing mamba, 4 heads of 112 (g = 1, zamba2's head
dim), float32, with weights bridged from the reference's seeded
``init_params``.  Config, plan, init and cache structure, the bridge, the
segments, the model, the sampler (generation, refill, guards) and
``ScopeEngine.serve`` are held to the reference: floats within 2e-5,
tokens and decisions equal.

The CUDA kernels the hybrid runs on the card (flash and dense decode at
head dim 112, the SSD scan and step) are held to their plain versions by
``chip_smoke.py``; on the CPU the model runs those plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_config as jget_config
from repro.core.estimator import ReasoningEstimator as JEstimator
from repro.models import model as JM
from repro.models import rope as JR
from repro.models import transformer as JT
from repro.serving import kv_pool as JK
from repro.serving import sampler as JS
from repro_torch import api as tapi
from repro_torch import io
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.estimator import ReasoningEstimator as TEstimator
from repro_torch.core.fingerprint import FingerprintLibrary, build_anchor_set
from repro_torch.core.retrieval import AnchorRetriever
from repro_torch.data.datasets import build_scope_data, stratified_anchors
from repro_torch.data.worldsim import World
from repro_torch.models import model as TM
from repro_torch.models import rope as TR
from repro_torch.models import transformer as TT
from repro_torch.serving import kv_pool as TK
from repro_torch.serving import sampler as TS

F32_TOL = 2e-5
N_QUERIES = 8
PROMPT_LEN = 49            # SCOPE's structured prompts: chunk 7 at ssm_chunk 16
SMALL = dict(num_layers=5, d_model=448)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _port_cfg(jcfg) -> ModelConfig:
    """The port's config with the JAX config's values for every port field."""
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                               rtol=F32_TOL, err_msg=what)


def _caches_close(tc, jc):
    jf, tf_ = _flat(jc), _flat(tc)
    assert set(jf) == set(tf_)
    for path, leaf in jf.items():
        assert tuple(tf_[path].shape) == tuple(leaf.shape), path
        _close(tf_[path], leaf, path)


@pytest.fixture(scope="module")
def hybrid_pair():
    jcfg = jget_config("zamba2-7b").reduced(**SMALL)
    tcfg = get_config("zamba2-7b").reduced(**SMALL)
    assert tcfg == _port_cfg(jcfg)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = io.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, tcfg, params, tp


def _prompts(seed, b, width=PROMPT_LEN):
    return np.random.default_rng(seed).integers(4, 512, (b, width)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# config, plan, init, bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [None, {}, SMALL],
                         ids=["full", "reduced", "reduced 5x448"])
def test_config_fields_equal_jax(kw):
    cfg, jcfg = get_config("zamba2-7b"), jget_config("zamba2-7b")
    if kw is not None:
        cfg, jcfg = cfg.reduced(**kw), jcfg.reduced(**kw)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.arch_type == "hybrid" and cfg.force_window == 0


def test_small_config_is_zamba2_head_geometry():
    cfg = get_config("zamba2-7b").reduced(**SMALL)
    assert (cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads) == \
        (112, 4, 4)
    full = get_config("zamba2-7b")
    assert (full.resolved_head_dim, full.num_heads, full.num_kv_heads) == \
        (112, 32, 32)
    assert (full.resolved_ssm_heads, full.ssm_head_dim, full.ssm_state) == \
        (112, 64, 64)


@pytest.mark.parametrize("kw", [None, SMALL, dict(num_layers=6)],
                         ids=["full", "reduced 5x448", "reduced 6"])
def test_build_plan_equal_jax(kw):
    cfg, jcfg = get_config("zamba2-7b"), jget_config("zamba2-7b")
    if kw is not None:
        cfg, jcfg = cfg.reduced(**kw), jcfg.reduced(**kw)
    assert TT.build_plan(cfg) == JT.build_plan(jcfg)
    if kw is None:
        assert TT.build_plan(cfg) == [(("mamba",) * 6 + ("shared_attn",), 13),
                                      (("mamba",), 3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_cache_match_jax_structure_and_dtypes(hybrid_pair,
                                                              dtype):
    """``shared_attn`` included: its matrices in the model dtype, its norm
    scales float32 (unstacked, so JAX's rank >= 2 cast passes them over);
    the shared block's K/V caches one per occurrence."""
    jcfg = dataclasses.replace(hybrid_pair[0], dtype=dtype)
    tcfg = _port_cfg(jcfg)
    for jtree, ttree in (
            (jax.eval_shape(lambda k: JM.init_params(k, jcfg),
                            jax.random.PRNGKey(0)),
             TM.init_params(tcfg, seed=0, device="cpu")),
            (jax.eval_shape(lambda: JM.init_cache(jcfg, 3, 20)),
             TM.init_cache(tcfg, 3, 20, device="cpu"))):
        jf, tf_ = _flat(jtree), _flat(ttree)
        assert set(jf) == set(tf_)
        for path, leaf in jf.items():
            assert tuple(tf_[path].shape) == tuple(leaf.shape), path
            want = torch.bfloat16 if leaf.dtype == jnp.bfloat16 \
                else torch.float32
            assert tf_[path].dtype == want, path
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    assert tp["shared_attn"]["attn_norm"]["scale"].dtype == torch.float32
    assert tuple(TM.init_cache(tcfg, 3, 20, device="cpu")[0]["2"]["k"].shape) \
        == (2, 3, 4, 20, 112)


def test_bridge_is_leaf_for_leaf(hybrid_pair):
    _, _, params, tp = hybrid_pair
    jf, tf_ = _flat(params), _flat(tp)
    assert set(jf) == set(tf_) and any("shared_attn" in k for k in jf)
    for path, leaf in jf.items():
        np.testing.assert_array_equal(_np(tf_[path]), _np(leaf),
                                      err_msg=path)


def test_bridge_refuses_a_tree_that_does_not_fit(hybrid_pair):
    """A hybrid tree bridged as a pure-SSM config and the other way round,
    and an untied head, are refused."""
    jcfg, tcfg, params, _ = hybrid_pair
    tree = jax.tree.map(np.asarray, params)
    pure = dataclasses.replace(tcfg, shared_attn_every=0)
    with pytest.raises(ValueError, match="shared_attn"):
        io.params_from_numpy(tree, pure, "cpu")
    no_shared = {k: v for k, v in tree.items() if k != "shared_attn"}
    with pytest.raises(ValueError, match="shared_attn"):
        io.params_from_numpy(no_shared, tcfg, "cpu")
    with pytest.raises(NotImplementedError, match="untied"):
        io.params_from_numpy(dict(tree, lm_head=tree["embed"].T), tcfg,
                             "cpu")
    with pytest.raises(NotImplementedError, match="untied"):
        TM.init_params(dataclasses.replace(tcfg, tie_embeddings=False),
                       device="cpu")


# ---------------------------------------------------------------------------
# segments and the model
# ---------------------------------------------------------------------------
def test_segment_full_and_decode_match_jax(hybrid_pair):
    """The hybrid unit's segment (2 x (mamba, mamba, shared_attn)): output
    and every per-occurrence cache of the full pass, then three decode
    steps writing into those caches in place."""
    jcfg, tcfg, params, tp = hybrid_pair
    (unit, count), = [u for u in TT.build_plan(tcfg) if "shared_attn" in u[0]]
    rng = np.random.default_rng(2)
    b = 2
    x = rng.standard_normal((b, PROMPT_LEN, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(PROMPT_LEN)[None], (b, PROMPT_LEN))
    hd = tcfg.resolved_head_dim
    jcos, jsin = JR.rope_cos_sin(jnp.asarray(pos), hd, jcfg.rope_theta)
    tcos, tsin = TR.rope_cos_sin(torch.tensor(pos), hd, tcfg.rope_theta)
    jh, _, jc = JT.segment_full(params["segments"][0], params["shared_attn"],
                                jcfg, unit, count, jnp.asarray(x), jcos, jsin)
    th, taux, tc = TT.segment_full(tp["segments"][0], tp["shared_attn"],
                                   tcfg, unit, count, torch.tensor(x), tcos,
                                   tsin)
    _close(th, jh, "h")
    assert float(taux) == 0.0
    _caches_close(tc, jc)
    assert tuple(tc["2"]["k"].shape) == (count, b, 4, PROMPT_LEN, 112)

    jc = JS._pad_caches((jc,), PROMPT_LEN + 3, PROMPT_LEN)[0]
    tc = TS._pad_caches((tc,), PROMPT_LEN + 3, PROMPT_LEN)[0]
    ids = {k: id(v) for k, v in _flat(tc).items()}
    for t in range(3):
        p = np.full((b,), PROMPT_LEN + t, np.int32)
        xt = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
        jcos, jsin = JR.rope_cos_sin(jnp.asarray(p)[:, None], hd,
                                     jcfg.rope_theta)
        tcos, tsin = TR.rope_cos_sin(torch.tensor(p)[:, None], hd,
                                     tcfg.rope_theta)
        jh, jc = JT.segment_decode(params["segments"][0],
                                   params["shared_attn"], jcfg, unit, count,
                                   jnp.asarray(xt), jcos, jsin, jc,
                                   jnp.asarray(p))
        th = TT.segment_decode(tp["segments"][0], tp["shared_attn"], tcfg,
                               unit, count, torch.tensor(xt), tcos, tsin, tc,
                               torch.tensor(p))
        _close(th, jh, f"decode step {t}")
    assert {k: id(v) for k, v in _flat(tc).items()} == ids
    _caches_close(tc, jc)


def test_shared_block_is_one_tied_set(hybrid_pair):
    """Every shared_attn occurrence reads the one model-level set: changing
    it moves the output, and the segments hold no copy of it."""
    _, tcfg, _, tp = hybrid_pair
    assert all("2" not in seg for seg in tp["segments"])
    toks = torch.tensor(_prompts(3, 2, 9))
    base, _ = TM.prefill(tp, tcfg, {"tokens": toks})
    bumped = dict(tp, shared_attn=io.tree_map(lambda t: t * 1.5,
                                              tp["shared_attn"]))
    moved, _ = TM.prefill(bumped, tcfg, {"tokens": toks})
    assert not torch.allclose(base, moved)


def test_prefill_and_decode_logits_match_jax(hybrid_pair):
    jcfg, tcfg, params, tp = hybrid_pair
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (3, PROMPT_LEN)).astype(np.int32)
    steps = rng.integers(0, 512, (3, 3)).astype(np.int32)
    jl, jc = JM.prefill(params, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.tensor(toks)})
    _close(tl, jl, "prefill logits")
    _caches_close(tc, jc)
    jc = JS._pad_caches(jc, PROMPT_LEN + 3, PROMPT_LEN)
    tc = TS._pad_caches(tc, PROMPT_LEN + 3, PROMPT_LEN)
    pos = np.full((3,), PROMPT_LEN, np.int32)
    for t in range(3):
        jl, jc = JM.decode_step(params, jcfg, jnp.asarray(steps[:, t:t + 1]),
                                jc, jnp.asarray(pos + t))
        tl, tc2 = TM.decode_step(tp, tcfg, torch.tensor(steps[:, t:t + 1]),
                                 tc, torch.tensor(pos + t))
        assert tc2 is tc
        _close(tl, jl, f"decode logits step {t}")
    _caches_close(tc, jc)


def test_windowed_variant_matches_jax_and_ring_decode_raises(hybrid_pair):
    """``force_window`` windows the shared block as in JAX: below the
    window's cache size (the window passes to the attention kernels'
    plain versions) generation matches; a windowed stack cannot decode
    over paged KV, whose pages have no ring buffer: it raises, as in
    JAX."""
    jcfg, tcfg, params, tp = hybrid_pair
    jw = dataclasses.replace(jcfg, force_window=20)
    tw = dataclasses.replace(tcfg, force_window=20)
    prompts = _prompts(8, 2, 30)
    jg, jd = JS.generate(params, jw, prompts, max_new_tokens=4)
    tg, td = TS.generate(tp, tw, prompts, max_new_tokens=4)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_allclose(td, jd, atol=F32_TOL, rtol=F32_TOL)
    # an attention-only stack with a window is refused paged KV, as in JAX
    for K, cfg in ((JK, jget_config("scope-tiny")),
                   (TK, get_config("scope-tiny"))):
        K.check_paged_support(cfg)
        with pytest.raises(ValueError, match="sliding-window"):
            K.check_paged_support(dataclasses.replace(cfg, force_window=16))


def test_ring_buffer_decode_matches_jax(hybrid_pair):
    """At a cache of exactly ``window`` slots the shared block's decode
    runs the ring buffer (slot ``pos % window``, ``min(pos + 1, window)``
    keys): each step's logits and every per-occurrence cache as JAX's over
    12 steps from position 0, rows at different positions."""
    jcfg, tcfg, params, tp = hybrid_pair
    jr = dataclasses.replace(jcfg, force_window=4)
    tr = dataclasses.replace(tcfg, force_window=4)
    ring = TM.init_cache(tr, 2, 40, device="cpu")
    assert ring[0]["2"]["k"].shape[3] == 4
    jring = JM.init_cache(jr, 2, 40)
    toks = np.random.default_rng(9).integers(0, 512, (2, 12)).astype(
        np.int32)
    for t in range(12):
        pos = np.array([t, t + 3], np.int32)
        jl, jring = JM.decode_step(params, jr, jnp.asarray(toks[:, t:t + 1]),
                                   jring, jnp.asarray(pos))
        tl, ring = TM.decode_step(tp, tr, torch.tensor(toks[:, t:t + 1]),
                                  ring, torch.tensor(pos))
        _close(tl, jl, f"ring decode step {t}")
    _caches_close(ring, jring)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------
def test_generate_token_streams_equal(hybrid_pair):
    jcfg, tcfg, params, tp = hybrid_pair
    prompts = _prompts(4, 4)
    jg, jd = JS.generate(params, jcfg, prompts, max_new_tokens=8)
    tg, td = TS.generate(tp, tcfg, prompts, max_new_tokens=8)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_allclose(td, jd, atol=F32_TOL, rtol=F32_TOL)


def test_ragged_padded_and_paged_guards_raise_as_in_jax(hybrid_pair):
    jcfg, tcfg, params, tp = hybrid_pair
    prompts = _prompts(5, 2)
    ragged = [PROMPT_LEN, PROMPT_LEN - 4]
    for S, p, cfg in ((JS, params, jcfg), (TS, tp, tcfg)):
        with pytest.raises(ValueError,
                           match="ragged prompt_lens require an attention"):
            S.prefill_state(p, cfg, prompts, max_new_tokens=4,
                            prompt_lens=ragged)
        st = S.prefill_state(p, cfg, prompts, max_new_tokens=4,
                             prompt_lens=[PROMPT_LEN] * 2)   # exact fit
        with pytest.raises(ValueError, match="padded refill requires"):
            S.refill_slots(p, cfg, st, [1], prompts[:1],
                           prompt_lens=[PROMPT_LEN - 1])
    for K, cfg in ((JK, jcfg), (TK, tcfg)):
        with pytest.raises(ValueError, match="attention-only GQA backbone"):
            K.check_paged_support(cfg)
    with pytest.raises(ValueError, match="attention-only GQA backbone"):
        TS.prefill_state(tp, tcfg, prompts, max_new_tokens=4,
                         kv_pool=TK.KVPool(16, 8))
    # the KV a token costs counts attention layer kinds, as in JAX: none
    # for the hybrid, whose shared block is not a layer kind
    assert TK.kv_bytes_per_token(tcfg) == JK.kv_bytes_per_token(jcfg) == 0


@pytest.mark.parametrize("fused", [False, True])
def test_refill_replaces_conv_ssm_and_shared_kv_rows_like_jax(hybrid_pair,
                                                             fused):
    """Decode, refill slot 1 with a fresh exact-fit prompt, decode again:
    tokens, decision logits and every cache (conv, SSM state and each
    shared-block occurrence's K/V rows) as in JAX's ``refill_slots`` /
    fused ``decode_segment(refill=...)``."""
    jcfg, tcfg, params, tp = hybrid_pair
    prompts, fresh = _prompts(6, 3), _prompts(7, 3)
    js = JS.prefill_state(params, jcfg, prompts, max_new_tokens=8)
    ts = TS.prefill_state(tp, tcfg, prompts, max_new_tokens=8)
    js, jg1, _ = JS.decode_segment(params, jcfg, js, 3)
    ts, tg1, _ = TS.decode_segment(tp, tcfg, ts, 3)
    np.testing.assert_array_equal(tg1.numpy(), np.asarray(jg1))
    if fused:
        mask = np.array([False, True, False])
        refill = (mask, fresh, [PROMPT_LEN] * 3)
        js, jg2, jd2 = JS.decode_segment(params, jcfg, js, 4, refill=refill)
        ts, tg2, td2 = TS.decode_segment(tp, tcfg, ts, 4, refill=refill)
    else:
        js = JS.refill_slots(params, jcfg, js, [1], fresh[1:2])
        ts = TS.refill_slots(tp, tcfg, ts, [1], fresh[1:2])
        js, jg2, jd2 = JS.decode_segment(params, jcfg, js, 4)
        ts, tg2, td2 = TS.decode_segment(tp, tcfg, ts, 4)
    np.testing.assert_array_equal(tg2.numpy(), np.asarray(jg2))
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), atol=F32_TOL,
                               rtol=F32_TOL)
    _caches_close(ts.caches, js.caches)
    # the refilled row decodes as a fresh run of its own prompt
    alone_g, _ = TS.generate(tp, tcfg, fresh[1:2], max_new_tokens=4)
    np.testing.assert_array_equal(tg2.numpy()[1], alone_g[0])


# ---------------------------------------------------------------------------
# the slice as a whole: ScopeEngine.serve on a hybrid estimator
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def hybrid_engines(hybrid_pair, scope_data, library, retriever):
    jcfg, tcfg, params, tp = hybrid_pair
    world = World(seed=0)
    data = build_scope_data(world, n_queries=200, seed=0)
    anchors = build_anchor_set(world, stratified_anchors(world, n=80, seed=7))
    lib = FingerprintLibrary(anchors)
    for m in world.pool:
        if m.seen:
            lib.onboard(world, m.name, seed=3)
    jeng = japi.ScopeEngine.build(japi.EngineConfig(
        estimator=JEstimator(jcfg, params), retriever=retriever,
        library=library,
        models_meta={m: scope_data.world.models[m]
                     for m in scope_data.models}))
    teng = tapi.ScopeEngine.build(tapi.EngineConfig(
        estimator=TEstimator(tcfg, tp),
        retriever=AnchorRetriever(anchors, device="cpu"), library=lib,
        models_meta={m: world.models[m] for m in data.models}))
    qids = [int(q) for q in scope_data.test_qids[:N_QUERIES]]
    return jeng, teng, scope_data, data, qids


@pytest.fixture(scope="module")
def predicted(hybrid_engines):
    """Both engines' pool predictions over the test queries, made once for
    both policies' serves."""
    jeng, teng, jdata, tdata, qids = hybrid_engines
    return (jeng.predict(japi.RouteRequest([jdata.queries[q] for q in qids]),
                         use_cache=False),
            teng.predict(tapi.RouteRequest([tdata.queries[q] for q in qids]),
                         use_cache=False))


@pytest.mark.parametrize("policy", ["alpha0.7", "budget"])
def test_engine_serve_decisions_equal(hybrid_engines, predicted, policy):
    jeng, teng, jdata, tdata, qids = hybrid_engines
    jp, tp = predicted
    for f in ("y_hat", "len_hat", "well_formed", "pred_overhead"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f)
    np.testing.assert_allclose(tp.p_hat, jp.p_hat, atol=F32_TOL)
    if policy == "budget":
        budget = float(jp.cost_hat.min(axis=1).sum() * 1.5)
        jpol, tpol = japi.SetBudgetPolicy(budget), tapi.SetBudgetPolicy(budget)
    else:
        jpol, tpol = japi.FixedAlphaPolicy(0.7), tapi.FixedAlphaPolicy(0.7)
    jeng.cache.clear()
    teng.cache.clear()
    jr = jeng.serve(jdata, qids, jpol)
    tr = teng.serve(tdata, qids, tpol)
    assert len(tr.decisions) == len(qids)
    assert [d.model for d in tr.decisions] == [d.model for d in jr.decisions]
    np.testing.assert_allclose([d.p_hat for d in tr.decisions],
                               [d.p_hat for d in jr.decisions], atol=F32_TOL)
    assert (tr.cache_hits, tr.cache_misses) == (jr.cache_hits,
                                                jr.cache_misses)
    assert tr.overhead_tokens == jr.overhead_tokens
