"""The multimodal-stub backbones' generation and serving against the JAX
package: greedy token streams (``generate``, and model-level with the
stubs), KV accounting and the paged refusal, the serving stack's refusal
of whisper, the cross caches through growth and refill, qwen2-vl's paged
stream at GQA group 7, and ``ScopeEngine.serve`` on the small qwen2-vl
(text-only).  Helpers, configs and tolerances are
``test_torch_multimodal.py``'s.
"""
import numpy as np
import pytest
import torch
from test_torch_multimodal import (F32_TOL, FAMILIES, G7, N_QUERIES,
                                   PROMPT_LEN, _caches_close, _configs, _np,
                                   _pair, _stub_batch, _jbatch, _tbatch)

from repro import api as japi
from repro.core.estimator import ReasoningEstimator as JEstimator
from repro.models import model as JM
from repro.serving import kv_pool as JK
from repro.serving import sampler as JS
from repro_torch import api as tapi
from repro_torch.core.estimator import ReasoningEstimator as TEstimator
from repro_torch.core.fingerprint import FingerprintLibrary, build_anchor_set
from repro_torch.core.retrieval import AnchorRetriever
from repro_torch.data.datasets import build_scope_data, stratified_anchors
from repro_torch.data.worldsim import World
from repro_torch.models import model as TM
from repro_torch.serving import kv_pool as TK
from repro_torch.serving import sampler as TS


# ---------------------------------------------------------------------------
# generation and the serving stack
# ---------------------------------------------------------------------------
def test_qwen2_vl_generate_token_streams_equal():
    jcfg, tcfg, params, tp = _pair("qwen2-vl-7b", G7, seed=18)
    prompts = np.random.default_rng(19).integers(4, 512, (4, PROMPT_LEN)) \
        .astype(np.int32)
    jg, jd = JS.generate(params, jcfg, prompts, max_new_tokens=8)
    tg, td = TS.generate(tp, tcfg, prompts, max_new_tokens=8)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_allclose(td, jd, atol=F32_TOL, rtol=F32_TOL)


def _greedy(TMod, params, cfg, batch, steps, to):
    """A model-level greedy loop, written alike for both sides: prefill
    with the stubs, then ``steps`` argmax decode steps."""
    toks = batch["tokens"]
    b, s = toks.shape
    logits, caches = TMod.prefill(params, cfg, to(batch))
    grow = TS._pad_caches if TMod is TM else JS._pad_caches
    caches = grow(caches, s + steps, s)
    last = np.asarray(_np(logits[:, -1])).argmax(-1).astype(np.int32)
    out, step_logits = [last], []
    for t in range(steps - 1):
        lg, caches = TMod.decode_step(
            params, cfg, to({"t": last[:, None]})["t"], caches,
            to({"p": np.full((b,), s + t, np.int32)})["p"])
        step_logits.append(_np(lg[:, 0]))
        last = step_logits[-1].argmax(-1).astype(np.int32)
        out.append(last)
    return np.stack(out, 1), np.stack(step_logits, 1)


@pytest.mark.parametrize("name", FAMILIES)
def test_model_level_greedy_streams_equal(name):
    """whisper served as the reference can serve it: prefill with
    ``enc_features``, then greedy ``decode_step``; qwen2-vl likewise with
    an image prefill."""
    jcfg, tcfg, params, tp = _pair(name, seed=20)
    batch = _stub_batch(tcfg, 3, 20, seed=21)
    tg, tl = _greedy(TM, tp, tcfg, batch, 10, _tbatch)
    jg, jl = _greedy(JM, params, jcfg, batch, 10, _jbatch)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_allclose(tl, jl, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_kv_bytes_and_paged_support_equal_jax(name):
    """Both count self-attention K/V only (whisper's cross caches, fixed per
    row, are left out: ROADMAP Queue 3); whisper is refused paged KV with
    the reference's message."""
    jcfg, tcfg = _configs(name)
    assert TK.kv_bytes_per_token(tcfg) == JK.kv_bytes_per_token(jcfg) == (
        2 * tcfg.num_kv_heads * tcfg.resolved_head_dim * 2 * tcfg.num_layers)
    if name == "whisper-medium":
        msgs = []
        for K, cfg in ((JK, jcfg), (TK, tcfg)):
            with pytest.raises(ValueError, match="decoder-only") as e:
                K.check_paged_support(cfg)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    else:
        JK.check_paged_support(jcfg)
        TK.check_paged_support(tcfg)


def test_serving_stack_refuses_whisper_on_both_sides():
    """The sampler prefills tokens only, and an encoder-decoder's forward
    needs ``enc_features``: both packages raise in the same place."""
    jcfg, tcfg, params, tp = _pair("whisper-medium")
    prompts = np.random.default_rng(22).integers(4, 512, (2, 10)).astype(
        np.int32)
    with pytest.raises(KeyError, match="enc_features"):
        JS.generate(params, jcfg, prompts, max_new_tokens=4)
    with pytest.raises(KeyError, match="enc_features"):
        TS.generate(tp, tcfg, prompts, max_new_tokens=4)
    for S, p, cfg, K in ((JS, params, jcfg, JK), (TS, tp, tcfg, TK)):
        with pytest.raises(ValueError, match="decoder-only"):
            S.prefill_state(p, cfg, prompts, max_new_tokens=4,
                            kv_pool=K.KVPool(16, 8))


def test_cross_caches_pass_through_growth_and_merge_by_rows():
    """``_pad_caches`` grows k / v only (ck / cv pass through as they are,
    on both sides); refill's row merge copies every leaf's rows, the cross
    caches' too."""
    jcfg, tcfg, params, tp = _pair("whisper-medium", seed=23)
    batch = _stub_batch(tcfg, 3, 10, seed=24)
    _, jc = JM.prefill(params, jcfg, _jbatch(batch))
    _, tc = TM.prefill(tp, tcfg, _tbatch(batch))
    jg, tg = JS._pad_caches(jc, 16, 10), TS._pad_caches(tc, 16, 10)
    assert tg[0]["0"]["ck"] is tc[0]["0"]["ck"]
    assert tuple(tg[0]["0"]["k"].shape) == (2, 3, 4, 16, 64)
    _caches_close(tg, jg)
    state = TM.init_cache(tcfg, 4, 16, device="cpu")
    TS._merge_rows(state, tc, torch.tensor([3, 1]), torch.tensor([0, 2]))
    for name in ("k", "v", "ck", "cv"):
        got, new = state[0]["0"][name], tc[0]["0"][name]
        width = new.shape[3]
        assert torch.equal(got[:, 3, :, :width], new[:, 0]), name
        assert torch.equal(got[:, 1, :, :width], new[:, 2]), name
        assert not got[:, [0, 2]].any(), name


@pytest.fixture(scope="module")
def g7_pair():
    return _pair("qwen2-vl-7b", G7, seed=25)


def test_qwen2_vl_paged_stream_equals_dense_and_reference(g7_pair):
    """GQA group 7 over 8-token pages: ragged prompts, three segments and a
    fused refill; port paged == port dense bit for bit and == the JAX paged
    path in tokens (logits to 2e-5)."""
    jcfg, tcfg, params, tp = g7_pair
    rng = np.random.default_rng(26)
    prompts = rng.integers(3, 500, (3, 20)).astype(np.int32)
    lens = [20, 13, 7]
    dense = TS.prefill_state(tp, tcfg, prompts, max_new_tokens=14,
                             prompt_lens=lens)
    tpool = TK.KVPool(n_pages=64, page_size=8)
    paged = TS.prefill_state(tp, tcfg, prompts, max_new_tokens=14,
                             prompt_lens=lens, kv_pool=tpool)
    jpool = JK.KVPool(n_pages=64, page_size=8)
    jpaged = JS.prefill_state(params, jcfg, prompts, max_new_tokens=14,
                              prompt_lens=lens, kv_pool=jpool)
    assert torch.equal(dense.last_logits, paged.last_logits)
    mat = np.zeros((3, 20), np.int32)
    mat[1] = rng.integers(3, 500, (20,))
    refill = (np.array([False, True, False]), mat,
              np.array([1, 12, 1], np.int64))
    for steps, rf in ((4, None), (4, refill), (3, None)):
        dense, g0, d0 = TS.decode_segment(tp, tcfg, dense, steps, refill=rf)
        paged, g1, d1 = TS.decode_segment(tp, tcfg, paged, steps, refill=rf)
        jpaged, g2, d2 = JS.decode_segment(params, jcfg, jpaged, steps,
                                           refill=rf)
        assert torch.equal(g0, g1) and torch.equal(d0, d1)
        np.testing.assert_array_equal(g1.numpy(), np.asarray(g2))
        np.testing.assert_allclose(d1.numpy(), np.asarray(d2), atol=F32_TOL,
                                   rtol=F32_TOL)
    assert (tpool.pages_peak, tpool.tokens_peak) == (jpool.pages_peak,
                                                     jpool.tokens_peak)


# ---------------------------------------------------------------------------
# the slice as a whole: ScopeEngine.serve on the reduced qwen2-vl, text-only
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_world():
    world = World(seed=0)
    data = build_scope_data(world, n_queries=200, seed=0)
    anchors = build_anchor_set(world, stratified_anchors(world, n=80, seed=7))
    lib = FingerprintLibrary(anchors)
    for m in world.pool:
        if m.seen:
            lib.onboard(world, m.name, seed=3)
    return world, data, anchors, lib


@pytest.fixture(scope="module")
def engines(port_world, scope_data, library, retriever):
    jcfg, tcfg, params, tp = _pair("qwen2-vl-7b", seed=27)
    world, data, anchors, lib = port_world
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
def predicted(engines):
    """Both engines' pool predictions over the test queries, made once for
    both policies' serves."""
    jeng, teng, jdata, tdata, qids = engines
    return (jeng.predict(japi.RouteRequest([jdata.queries[q] for q in qids]),
                         use_cache=False),
            teng.predict(tapi.RouteRequest([tdata.queries[q] for q in qids]),
                         use_cache=False))


@pytest.mark.parametrize("policy", ["alpha0.7", "budget"])
def test_engine_serve_decisions_equal(engines, predicted, policy):
    jeng, teng, jdata, tdata, qids = engines
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
