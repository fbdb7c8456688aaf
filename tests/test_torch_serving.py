"""The port's generation loop, parse and numpy data path against JAX:
greedy token streams (ragged prompts included), decision logits, the EOS
done-mask, the sampling contract, and the copied world / data / retrieval /
serialization modules."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.scope_estimator import TINY as JTINY
from repro.core import estimator as JE
from repro.core import fingerprint as JF
from repro.core import retrieval as JR
from repro.core import serialization as JSer
from repro.data import datasets as JD
from repro.data import tokenizer as jtok
from repro.data import worldsim as JW
from repro.models import model as JM
from repro.serving import sampler as JS
from repro_torch import io
from repro_torch.configs.scope_estimator import TINY
from repro_torch.core import estimator as TE
from repro_torch.core import fingerprint as TF
from repro_torch.core import retrieval as TR
from repro_torch.core import serialization as TSer
from repro_torch.data import datasets as TD
from repro_torch.data import tokenizer as ttok
from repro_torch.data import worldsim as TW
from repro_torch.serving import sampler as TS

F32_TOL = 2e-5


@pytest.fixture(scope="module")
def bridged():
    params = JM.init_params(jax.random.PRNGKey(1), JTINY)
    tp = io.params_from_numpy(jax.tree.map(np.asarray, params), TINY, "cpu")
    return params, tp


def test_generate_matches_jax_ragged(bridged):
    params, tp = bridged
    rng = np.random.default_rng(2)
    toks = rng.integers(16, 512, (4, 15)).astype(np.int32)
    lens = np.array([15, 7, 11, 15])
    jg, jd = JS.generate(params, JTINY, toks, max_new_tokens=8,
                         prompt_lens=lens)
    tg, td = TS.generate(tp, TINY, toks, max_new_tokens=8, prompt_lens=lens)
    assert tg.dtype == np.int32 and td.dtype == np.float32
    assert tg.shape == (4, 8) and td.shape == (4, 8, 2)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_allclose(td, jd, atol=F32_TOL, rtol=F32_TOL)
    # a padded row reproduces its unpadded run
    g1, d1 = TS.generate(tp, TINY, toks[1:2, :7], max_new_tokens=8)
    np.testing.assert_array_equal(g1[0], tg[1])
    np.testing.assert_allclose(d1[0], td[1], atol=F32_TOL)


def test_done_rows_keep_emitting_pad(bridged):
    """Rows marked done (as after EOS) emit PAD for every later step, and
    the live rows are untouched by them — as in JAX."""
    params, tp = bridged
    toks = np.random.default_rng(3).integers(16, 512, (3, 9)).astype(np.int32)
    jst = JS.prefill_state(params, JTINY, toks, max_new_tokens=5)
    jst = dataclasses.replace(jst, done=jnp.asarray([True, False, True]))
    _, jg, jd = JS.decode_segment(params, JTINY, jst, 5)
    tst = TS.prefill_state(tp, TINY, toks, max_new_tokens=5)
    tst.done = torch.tensor([True, False, True])
    new, tg, td = TS.decode_segment(tp, TINY, tst, 5)
    tg, td = TS.to_host(tg, td)
    assert (tg[[0, 2]] == ttok.PAD).all()
    np.testing.assert_array_equal(tg, np.asarray(jg))
    np.testing.assert_allclose(td, np.asarray(jd), atol=F32_TOL)
    assert new.done.tolist()[0] and new.done.tolist()[2]
    assert new.positions.tolist() == [14, 14, 14] and new.used == 14


def test_eos_sets_done_and_pads_after(bridged):
    """Force EOS by making its embedding row dominate the tied head: the
    emitting row is done from then on and decodes PAD, in both packages."""
    params, tp = bridged
    jp = dict(params)
    jp["embed"] = params["embed"].at[jtok.EOS].multiply(40.0)
    tq = dict(tp)
    tq["embed"] = tp["embed"].clone()
    tq["embed"][ttok.EOS] *= 40.0
    toks = np.random.default_rng(4).integers(16, 512, (2, 6)).astype(np.int32)
    jg, _ = JS.generate(jp, JTINY, toks, max_new_tokens=4)
    tg, _ = TS.generate(tq, TINY, toks, max_new_tokens=4)
    np.testing.assert_array_equal(tg, jg)
    hit = (tg == ttok.EOS).any(axis=1)
    assert hit.any()
    for row in np.flatnonzero(hit):
        f = int(np.argmax(tg[row] == ttok.EOS))
        assert (tg[row, f + 1:] == ttok.PAD).all()


def test_temperature_needs_a_generator(bridged):
    _, tp = bridged
    toks = np.zeros((2, 5), np.int32) + 20
    with pytest.raises(ValueError, match="Generator"):
        TS.generate(tp, TINY, toks, max_new_tokens=3, temperature=0.7)
    st = TS.prefill_state(tp, TINY, toks, max_new_tokens=3)
    with pytest.raises(ValueError, match="Generator"):
        TS.decode_segment(tp, TINY, st, 3, temperature=0.7)
    a = TS.generate(tp, TINY, toks, max_new_tokens=3, temperature=0.7,
                    generator=torch.Generator().manual_seed(5))
    b = TS.generate(tp, TINY, toks, max_new_tokens=3, temperature=0.7,
                    generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(a[0], b[0])


def test_segment_overrun_and_bad_lengths_raise(bridged):
    _, tp = bridged
    toks = np.zeros((2, 5), np.int32) + 20
    st = TS.prefill_state(tp, TINY, toks, max_new_tokens=3)
    with pytest.raises(ValueError, match="overruns"):
        TS.decode_segment(tp, TINY, st, 4)
    with pytest.raises(ValueError, match="prompt_lens"):
        TS.prefill_state(tp, TINY, toks, max_new_tokens=3,
                         prompt_lens=[0, 5])


def _random_generations(seed, n=64, t=12):
    rng = np.random.default_rng(seed)
    vocab = [jtok.PAD, jtok.EOS, jtok.THINK, jtok.THINK_END, jtok.YES,
             jtok.NO, jtok.LEN_BASE + 3, jtok.LEN_BASE + 40, 200]
    gen = rng.choice(vocab, size=(n, t)).astype(np.int32)
    gen[:8, :5] = [jtok.THINK, 200, jtok.THINK_END, jtok.YES,
                   jtok.LEN_BASE + 7]
    gen[:8, 5] = jtok.EOS
    gen[:8, 6:] = jtok.PAD
    dec = rng.standard_normal((n, t, 2)).astype(np.float32)
    return gen, dec


def test_parse_generations_equal():
    gen, dec = _random_generations(0)
    jb = JE.parse_generations(gen, dec)
    tb = TE.parse_generations(gen, dec)
    for f in ("y_hat", "len_hat", "well_formed", "p_conf", "pred_tokens",
              "rationale_len", "status"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f),
                                      err_msg=f)
    assert tb.well_formed[:8].all()
    for i in range(16):
        assert TE.ReasoningEstimator._parse_one(gen[i], dec[i]) == \
            tb.to_predictions()[i]


def test_estimator_predict_batch_matches_jax(bridged):
    params, tp = bridged
    toks = np.random.default_rng(6).integers(16, 512, (5, 10)).tolist()
    jb = JE.ReasoningEstimator(JTINY, params, max_new_tokens=6,
                               batch_size=2).predict_batch(toks)
    tb = TE.ReasoningEstimator(TINY, tp, max_new_tokens=6,
                               batch_size=2).predict_batch(toks)
    for f in ("y_hat", "len_hat", "well_formed", "pred_tokens",
              "rationale_len"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
    np.testing.assert_allclose(tb.p_conf, jb.p_conf, atol=F32_TOL)


# ---------------------------------------------------------------------------
# numpy copies: world, data, anchors, fingerprints, serialization, retrieval
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def worlds():
    jw, tw = JW.World(seed=0), TW.World(seed=0)
    jd = JD.build_scope_data(jw, n_queries=200, seed=0)
    td = TD.build_scope_data(tw, n_queries=200, seed=0)
    ja = JF.build_anchor_set(jw, JD.stratified_anchors(jw, n=80, seed=7))
    ta = TF.build_anchor_set(tw, TD.stratified_anchors(tw, n=80, seed=7))
    return (jw, jd, ja), (tw, td, ta)


def test_world_and_data_identical(worlds):
    (jw, jd, ja), (tw, td, ta) = worlds
    np.testing.assert_array_equal(tw.centers, jw.centers)
    assert [m.name for m in tw.pool] == [m.name for m in jw.pool]
    assert td.models == jd.models
    np.testing.assert_array_equal(td.test_qids, jd.test_qids)
    np.testing.assert_array_equal(td.train_qids, jd.train_qids)
    for jq, tq in zip(jd.queries, td.queries, strict=True):
        assert (tq.qid, tq.domain) == (jq.qid, jq.domain)
        np.testing.assert_array_equal(tq.embedding, jq.embedding)
    assert {k: dataclasses.astuple(v) for k, v in td.records.items()} == \
        {k: dataclasses.astuple(v) for k, v in jd.records.items()}
    np.testing.assert_array_equal(ta.embeddings, ja.embeddings)
    for m in [p.name for p in jw.pool[::3]]:
        jfp = JF.build_fingerprint(jw, m, ja, seed=3)
        tfp = TF.build_fingerprint(tw, m, ta, seed=3)
        for f in ("y", "tokens", "cost"):
            np.testing.assert_array_equal(getattr(tfp, f), getattr(jfp, f))


def test_retrieval_and_serialized_prompts_identical(worlds):
    (jw, jd, ja), (tw, td, ta) = worlds
    jlib, tlib = JF.FingerprintLibrary(ja), TF.FingerprintLibrary(ta)
    for m in jw.pool:
        if m.seen:
            jlib.onboard(jw, m.name, seed=3)
            tlib.onboard(tw, m.name, seed=3)
    qids = [int(q) for q in jd.test_qids[:10]]
    jemb = np.stack([jd.queries[q].embedding for q in qids])
    temb = np.stack([td.queries[q].embedding for q in qids])
    js, ji = JR.AnchorRetriever(ja).retrieve(jemb, 5)
    ts, ti = TR.AnchorRetriever(ta, device="cpu").retrieve(temb, 5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=1e-5)
    for qi, q in enumerate(qids):
        for mi, m in enumerate(jd.models):
            jp = JSer.serialize_prompt(jw.models[m], mi, ja, jlib.get(m),
                                       js[qi], ji[qi], jd.queries[q])
            tp = TSer.serialize_prompt(tw.models[m], mi, ta, tlib.get(m),
                                       ts[qi], ti[qi], td.queries[q])
            assert tp == jp
