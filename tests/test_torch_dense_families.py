"""The port's dense-attention families against the JAX package on the same
inputs: starcoder2-3b and internlm2-1.8b (plain ``attn`` stacks; starcoder2
at GQA group 12) and gemma2-2b / gemma2-9b (one unit ``("attn_local",
"attn")`` repeated, logit softcaps on the attention scores and the LM head,
post-norms around attention and MLP, embeddings scaled by sqrt(d_model),
and the ring-buffer decode of a window-sized cache).

Small configs in float32 with weights bridged from the reference's seeded
``init_params``.  Tolerances: floats within 2e-5 (logits, caches,
confidences), tokens and decisions equal, every gradient leaf within 1e-4
of that leaf's largest magnitude, the scaled bf16 embedding bit for bit.

On the card the same paths run the flash, dense decode and paged decode
kernels, which ``chip_smoke.py`` holds to their plain versions at these
families' shapes (group 12; head dim 256 with softcap 50 and a window);
here the model runs those plain versions.
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
from repro.models import common as JC
from repro.models import model as JM
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
from repro_torch.data import pipeline as tpipe
from repro_torch.data.datasets import build_scope_data, stratified_anchors
from repro_torch.data.worldsim import World
from repro_torch.models import common as TC
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serving import kv_pool as TK
from repro_torch.serving import sampler as TS
from repro_torch.training import optimizer as TOpt

F32_TOL = 2e-5
GRAD_TOL = 1e-4
N_QUERIES = 8
PROMPT_LEN = 49
FAMILIES = ("starcoder2-3b", "internlm2-1.8b", "gemma2-2b", "gemma2-9b")
# the twins of tests/test_decode_parity.py's dense families
PARITY_FAMILIES = ("internlm2-1.8b", "starcoder2-3b", "gemma2-2b")
# the engines' small configs: starcoder2 at its full-width GQA group 12
# (24 heads of 32 on 2 kv-heads), gemma2 at its head dim 256 (2 heads on 1
# kv-head) with a window of 16, shorter than the 49-token prompts
ENGINE_CONFIGS = {
    "starcoder2 g12": ("starcoder2-3b", dict(d_model=768, num_heads=24), {}),
    "gemma2 d256 window 16": ("gemma2-9b", dict(d_model=512, num_heads=2),
                              dict(num_kv_heads=1, sliding_window=16)),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


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


def _configs(name, kw=None, replace=None):
    """(JAX config, port config): ``reduced(**kw)`` of ``name`` (kw None:
    the full config), then ``replace`` on both."""
    jcfg, tcfg = jget_config(name), get_config(name)
    if kw is not None:
        jcfg, tcfg = jcfg.reduced(**kw), tcfg.reduced(**kw)
    if replace:
        jcfg = dataclasses.replace(jcfg, **replace)
        tcfg = dataclasses.replace(tcfg, **replace)
    return jcfg, tcfg


def _pair(name, kw=None, replace=None, seed=0):
    jcfg, tcfg = _configs(name, {} if kw is None else kw, replace)
    params = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = io.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, tcfg, params, tp


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return _pair(request.param)


def _prompts(seed, b, width=PROMPT_LEN, vocab=512):
    return np.random.default_rng(seed).integers(4, vocab, (b, width)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs, plans, init, the bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [None, {}], ids=["full", "reduced"])
@pytest.mark.parametrize("name", FAMILIES)
def test_config_fields_equal_jax(name, kw):
    jcfg, tcfg = _configs(name, kw)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert get_config(name).name == name
    gemma = name.startswith("gemma2")
    assert tcfg.sandwich_norm == tcfg.scale_embeddings == gemma
    assert (tcfg.logit_softcap, tcfg.final_logit_softcap) == (
        (50.0, 30.0) if gemma else (0.0, 0.0))
    assert tcfg.attn_scale == 0.0
    if kw is not None:
        assert tcfg.sliding_window == 64 and tcfg.dtype == "float32"


def test_full_width_geometry():
    """The shapes the card's kernels meet: starcoder2's group of 12,
    gemma2's heads of 256, and the parameter counts at full width."""
    want = {"starcoder2-3b": (24, 2, 128, 30), "internlm2-1.8b": (16, 8, 128,
                                                                  24),
            "gemma2-2b": (8, 4, 256, 26), "gemma2-9b": (16, 8, 256, 42)}
    for name, geom in want.items():
        cfg = get_config(name)
        assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                cfg.num_layers) == geom, name
    cfg = get_config("starcoder2-3b").reduced(**ENGINE_CONFIGS[
        "starcoder2 g12"][1])
    assert cfg.num_heads // cfg.num_kv_heads == 12
    assert cfg.resolved_head_dim == 32


@pytest.mark.parametrize("kw", [None, {}, dict(num_layers=3),
                                dict(num_layers=6)],
                         ids=["full", "reduced", "odd 3", "reduced 6"])
@pytest.mark.parametrize("name", FAMILIES)
def test_build_plan_equal_jax(name, kw):
    jcfg, tcfg = _configs(name, kw)
    plan = TT.build_plan(tcfg)
    assert plan == JT.build_plan(jcfg)
    n = tcfg.num_layers
    if not name.startswith("gemma2"):
        assert plan == [(("attn",), n)]
    elif n % 2 == 0:
        assert plan == [(("attn_local", "attn"), n // 2)]
    else:                   # an odd depth falls back to grouping runs
        assert plan == [(("attn_local",), 1), (("attn",), 1),
                        (("attn_local",), 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_and_cache_match_jax_structure_and_dtypes(name, dtype):
    """The post-norms stacked with the layer (rank 2, so in the model
    dtype, as JAX's post-stacking cast leaves them); the final norm float32;
    gemma2's cache one (count, b, hkv, S, hd) stack a unit position, its
    local layers' at ``min(max_len, window)`` slots."""
    jcfg, tcfg = _configs(name, {}, dict(dtype=dtype))
    for jtree, ttree in (
            (jax.eval_shape(lambda k: JM.init_params(k, jcfg),
                            jax.random.PRNGKey(0)),
             TM.init_params(tcfg, seed=0, device="cpu")),
            (jax.eval_shape(lambda: JM.init_cache(jcfg, 3, 80)),
             TM.init_cache(tcfg, 3, 80, device="cpu"))):
        jf, tf_ = _flat(jtree), _flat(ttree)
        assert set(jf) == set(tf_)
        for path, leaf in jf.items():
            assert tuple(tf_[path].shape) == tuple(leaf.shape), path
            want = torch.bfloat16 if leaf.dtype == jnp.bfloat16 \
                else torch.float32
            assert tf_[path].dtype == want, path
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    block = tp["segments"][0]["0"]
    assert ("post_attn_norm" in block) == name.startswith("gemma2")
    if name.startswith("gemma2"):
        assert block["post_mlp_norm"]["scale"].dtype == TC.dtype_of(dtype)
        cache = TM.init_cache(tcfg, 3, 80, device="cpu")[0]
        assert cache["0"]["k"].shape[3] == 64 and cache["1"]["k"].shape[3] \
            == 80


def test_bridge_is_leaf_for_leaf(family):
    _, tcfg, params, tp = family
    jf, tf_ = _flat(params), _flat(tp)
    assert set(jf) == set(tf_)
    assert any("post_mlp_norm" in k for k in jf) == tcfg.sandwich_norm
    for path, leaf in jf.items():
        np.testing.assert_array_equal(_np(tf_[path]), _np(leaf), err_msg=path)


def test_bridge_refuses_a_tree_that_does_not_fit():
    """A gemma2 tree bridged to a config without post-norms, a plain tree
    to one with them, and a two-kind unit to a grouped plan are refused."""
    jcfg, tcfg = _configs("gemma2-2b", {})
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    with pytest.raises(ValueError, match="post-norms"):
        io.params_from_numpy(tree, dataclasses.replace(
            tcfg, sandwich_norm=False), "cpu")
    plain = get_config("internlm2-1.8b").reduced()
    ptree = jax.tree.map(np.asarray, JM.init_params(
        jax.random.PRNGKey(0), jget_config("internlm2-1.8b").reduced()))
    with pytest.raises(ValueError, match="post-norms"):
        io.params_from_numpy(ptree, dataclasses.replace(
            plain, sandwich_norm=True), "cpu")
    # the same layers, stacked as a two-kind unit vs grouped runs
    with pytest.raises(ValueError, match="positions"):
        io.params_from_numpy(tree, dataclasses.replace(
            tcfg, block_pattern=("attn_local",)), "cpu")
    with pytest.raises(ValueError, match="layers"):
        io.params_from_numpy(dict(ptree, segments=(jax.tree.map(
            lambda a: a[:1], ptree["segments"][0]),)), plain, "cpu")


# ---------------------------------------------------------------------------
# the new pieces: softcap, scaled embeddings, kv accounting
# ---------------------------------------------------------------------------
def test_softcap_equals_jax():
    x = np.random.default_rng(0).standard_normal((4, 50)).astype(
        np.float32) * 80
    for cap in (0.0, -1.0, 30.0, 50.0):
        _close(TC.softcap(torch.tensor(x), cap), JC.softcap(jnp.asarray(x),
                                                            cap), str(cap))


def test_scaled_embedding_bitwise_equal_jax_in_bf16():
    """gemma2-9b's d 3584: sqrt(3584) = 59.866 rounds to 59.75 in bf16,
    which both sides multiply by; a float factor gives other bits."""
    jcfg, tcfg = _configs("gemma2-9b", None, dict(vocab_size=64))
    assert tcfg.dtype == "bfloat16" and tcfg.d_model == 3584
    table = jnp.asarray(np.random.default_rng(1).standard_normal(
        (64, 3584)).astype(np.float32)).astype(jnp.bfloat16)
    toks = np.random.default_rng(2).integers(0, 64, (3, 7)).astype(np.int32)
    jh = JM._embed({"embed": table}, jcfg, jnp.asarray(toks), {})
    emb = io.to_tensor(np.asarray(table), "cpu")
    th = TM._embed({"embed": emb}, tcfg, torch.tensor(toks))
    assert th.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        th.view(torch.int16).numpy(),
        np.asarray(jh).view(np.int16))
    naive = emb[torch.tensor(toks)] * 3584 ** 0.5
    assert not torch.equal(naive, th)
    plain = TM._embed({"embed": emb}, dataclasses.replace(
        tcfg, scale_embeddings=False), torch.tensor(toks))
    assert torch.equal(plain, emb[torch.tensor(toks)])


@pytest.mark.parametrize("name", FAMILIES)
def test_kv_bytes_per_token_and_paged_support_equal_jax(name):
    jcfg, tcfg = _configs(name)
    assert TK.kv_bytes_per_token(tcfg) == JK.kv_bytes_per_token(jcfg) > 0
    if name.startswith("gemma2"):
        for K, cfg in ((JK, jcfg), (TK, tcfg)):
            with pytest.raises(ValueError, match="sliding-window"):
                K.check_paged_support(cfg)
    else:
        JK.check_paged_support(jcfg)
        TK.check_paged_support(tcfg)


# ---------------------------------------------------------------------------
# the model: decode against the full forward, the ring, logits
# ---------------------------------------------------------------------------
def _decode_all(tp, tcfg, toks, caches):
    outs = []
    for t in range(toks.shape[1]):
        lg, caches = TM.decode_step(
            tp, tcfg, torch.tensor(toks[:, t:t + 1]), caches,
            torch.full((toks.shape[0],), t, dtype=torch.int32))
        outs.append(lg[:, 0])
    return torch.stack(outs, 1), caches


@pytest.mark.parametrize("name", PARITY_FAMILIES)
def test_decode_matches_full_forward(name):
    """The twin of ``tests/test_decode_parity.py::
    test_decode_matches_full_forward``: decode with a cache of 16 slots
    reproduces the full forward (its tolerance), and equals the
    reference's decode within 2e-5."""
    jcfg, tcfg, params, tp = _pair(name, seed=1)
    b, s, S = 2, 8, 16
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (b, s), 0,
                                         jcfg.vocab_size), np.int32)
    full, _ = TM.forward_train(tp, tcfg, {"tokens": torch.tensor(toks)})
    dec, _ = _decode_all(tp, tcfg, toks, TM.init_cache(tcfg, b, S,
                                                       device="cpu"))
    np.testing.assert_allclose(_np(dec), _np(full), atol=5e-5, rtol=1e-3)
    caches = JM.init_cache(jcfg, b, S)
    jouts = []
    for t in range(s):
        lg, caches = JM.decode_step(params, jcfg, toks[:, t:t + 1], caches, t)
        jouts.append(lg[:, 0])
    _close(dec, jnp.stack(jouts, 1), "decode vs reference decode")


def test_ring_buffer_window_decode_matches_full():
    """The twin of ``test_ring_buffer_window_decode_matches_full``: a
    window of 4 on every layer (``force_window=4``), caches of exactly 4
    slots, 12 steps: every step equals the windowed full forward, and the
    reference's ring decode within 2e-5, caches included."""
    jcfg, tcfg, params, tp = _pair("gemma2-2b", replace=dict(
        sliding_window=4, force_window=4), seed=5)
    b, s = 2, 12
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(6), (b, s), 0,
                                         jcfg.vocab_size), np.int32)
    full, _ = TM.forward_train(tp, tcfg, {"tokens": torch.tensor(toks)})
    caches = TM.init_cache(tcfg, b, s, device="cpu")
    assert {leaf.shape[3] for leaf in _flat(caches).values()} == {4}
    dec, caches = _decode_all(tp, tcfg, toks, caches)
    np.testing.assert_allclose(_np(dec), _np(full), atol=5e-5, rtol=1e-3)
    jc = JM.init_cache(jcfg, b, s)
    jouts = []
    for t in range(s):
        lg, jc = JM.decode_step(params, jcfg, toks[:, t:t + 1], jc, t)
        jouts.append(lg[:, 0])
    _close(dec, jnp.stack(jouts, 1), "ring decode vs reference")
    _caches_close(caches, jc)


def test_ring_decode_with_rows_at_different_positions():
    """Per-row positions in the ring: rows past and short of the window
    write their own slots ``pos % window`` and attend ``min(pos + 1,
    window)`` slots, as the reference's decode."""
    jcfg, tcfg, params, tp = _pair("gemma2-9b", replace=dict(
        sliding_window=5), seed=7)
    b = 3
    rng = np.random.default_rng(8)
    jc = JM.init_cache(jcfg, b, 9)
    tc = TM.init_cache(tcfg, b, 9, device="cpu")
    assert tc[0]["0"]["k"].shape[3] == 5 and tc[0]["1"]["k"].shape[3] == 9
    start = np.array([0, 2, 4], np.int32)
    for t in range(5):
        tok = rng.integers(0, 512, (b, 1)).astype(np.int32)
        pos = start + t
        jl, jc = JM.decode_step(params, jcfg, jnp.asarray(tok), jc,
                                jnp.asarray(pos))
        tl, tc = TM.decode_step(tp, tcfg, torch.tensor(tok), tc,
                                torch.tensor(pos))
        _close(tl, jl, f"step {t}")
    _caches_close(tc, jc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(family, dtype):
    """Prefill, then three decode steps on the grown caches.  gemma2's
    logits are float32 (the final softcap casts), the others' in the model
    dtype; in bf16 they are held in dtype only (the two sides' bf16 sums
    round differently)."""
    jcfg, tcfg, params, tp = family
    gemma = tcfg.final_logit_softcap > 0
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (3, PROMPT_LEN)).astype(np.int32)
    steps = rng.integers(0, 512, (3, 3)).astype(np.int32)
    if dtype == "bfloat16":
        jb = dataclasses.replace(jcfg, dtype=dtype)
        tb = dataclasses.replace(tcfg, dtype=dtype)
        tl, tc = TM.prefill(TM.init_params(tb, seed=0, device="cpu"), tb,
                            {"tokens": torch.tensor(toks)})
        jl, _ = JM.prefill(JM.init_params(jax.random.PRNGKey(0), jb), jb,
                           {"tokens": jnp.asarray(toks)})
        want = torch.float32 if gemma else torch.bfloat16
        assert tl.dtype == want and (jl.dtype == jnp.float32) == gemma
        assert bool(torch.isfinite(tl).all())
        if gemma:
            assert float(tl.abs().max()) <= 30.0
        return
    jl, jc = JM.prefill(params, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.tensor(toks)})
    assert tl.dtype == torch.float32
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


def test_generate_token_streams_equal(family):
    jcfg, tcfg, params, tp = family
    prompts = _prompts(4, 4)
    jg, jd = JS.generate(params, jcfg, prompts, max_new_tokens=8)
    tg, td = TS.generate(tp, tcfg, prompts, max_new_tokens=8)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_allclose(td, jd, atol=F32_TOL, rtol=F32_TOL)


def test_generate_windowed_gemma2_equal_jax():
    """A window of 16 under the 49-token prompts: the local layers' window
    bites in prefill and in every decode step (the cache is 57 slots, no
    ring)."""
    jcfg, tcfg, params, tp = _pair("gemma2-9b", replace=dict(
        sliding_window=16), seed=3)
    prompts = _prompts(9, 3)
    jg, jd = JS.generate(params, jcfg, prompts, max_new_tokens=8)
    tg, td = TS.generate(tp, tcfg, prompts, max_new_tokens=8)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_allclose(td, jd, atol=F32_TOL, rtol=F32_TOL)
    wide = dataclasses.replace(tcfg, sliding_window=4096)
    assert not np.array_equal(
        TS.generate(tp, wide, prompts, max_new_tokens=8)[1], td)


# ---------------------------------------------------------------------------
# training: the loss and every gradient leaf
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradients_match_reference(remat):
    """A small gemma2 (softcaps, post-norms, scaled embeddings, a window of
    16 under 40 tokens): loss within 2e-5, each gradient leaf within 1e-4
    of its largest magnitude."""
    jcfg, tcfg, params, tp = _pair("gemma2-2b", replace=dict(
        sliding_window=16), seed=11)
    r = np.random.default_rng(12)
    tokens = r.integers(0, 512, (3, 40)).astype(np.int32)
    labels = np.where(r.random((3, 40)) < 0.3, -100,
                      r.integers(0, 512, (3, 40))).astype(np.int32)
    batch = {"tokens": tokens, "labels": labels}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True)(params)
    loss, metrics, grads = TOpt.value_and_grad(
        lambda p: TM.loss_fn(p, tcfg, tpipe.to_tensors(batch, "cpu"),
                             remat=remat), tp)
    assert float(loss) == pytest.approx(float(jloss), abs=F32_TOL)
    for k in ("ce", "acc", "aux"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]), abs=F32_TOL)
    jflat, tflat = io.flatten(jgrads), io.flatten(grads)
    assert list(jflat) == list(tflat)
    assert any("post_attn_norm" in k for k in jflat)
    for key, jg in jflat.items():
        jg = np.asarray(jg, np.float32)
        tol = GRAD_TOL * max(float(np.abs(jg).max()), 1e-30)
        np.testing.assert_allclose(_np(tflat[key]), jg, rtol=0, atol=tol,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# paged KV: the small starcoder2 pages, gemma2 is refused
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def starcoder2_pair():
    name, kw, rep = ENGINE_CONFIGS["starcoder2 g12"]
    return _pair(name, kw, rep, seed=4)


def test_paged_stream_equals_dense_and_reference(starcoder2_pair):
    """GQA group 12 over 8-token pages: ragged prompts, three segments and
    a fused refill, port paged == port dense bit for bit and == the JAX
    paged path in tokens (logits to 2e-5)."""
    jcfg, tcfg, params, tp = starcoder2_pair
    rng = np.random.default_rng(10)
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


def test_gemma2_refused_paged_kv_as_in_jax():
    jcfg, tcfg, params, tp = _pair("gemma2-2b")
    prompts = _prompts(5, 2, 10)
    for S, p, cfg, K in ((JS, params, jcfg, JK), (TS, tp, tcfg, TK)):
        with pytest.raises(ValueError, match="sliding-window"):
            S.prefill_state(p, cfg, prompts, max_new_tokens=4,
                            kv_pool=K.KVPool(16, 8))


# ---------------------------------------------------------------------------
# the slice as a whole: ScopeEngine.serve on the dense families
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


@pytest.fixture(scope="module", params=sorted(ENGINE_CONFIGS))
def engines(request, port_world, scope_data, library, retriever):
    name, kw, rep = ENGINE_CONFIGS[request.param]
    jcfg, tcfg, params, tp = _pair(name, kw, rep)
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
