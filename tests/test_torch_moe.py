"""The port's mixture-of-experts slice against the JAX package on the same
inputs: ``models/moe.py`` (capacity-bucket routing, shared experts, the
load-balance loss), the ``moe`` / ``mla_moe`` kinds and
``first_dense_layers`` in the plan, the two MoE configs, and the
qwen3-moe-235b-a22b backbone as a whole on its ``reduced()`` config
(GQA + MoE layers; deepseek-v2-lite-16b's MLA stack is held in
``tests/test_torch_mla.py``, which imports the helpers below).

Weights come from the reference's seeded ``init_params`` through
``io.params_from_numpy``; inputs are numpy-seeded.  Tolerances: float32
within 2e-5, bf16 within 3e-2, every gradient leaf within 1e-4 of that
leaf's largest magnitude, tokens, decisions and dropped choices equal.
Under capacity a row's output depends on the other rows of its routing
group, so streams are compared with the reference's streams and batches
with its batches, never a stream with a batch.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jget_config
from repro.core.estimator import ReasoningEstimator as JEstimator
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models import transformer as JT
from repro.serving import kv_pool as JK
from repro.serving import sampler as JS
from repro.serving import scheduler as JSch
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
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models import transformer as TT
from repro_torch.serving import kv_pool as TK
from repro_torch.serving import sampler as TS
from repro_torch.serving import scheduler as TSch
from repro_torch.training import optimizer as TOpt

F32_TOL = 2e-5
BF16_TOL = 3e-2
GRAD_TOL = 1e-4
QWEN, DEEPSEEK = "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b"
MOE_NAMES = (QWEN, DEEPSEEK)
PROMPT_LEN = 49
N_QUERIES = 8


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


def _close(got, want, what="", tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=what)


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


def _prompts(seed, b, width=PROMPT_LEN, vocab=512):
    return np.random.default_rng(seed).integers(4, vocab, (b, width)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs, registry, plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [None, {}], ids=["full", "reduced"])
@pytest.mark.parametrize("name", MOE_NAMES)
def test_config_fields_equal_jax(name, kw):
    jcfg, tcfg = _configs(name, kw)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.has_moe() and tcfg.resolved_moe_d_ff == jcfg.resolved_moe_d_ff
    assert tcfg.has_mla() == (name == DEEPSEEK)
    if kw is not None:
        assert (tcfg.num_experts, tcfg.num_experts_per_tok,
                tcfg.moe_d_ff) == (4, 2, 512)
        assert tcfg.num_shared_experts == (1 if name == DEEPSEEK else 0)


def test_registry_resolves_every_reference_config():
    """The reference's ten assigned configs and the two SCOPE estimators,
    each field equal to its JAX twin."""
    names = (*ASSIGNED_ARCHS, "scope-qwen3-4b", "scope-tiny")
    assert len(set(names)) == 12
    for name in names:
        tcfg, jcfg = get_config(name), jget_config(name)
        assert tcfg.name == name
        for f in dataclasses.fields(ModelConfig):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (name,
                                                                   f.name)


def test_full_width_geometry():
    """The shapes the card meets: qwen3-moe's GQA group 16 over 128 experts
    of 4096 x 1536, top-8; deepseek's 16 MLA heads (q / k 192, v 128) and
    64 + 2 shared experts of 2048 x 1408, top-6, one dense first layer."""
    q = get_config(QWEN)
    assert (q.num_heads // q.num_kv_heads, q.resolved_head_dim, q.num_layers,
            q.num_experts, q.num_experts_per_tok, q.resolved_moe_d_ff) == (
        16, 128, 94, 128, 8, 1536)
    d = get_config(DEEPSEEK)
    assert (d.num_heads, d.qk_nope_head_dim + d.qk_rope_head_dim,
            d.v_head_dim, d.kv_lora_rank, d.num_experts,
            d.num_experts_per_tok, d.num_shared_experts, d.moe_d_ff) == (
        16, 192, 128, 512, 64, 6, 2, 1408)
    r = get_config(DEEPSEEK).reduced()
    assert (r.qk_nope_head_dim + r.qk_rope_head_dim, r.v_head_dim) == (48, 32)


@pytest.mark.parametrize("kw", [None, {}, dict(num_layers=3)],
                         ids=["full", "reduced", "reduced 3"])
@pytest.mark.parametrize("name", MOE_NAMES)
def test_build_plan_equal_jax(name, kw):
    jcfg, tcfg = _configs(name, kw)
    plan = TT.build_plan(tcfg)
    assert plan == JT.build_plan(jcfg)
    n = tcfg.num_layers
    if name == QWEN:
        assert plan == [(("moe",), n)]
    else:                   # the first layer is dense
        assert plan == [(("mla",), 1), (("mla_moe",), n - 1)]
    assert TT.build_plan(dataclasses.replace(tcfg, first_dense_layers=0)) \
        == JT.build_plan(dataclasses.replace(jcfg, first_dense_layers=0))


@pytest.mark.parametrize("name", MOE_NAMES)
def test_kv_bytes_per_token_and_paged_support_equal_jax(name):
    """qwen3-moe's ``moe`` layers count and page; deepseek's MLA layers
    count 0 (the reference's undercount, copied) and are refused paged
    KV with the reference's message."""
    for kw in (None, {}):
        jcfg, tcfg = _configs(name, kw)
        assert TK.kv_bytes_per_token(tcfg) == JK.kv_bytes_per_token(jcfg)
        if name == QWEN:
            assert TK.kv_bytes_per_token(tcfg) > 0
            JK.check_paged_support(jcfg)
            TK.check_paged_support(tcfg)
            continue
        assert TK.kv_bytes_per_token(tcfg) == 0
        msgs = []
        for K, cfg in ((JK, jcfg), (TK, tcfg)):
            with pytest.raises(ValueError, match="MLA") as e:
                K.check_paged_support(cfg)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("total", [1, 7, 56, 196, 255, 256, 257, 510, 512,
                                   2744, 9973])
def test_group_size_equals_jax(total):
    assert TMoE._group_size(total) == JMoE._group_size(total)
    assert total % TMoE._group_size(total) == 0
    assert TMoE._group_size(total) <= TMoE.MOE_GROUP == JMoE.MOE_GROUP


def test_capacity_at_the_serve_shapes():
    """56 prompts of 49 tokens route in 14 groups of 196: qwen3-moe keeps
    16 slots an expert, deepseek 23; a 56-row decode step is one group of
    56, 5 slots an expert for qwen3-moe."""
    q, d = get_config(QWEN), get_config(DEEPSEEK)
    assert TMoE._group_size(56 * PROMPT_LEN) == 196
    assert (TMoE.capacity(q, 196), TMoE.capacity(d, 196),
            TMoE.capacity(q, 56)) == (16, 23, 5)


def _moe_block(name, dtype, seed=0):
    """(JAX config, port config, JAX moe params, port moe params) of the
    reduced config's MoE layer."""
    jcfg, tcfg, params, tp = _pair(name, replace=dict(dtype=dtype), seed=seed)
    seg = len(params["segments"]) - 1           # deepseek's 0 is dense
    jp = jax.tree.map(lambda a: a[0], params["segments"][seg]["0"]["moe"])
    return jcfg, tcfg, jp, TT.layer_view(tp["segments"][seg]["0"]["moe"], 0)


def _x(seed, shape, d, dtype):
    x = np.random.default_rng(seed).standard_normal(shape + (d,)).astype(
        np.float32)
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.tensor(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_forward_equals_jax(name, dtype):
    """Two routing groups of 200 tokens (4 x 100), the shared expert on
    deepseek: the experts chosen and each choice's rank within its expert
    equal, y within 2e-5 (f32) or 3e-2 (bf16), aux within 2e-5."""
    jcfg, tcfg, jp, tp = _moe_block(name, dtype)
    jx, tx = _x(1, (4, 100), tcfg.d_model, dtype)
    jy, jaux = JMoE.moe_forward(jp, jcfg, jx)
    ty, taux = TMoE.moe_forward(tp, tcfg, tx)
    # the routing itself: experts and each choice's rank within its expert
    _, jtop, jpos = _jax_dropped(jp, jcfg, jx)
    _, _, ttop, tpos, counts = TMoE.route(tp, tcfg, tx.reshape(2, 200, -1))
    np.testing.assert_array_equal(ttop.numpy(), np.asarray(jtop))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert counts.sum().item() == 4 * 100 * tcfg.num_experts_per_tok
    assert ty.dtype == getattr(torch, dtype) and ty.shape == tx.shape
    _close(ty, jy, "y", F32_TOL if dtype == "float32" else BF16_TOL)
    assert float(taux) == pytest.approx(float(jaux), abs=F32_TOL)
    assert taux.dtype == torch.float32


def _jax_dropped(jp, cfg, x):
    """The reference's dropped choices, from its own routing expressions
    (``repro.models.moe.moe_forward`` lines 70-85)."""
    b, s, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = JMoE._group_size(b * s)
    G = b * s // T
    C = max(int(math.ceil(T * k / E * cfg.capacity_factor)), 1)
    logits = x.reshape(G, T, d).astype(jnp.float32) @ jp["router"].astype(
        jnp.float32)
    _, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    oe = jax.nn.one_hot(top_i, E).reshape(G, T * k, E)
    pos = jnp.sum(jnp.cumsum(oe, axis=1) * oe, axis=-1) - 1.0
    return int(jnp.sum(pos >= C)), top_i, pos.reshape(G, T, k)


@pytest.mark.parametrize("name", MOE_NAMES)
def test_dropped_choices_equal_jax(name):
    """A router that sends every token to experts 0 and 1 (a constant
    feature times a large weight): the one group of 120 tokens keeps C = 75
    of the 120 choices of each, so 90 choices are dropped, on both sides,
    and y still agrees."""
    jcfg, tcfg, jp, tp = _moe_block(name, "float32", seed=2)
    d = tcfg.d_model
    router = np.zeros((d, tcfg.num_experts), np.float32)
    router[0, :2] = (3.0, 2.0)
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.tensor(router))
    x = np.random.default_rng(3).standard_normal((2, 60, d)).astype(
        np.float32)
    x[..., 0] = 5.0
    jy, jaux = JMoE.moe_forward(jp, jcfg, jnp.asarray(x))
    TMoE.records = []
    try:
        ty, taux = TMoE.moe_forward(tp, tcfg, torch.tensor(x))
        (rec,) = TMoE.records
    finally:
        TMoE.records = None
    want, _, _ = _jax_dropped(jp, jcfg, jnp.asarray(x))
    assert TMoE.capacity(tcfg, 120) == 75
    assert int(rec["dropped"]) == want == 2 * (120 - 75)
    _close(ty, jy, "y")
    assert float(taux) == pytest.approx(float(jaux), abs=F32_TOL)


@pytest.mark.parametrize("name", MOE_NAMES)
def test_router_tie_goes_to_the_lower_expert_index(name):
    """Experts 1, 2, 3 tie exactly behind expert 0 on every token (zero
    router columns): top-2 is (0, 1), as ``jax.lax.top_k`` breaks ties,
    and y agrees; the recorded margin of the last choice is 0."""
    jcfg, tcfg, jp, tp = _moe_block(name, "float32", seed=4)
    d = tcfg.d_model
    router = np.zeros((d, tcfg.num_experts), np.float32)
    router[0, 0] = 1.0
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.tensor(router))
    x = np.random.default_rng(5).standard_normal((3, 20, d)).astype(
        np.float32)
    x[..., 0] = 5.0
    _, jtop, _ = _jax_dropped(jp, jcfg, jnp.asarray(x))
    _, _, ttop, _, _ = TMoE.route(tp, tcfg,
                                  torch.tensor(x).reshape(1, 60, d))
    np.testing.assert_array_equal(ttop.numpy(), np.asarray(jtop))
    assert (ttop.numpy() == [0, 1]).all()
    TMoE.records = []
    try:
        ty, _ = TMoE.moe_forward(tp, tcfg, torch.tensor(x))
        assert float(TMoE.records[0]["gap"]) == 0.0
    finally:
        TMoE.records = None
    jy, _ = JMoE.moe_forward(jp, jcfg, jnp.asarray(x))
    _close(ty, jy, "y")


# ---------------------------------------------------------------------------
# the bridge and init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE_NAMES)
def test_init_params_and_cache_match_jax_structure_and_dtypes(name, dtype):
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
    # each expert's matrices drawn at the fan-in of one expert
    moe = TM.init_params(tcfg, seed=0, device="cpu")["segments"][-1]["0"][
        "moe"]
    bound = 2.0 / tcfg.d_model ** 0.5
    assert float(moe["wi_gate"].float().abs().max()) <= bound
    assert float(moe["wi_gate"].float().std()) > 0.5 / tcfg.d_model ** 0.5


@pytest.mark.parametrize("name", MOE_NAMES)
def test_bridge_is_leaf_for_leaf(name):
    _, tcfg, params, tp = _pair(name)
    jf, tf_ = _flat(params), _flat(tp)
    assert set(jf) == set(tf_)
    assert any("/moe/wi_gate" in k for k in jf)
    assert any("/attn/w_dkv" in k for k in jf) == (name == DEEPSEEK)
    for path, leaf in jf.items():
        np.testing.assert_array_equal(_np(tf_[path]), _np(leaf), err_msg=path)


@pytest.mark.parametrize("name", MOE_NAMES)
def test_bridge_refuses_a_tree_that_does_not_fit(name):
    """Another expert count, a missing shared expert, MoE leaves where the
    plan has an MLP (no first dense layer), and stacks of the wrong depth
    are refused."""
    jcfg, tcfg = _configs(name, {})
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    io.params_from_numpy(tree, tcfg, "cpu")
    with pytest.raises(ValueError, match="moe router"):
        io.params_from_numpy(tree, dataclasses.replace(tcfg, num_experts=3),
                             "cpu")
    if name == DEEPSEEK:
        with pytest.raises(ValueError, match="MoE leaves"):
            io.params_from_numpy(tree, dataclasses.replace(
                tcfg, num_shared_experts=0), "cpu")
        with pytest.raises(ValueError, match="segments"):
            io.params_from_numpy(tree, dataclasses.replace(
                tcfg, first_dense_layers=0), "cpu")
    else:
        with pytest.raises(ValueError, match="MoE leaves"):
            io.params_from_numpy(tree, dataclasses.replace(
                tcfg, num_shared_experts=1), "cpu")
        with pytest.raises(ValueError, match="wanted its 'mlp'"):
            io.params_from_numpy(tree, dataclasses.replace(
                tcfg, block_pattern=("attn",)), "cpu")
    seg = tree["segments"][-1]
    with pytest.raises(ValueError, match="layers"):
        io.params_from_numpy(dict(tree, segments=tree["segments"][:-1] + (
            jax.tree.map(lambda a: np.concatenate([a, a]), seg),)), tcfg,
            "cpu")


# ---------------------------------------------------------------------------
# the backbone: logits, streams, paged, loss (shared with test_torch_mla)
# ---------------------------------------------------------------------------
def check_prefill_and_decode_logits(name, dtype):
    """Prefill 3 x 49 tokens, then three decode steps on the grown caches:
    f32 logits and caches within 2e-5; bf16 logits in dtype and finite."""
    jcfg, tcfg, params, tp = _pair(name, replace=dict(dtype=dtype))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (3, PROMPT_LEN)).astype(np.int32)
    steps = rng.integers(0, 512, (3, 3)).astype(np.int32)
    jl, jc = JM.prefill(params, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.tensor(toks)})
    if dtype == "bfloat16":
        assert tl.dtype == torch.bfloat16 and jl.dtype == jnp.bfloat16
        assert bool(torch.isfinite(tl).all())
        return
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


def check_generate_token_streams(name):
    """Greedy streams of ragged prompts, equal tokens, decision logits
    within 2e-5."""
    jcfg, tcfg, params, tp = _pair(name, seed=1)
    prompts = _prompts(4, 4)
    lens = [49, 30, 41, 12]
    jg, jd = JS.generate(params, jcfg, prompts, max_new_tokens=8,
                         prompt_lens=lens)
    tg, td = TS.generate(tp, tcfg, prompts, max_new_tokens=8,
                         prompt_lens=lens)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_allclose(td, jd, atol=F32_TOL, rtol=F32_TOL)


def check_loss_and_gradients(name):
    """The loss (cross-entropy + router_aux_coef * aux) within 2e-5, aux
    too, and each gradient leaf (the router's and every expert stack's
    included) within 1e-4 of its largest magnitude, against
    ``jax.value_and_grad``."""
    jcfg, tcfg, params, tp = _pair(name, seed=11)
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
        lambda p: TM.loss_fn(p, tcfg, tpipe.to_tensors(batch, "cpu")), tp)
    assert float(metrics["aux"]) > 0
    assert float(loss) == pytest.approx(float(jloss), abs=F32_TOL)
    assert float(loss) == pytest.approx(
        float(metrics["ce"]) + tcfg.router_aux_coef * float(metrics["aux"]),
        abs=1e-6)
    for k in ("ce", "acc", "aux"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]), abs=F32_TOL)
    jflat, tflat = io.flatten(jgrads), io.flatten(grads)
    assert list(jflat) == list(tflat)
    assert any("router" in k for k in jflat)
    for key, jg in jflat.items():
        jg = np.asarray(jg, np.float32)
        tol = GRAD_TOL * max(float(np.abs(jg).max()), 1e-30)
        np.testing.assert_allclose(_np(tflat[key]), jg, rtol=0, atol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(dtype):
    check_prefill_and_decode_logits(QWEN, dtype)


def test_generate_token_streams_equal():
    check_generate_token_streams(QWEN)


def test_loss_and_gradients_match_reference():
    check_loss_and_gradients(QWEN)


def test_paged_stream_equals_dense_and_reference():
    """qwen3-moe over 8-token pages: ragged prompts, three segments and a
    fused refill; port paged == port dense bit for bit and == the JAX
    paged path in tokens (logits within 2e-5)."""
    jcfg, tcfg, params, tp = _pair(QWEN, seed=4)
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


# ---------------------------------------------------------------------------
# the slice as a whole: ScopeEngine.serve, batch and stream
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


def make_engines(name, port_world, scope_data, library, retriever, **kw):
    """(JAX engine, port engine, JAX data, port data, query ids) of the
    reduced ``name`` with bridged weights; estimators decode 6 tokens."""
    jcfg, tcfg, params, tp = _pair(name)
    world, data, anchors, lib = port_world
    jeng = japi.ScopeEngine.build(japi.EngineConfig(
        estimator=JEstimator(jcfg, params, max_new_tokens=6),
        retriever=retriever, library=library,
        models_meta={m: scope_data.world.models[m]
                     for m in scope_data.models}, **kw))
    teng = tapi.ScopeEngine.build(tapi.EngineConfig(
        estimator=TEstimator(tcfg, tp, max_new_tokens=6),
        retriever=AnchorRetriever(anchors, device="cpu"), library=lib,
        models_meta={m: world.models[m] for m in data.models}, **kw))
    qids = [int(q) for q in scope_data.test_qids[:N_QUERIES]]
    return jeng, teng, scope_data, data, qids


def check_engine_serve(engines):
    """``serve`` under a fixed alpha and a budget: equal pool predictions,
    decisions, confidences within 2e-5, cache accounting."""
    jeng, teng, jdata, tdata, qids = engines
    jreq = japi.RouteRequest([jdata.queries[q] for q in qids])
    treq = tapi.RouteRequest([tdata.queries[q] for q in qids])
    jp = jeng.predict(jreq, use_cache=False)
    tp = teng.predict(treq, use_cache=False)
    for f in ("y_hat", "len_hat", "well_formed", "pred_overhead"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f)
    np.testing.assert_allclose(tp.p_hat, jp.p_hat, atol=F32_TOL)
    budget = float(jp.cost_hat.min(axis=1).sum() * 1.5)
    for jpol, tpol in ((japi.FixedAlphaPolicy(0.7),
                        tapi.FixedAlphaPolicy(0.7)),
                       (japi.SetBudgetPolicy(budget),
                        tapi.SetBudgetPolicy(budget))):
        jeng.cache.clear()
        teng.cache.clear()
        jr = jeng.serve(jdata, qids, jpol)
        tr = teng.serve(tdata, qids, tpol)
        assert len(tr.decisions) == len(qids)
        assert [d.model for d in tr.decisions] == [d.model for d in
                                                   jr.decisions]
        np.testing.assert_allclose([d.p_hat for d in tr.decisions],
                                   [d.p_hat for d in jr.decisions],
                                   atol=F32_TOL)
        assert (tr.cache_hits, tr.cache_misses, tr.overhead_tokens) == (
            jr.cache_hits, jr.cache_misses, jr.overhead_tokens)


def check_engine_stream(engines):
    """``predict_stream`` in ragged ticks through the same bucketed
    scheduler on both sides: equal token-derived fields, confidences
    within 2e-5, decisions and scheduler counters."""
    jeng, teng, jdata, tdata, qids = engines
    ticks = [qids[:2], qids[2:3], qids[3:5]]
    pools = []
    for eng, data, api, sch in ((jeng, jdata, japi, JSch),
                                (teng, tdata, tapi, TSch)):
        sched = sch.MicrobatchScheduler(sch.BucketConfig(
            batch_sizes=(1, 2, 4, 8)))
        pools.append((list(eng.predict_stream(
            (api.RouteRequest([data.queries[q] for q in t]) for t in ticks),
            scheduler=sched)), sched.stats))
    (jpools, jstats), (tpools, tstats) = pools
    assert len(tpools) == len(jpools) == len(ticks)
    for jp, tp in zip(jpools, tpools, strict=True):
        for f in ("y_hat", "len_hat", "well_formed", "pred_overhead", "idx"):
            np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                          err_msg=f)
        np.testing.assert_allclose(tp.p_hat, jp.p_hat, atol=F32_TOL)
        np.testing.assert_array_equal(
            tapi.FixedAlphaPolicy(0.6).decide(tp, teng).choices,
            japi.FixedAlphaPolicy(0.6).decide(jp, jeng).choices)
    for f in ("submitted", "emitted", "microbatches", "slots_refilled",
              "slot_steps_total"):
        assert getattr(tstats, f) == getattr(jstats, f), f
    assert tstats.slot_steps_total > 0


@pytest.mark.parametrize("mode", ["batch", "stream", "stream refill"])
def test_engine_serve_equals_reference(mode, port_world, scope_data, library,
                                       retriever):
    engines = make_engines(QWEN, port_world, scope_data, library, retriever,
                           **(dict(refill=True) if mode == "stream refill"
                              else {}))
    if mode == "batch":
        check_engine_serve(engines)
    else:
        check_engine_stream(engines)
