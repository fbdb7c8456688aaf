"""The port's multi-head latent attention and the deepseek-v2-lite-16b
backbone against the JAX package on the same inputs: ``init_mla``,
``mla_full`` (the flash call at q / k head dim nope + rope and v head dim
``v_head_dim``, scale (nope + rope) ** -0.5), the absorbed-form
``mla_decode`` over the latent caches, decode step by step against the
full forward, the ``c_kv`` / ``k_rope`` caches through growth and refill,
the flash kernel's new (d, dv) pairs, and deepseek-v2-lite-16b as a whole
on its ``reduced()`` config (a dense MLA first layer, then MLA + MoE
layers with a shared expert; q / k 48, v 32).

Weights come from the reference's seeded ``init_params`` through
``io.params_from_numpy``; inputs are numpy-seeded.  Tolerances: float32
within 2e-5, bf16 within 3e-2, gradient leaves within 1e-4 of each leaf's
largest magnitude, tokens and decisions equal.  On the card the same
prefill runs the flash kernel at (192, 128) / (48, 32), which
``chip_smoke.py`` holds to its plain version; its arithmetic in bf16 is
``tests/test_torch_kernels.py::_emulate_bf16_flash``'s, held here to the
Pallas kernel in interpret mode at those pairs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import _both, _check_bf16_flash, _qkv
from test_torch_moe import (BF16_TOL, DEEPSEEK, F32_TOL, PROMPT_LEN, _close,
                            _flat, _np, _pair, _prompts,
                            check_engine_serve, check_engine_stream,
                            check_generate_token_streams,
                            check_loss_and_gradients,
                            check_prefill_and_decode_logits, make_engines,
                            port_world)  # noqa: F401  (a fixture)

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as fa_pallas
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import rope as JR
from repro.serving import sampler as JS
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import rope as TR
from repro_torch.models import transformer as TT
from repro_torch.serving import sampler as TS


@pytest.fixture(scope="module")
def deepseek():
    return _pair(DEEPSEEK, seed=0)


def _mla_layer(pair, seg=0):
    """(JAX cfg, port cfg, JAX layer-0 attention params, port's) of
    segment ``seg`` (0: the dense MLA layer)."""
    jcfg, tcfg, params, tp = pair
    jp = jax.tree.map(lambda a: a[0], params["segments"][seg]["0"]["attn"])
    return jcfg, tcfg, jp, TT.layer_view(tp["segments"][seg]["0"]["attn"], 0)


def _rope(cfg, pos):
    pos = np.asarray(pos)
    jc, js = JR.rope_cos_sin(jnp.asarray(pos), cfg.qk_rope_head_dim,
                             cfg.rope_theta)
    tc, ts = TR.rope_cos_sin(torch.tensor(pos), cfg.qk_rope_head_dim,
                             cfg.rope_theta)
    return (jc, js), (tc, ts)


def _x(seed, b, s, d, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)
    return x


# ---------------------------------------------------------------------------
# the flash kernel's MLA pairs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d,dv", [(192, 128), (48, 32)])
def test_flash_check_args_take_the_mla_pairs_forward_only(d, dv):
    """The flash kernels take (192, 128) and (48, 32), in the model's bf16
    layout too, the backward as the forward (one ``check_args``: a loss
    through MLA trains on the card); the swapped pairs and (d, d) stay
    refused."""
    bf = torch.bfloat16
    q = torch.zeros(2, 49, 16, d, dtype=bf).transpose(1, 2)
    v = torch.zeros(2, 49, 16, dv, dtype=bf).transpose(1, 2)
    FA.check_args(q, q, v)
    FA.check_args(q.float(), q.float(), v.float())
    for dd, ddv in ((dv, d), (d, d)):
        with pytest.raises(ValueError, match="head dims"):
            FA.check_args(torch.zeros(1, 2, 8, dd), torch.zeros(1, 2, 8, dd),
                          torch.zeros(1, 2, 8, ddv))


@pytest.mark.parametrize("case", [
    (2, 16, 16, 49, 49, 192, 128, True, 0),
    (1, 4, 4, 33, 70, 192, 128, False, 0),
    (2, 4, 4, 20, 20, 48, 32, True, 0),
    (1, 4, 4, 24, 40, 48, 32, True, 16),
], ids=["192/128 causal", "192/128 non-causal", "48/32", "48/32 offset"])
def test_flash_plain_at_mla_pairs_matches_pallas_interpret(case):
    """The plain version at the new pairs, the scale passed explicitly as
    MLA passes it, against the Pallas kernel in interpret mode and the
    reference oracle."""
    b, hq, hkv, sq, sk, d, dv, causal, off = case
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(31, b, hq, hkv, sq, sk, d, dv))
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=off)
    got = ops.flash_attention(tq, tk, tv, **kw)
    assert tuple(got.shape) == (b, hq, sq, dv)
    want = fa_pallas(jq, jk, jv, block_q=64, block_k=64, interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.attention(
        jq, jk, jv, **kw)), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("kw", [{}, dict(q_offset=-5), dict(causal=False)],
                         ids=["causal", "q_offset=-5", "non-causal"])
def test_bf16_kernel_numerics_within_budget_at_192_128(kw):
    """The bf16 tensor-core kernel's arithmetic (P rounded to bf16 before
    P.V, scale in the exponent, 32-key tiles; MLA's scale (nope + rope) **
    -0.5 is the kernel's default d ** -0.5 at d = nope + rope) stays within
    3e-2 of Pallas interpret and of the plain version at deepseek's head
    geometry: 16 heads, g 1, q / k 192, v 128, 49 tokens."""
    _check_bf16_flash(_qkv(32, 2, 16, 16, 49, 49, 192, 128), kw)


# ---------------------------------------------------------------------------
# mla_full, mla_decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_full_equals_jax(deepseek, dtype):
    """Output and latent caches of a 2 x 20 prefill, f32 within 2e-5, bf16
    within 3e-2."""
    jcfg, tcfg, jp, tp = _mla_layer(deepseek)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda a: a.astype(jdt) if a.ndim >= 2 else a, jp)
    tp = {k: (v.to(tdt) if isinstance(v, torch.Tensor) else v)
          for k, v in tp.items()}
    x = _x(1, 2, 20, tcfg.d_model)
    (jc, js), (tc, ts) = _rope(jcfg, np.broadcast_to(np.arange(20), (2, 20)))
    jy, jcache = JA.mla_full(jp, jcfg, jnp.asarray(x).astype(jdt), jc, js)
    ty, tcache = TA.mla_full(tp, tcfg, torch.tensor(x).to(tdt), tc, ts)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert ty.dtype == tdt
    _close(ty, jy, "y", tol)
    assert set(tcache) == {"c_kv", "k_rope"}
    for key in tcache:
        assert tuple(tcache[key].shape) == tuple(jcache[key].shape)
        _close(tcache[key], jcache[key], key, tol)


def test_mla_decode_equals_jax_at_per_row_positions(deepseek):
    """Four decode steps on a latent cache of 24 slots holding a random
    history, rows at positions 3 and 11: output and the in-place cache
    writes within 2e-5 of the reference's."""
    jcfg, tcfg, jp, tp = _mla_layer(deepseek, seg=1)
    rng = np.random.default_rng(2)
    b, S = 2, 24
    cache = {"c_kv": rng.standard_normal((b, S, tcfg.kv_lora_rank)),
             "k_rope": rng.standard_normal((b, S, tcfg.qk_rope_head_dim))}
    jcache = {k: jnp.asarray(v, jnp.float32) for k, v in cache.items()}
    tcache = {k: torch.tensor(v, dtype=torch.float32)
              for k, v in cache.items()}
    pos = np.array([3, 11], np.int32)
    for t in range(4):
        x = _x(10 + t, b, 1, tcfg.d_model)
        (jc, js), (tc, ts) = _rope(jcfg, (pos + t)[:, None])
        jy, jcache = JA.mla_decode(jp, jcfg, jnp.asarray(x), jc, js, jcache,
                                   jnp.asarray(pos + t))
        ty = TA.mla_decode(tp, tcfg, torch.tensor(x), tc, ts, tcache,
                           torch.tensor(pos + t))
        _close(ty, jy, f"step {t}")
    for key in tcache:
        _close(tcache[key], jcache[key], key)


def test_mla_decode_step_by_step_matches_full(deepseek):
    """From an empty cache, 12 decode steps (the absorbed form) give the
    full forward's outputs (the up-projected form through the flash
    call), and its latent cache."""
    jcfg, tcfg, jp, tp = _mla_layer(deepseek)
    b, s = 2, 12
    x = _x(3, b, s, tcfg.d_model)
    pos = np.broadcast_to(np.arange(s), (b, s))
    _, (tc, ts) = _rope(jcfg, pos)
    full, fcache = TA.mla_full(tp, tcfg, torch.tensor(x), tc, ts)
    cache = {"c_kv": torch.zeros(b, 16, tcfg.kv_lora_rank),
             "k_rope": torch.zeros(b, 16, tcfg.qk_rope_head_dim)}
    outs = []
    for t in range(s):
        outs.append(TA.mla_decode(tp, tcfg, torch.tensor(x[:, t:t + 1]),
                                  tc[:, t:t + 1], ts[:, t:t + 1], cache,
                                  torch.full((b,), t, dtype=torch.int32)))
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full),
                               atol=5e-5, rtol=1e-3)
    for key in cache:
        _close(cache[key][:, :s], fcache[key], key)
        assert (cache[key][:, s:] == 0).all()


# ---------------------------------------------------------------------------
# the latent caches through the serving stack
# ---------------------------------------------------------------------------
def test_cache_seq_axis_growth_and_refill_equal_jax(deepseek):
    """``CACHE_SEQ_AXIS`` names the latent caches' sequence axis (2): a
    prefill's ``c_kv`` / ``k_rope`` grow to the decode capacity as the
    reference's do, and a refill writes a new prompt's latents into its
    row, zero past its width, leaving the other rows as they were."""
    assert TS.CACHE_SEQ_AXIS == JS.CACHE_SEQ_AXIS
    jcfg, tcfg, params, tp = deepseek
    prompts = _prompts(6, 3, 20)
    _, jc = JM.prefill(params, jcfg, {"tokens": jnp.asarray(prompts)})
    _, tc = TM.prefill(tp, tcfg, {"tokens": torch.tensor(prompts)})
    jg = JS._pad_caches(jc, 30, 20)
    tg = TS._pad_caches(tc, 30, 20)
    for path, leaf in _flat(jg).items():
        got = _flat(tg)[path]
        assert tuple(got.shape) == tuple(leaf.shape), path
        _close(got, leaf, path)
    assert tuple(tg[0]["0"]["c_kv"].shape) == (1, 3, 30, tcfg.kv_lora_rank)
    jst = JS.prefill_state(params, jcfg, prompts, max_new_tokens=10)
    tst = TS.prefill_state(tp, tcfg, prompts, max_new_tokens=10)
    jst, _, _ = JS.decode_segment(params, jcfg, jst, 3)
    tst, _, _ = TS.decode_segment(tp, tcfg, tst, 3)
    before = {k: v.clone() for k, v in _flat(tst.caches).items()}
    new = _prompts(7, 2, 12)
    jst = JS.refill_slots(params, jcfg, jst, [2], new, prompt_lens=[9])
    tst = TS.refill_slots(tp, tcfg, tst, [2], new, prompt_lens=[9])
    _close(tst.last_logits, jst.last_logits, "last logits")
    np.testing.assert_array_equal(tst.positions.numpy(),
                                  np.asarray(jst.positions))
    for path, leaf in _flat(jst.caches).items():
        got = _flat(tst.caches)[path]
        _close(got, leaf, path)
        assert torch.equal(got[:, :2], before[path][:, :2]), path
        assert (got[:, 2, 12:] == 0).all(), path
    jst, jg2, _ = JS.decode_segment(params, jcfg, jst, 4)
    tst, tg2, _ = TS.decode_segment(tp, tcfg, tst, 4)
    np.testing.assert_array_equal(tg2.numpy(), np.asarray(jg2))


# ---------------------------------------------------------------------------
# deepseek-v2-lite-16b as a whole
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(dtype):
    check_prefill_and_decode_logits(DEEPSEEK, dtype)


def test_generate_token_streams_equal():
    check_generate_token_streams(DEEPSEEK)


def test_loss_and_gradients_match_reference():
    check_loss_and_gradients(DEEPSEEK)


def test_paged_kv_refused_as_in_jax(deepseek):
    """The serving stack refuses paged KV for MLA layers on both sides,
    and a paged decode step through an MLA layer raises."""
    from repro.serving import kv_pool as JK
    from repro_torch.serving import kv_pool as TK
    jcfg, tcfg, params, tp = deepseek
    prompts = _prompts(5, 2, 10)
    for S, p, cfg, K in ((JS, params, jcfg, JK), (TS, tp, tcfg, TK)):
        with pytest.raises(ValueError, match="MLA"):
            S.prefill_state(p, cfg, prompts, max_new_tokens=4,
                            kv_pool=K.KVPool(16, 8))
    layer = TT.layer_view(tp["segments"][0]["0"], 0)
    with pytest.raises(ValueError, match="MLA"):
        TT.block_decode(layer, tcfg, "mla", torch.zeros(1, 1, tcfg.d_model),
                        None, None, {}, torch.zeros(1, dtype=torch.int32),
                        paged=(TK.PagedSpec(8, 16), torch.zeros(1, 2)))


@pytest.mark.parametrize("mode", ["batch", "stream", "stream refill"])
def test_engine_serve_equals_reference(mode, port_world, scope_data, library,
                                       retriever):
    engines = make_engines(DEEPSEEK, port_world, scope_data, library,
                           retriever, **(dict(refill=True)
                                         if mode == "stream refill" else {}))
    if mode == "batch":
        check_engine_serve(engines)
    else:
        check_engine_stream(engines)


def test_logits_depend_on_the_dense_first_layer(deepseek):
    """The first layer's FFN is the dense MLP of width d_ff (the plan's
    ``("mla",)`` segment): zeroing its MLP changes the logits, and the MoE
    segment holds the shared expert of width moe_d_ff."""
    jcfg, tcfg, params, tp = deepseek
    assert set(tp["segments"][0]["0"]) >= {"attn", "mlp"}
    assert tuple(tp["segments"][0]["0"]["mlp"]["wi_gate"].shape) == (
        1, tcfg.d_model, tcfg.d_ff)
    assert tuple(tp["segments"][1]["0"]["moe"]["shared"]["wi_gate"].shape) \
        == (1, tcfg.d_model, tcfg.moe_d_ff)
    toks = torch.tensor(_prompts(8, 2, PROMPT_LEN))
    base, _ = TM.forward_train(tp, tcfg, {"tokens": toks})
    cut = dict(tp, segments=(dict(tp["segments"][0]), tp["segments"][1]))
    cut["segments"][0]["0"] = dict(tp["segments"][0]["0"], mlp={
        k: torch.zeros_like(v) for k, v in tp["segments"][0]["0"][
            "mlp"].items()})
    other, _ = TM.forward_train(cut, tcfg, {"tokens": toks})
    assert not torch.allclose(base, other)
