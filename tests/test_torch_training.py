"""The port's training path against the reference on scope-tiny: the LM
loss and its gradients, the per-layer checkpoints, the plain flash
backward, the data pipeline and SFT dataset, the rewards, AdamW over the
model's param tree, SFT steps and checkpoints.

Tolerances: loss, ce and acc within 2e-5 (float32 on both sides, sums in
other orders); each gradient leaf within 1e-4 of that leaf's largest
magnitude (the two backward passes sum over tokens and heads in other
orders); the plain flash backward within 2e-5; one SFT step's loss and
params within 2e-5; ten SFT steps' losses within 1e-4 (the steps compound
the float32 differences).  Batches, datasets, rewards and checkpoints are
equal exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.scope_estimator import TINY as JTINY
from repro.core import rewards as jrw
from repro.core.fingerprint import FingerprintLibrary as JLibrary
from repro.core.fingerprint import build_anchor_set as jbuild_anchor_set
from repro.core.retrieval import AnchorRetriever as JRetriever
from repro.data import pipeline as jpipe
from repro.data.datasets import build_scope_data as jbuild_scope_data
from repro.data.datasets import stratified_anchors as jstratified
from repro.data.worldsim import World as JWorld
from repro.kernels import ops as jops
from repro.models import model as JM
from repro.training import checkpoint as jckpt
from repro.training import optimizer as JOpt
from repro.training import sft as JSFT
from repro_torch import io
from repro_torch.configs.scope_estimator import TINY
from repro_torch.core import rewards as trw
from repro_torch.core.fingerprint import FingerprintLibrary, build_anchor_set
from repro_torch.core.retrieval import AnchorRetriever
from repro_torch.data import pipeline as tpipe
from repro_torch.data.datasets import build_scope_data, stratified_anchors
from repro_torch.data.worldsim import World
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import model as TM
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as TOpt
from repro_torch.training import sft as TSFT

F32_TOL = 2e-5
GRAD_TOL = 1e-4
STEP10_TOL = 1e-4


@pytest.fixture(scope="module")
def bridged():
    params = JM.init_params(jax.random.PRNGKey(0), JTINY)
    return params, _bridge(params)


def _bridge(params):
    return io.params_from_numpy(jax.tree.map(np.asarray, params), TINY,
                                device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _lm_batch(seed, b=3, s=20, labels=True):
    r = np.random.default_rng(seed)
    tokens = r.integers(0, TINY.vocab_size, size=(b, s)).astype(np.int32)
    batch = {"tokens": tokens}
    if labels:
        lab = r.integers(0, TINY.vocab_size, size=(b, s)).astype(np.int32)
        batch["labels"] = np.where(r.random((b, s)) < 0.3, -100,
                                   lab).astype(np.int32)
    return batch


def _grads(params, batch, **kw):
    loss, metrics, grads = TOpt.value_and_grad(
        lambda p: TM.loss_fn(p, TINY, batch, **kw), params)
    return loss, metrics, grads


def _worlds():
    """The reference's and the port's world, data, library and retriever,
    built afresh (``World.embed`` draws from the world's generator)."""
    jw, tw = JWorld(seed=0), World(seed=0)
    jdata = jbuild_scope_data(jw, n_queries=200, seed=0)
    tdata = build_scope_data(tw, n_queries=200, seed=0)
    janch = jbuild_anchor_set(jw, jstratified(jw, n=80, seed=7))
    tanch = build_anchor_set(tw, stratified_anchors(tw, n=80, seed=7))
    jlib, tlib = JLibrary(janch), FingerprintLibrary(tanch)
    for m in jw.pool:
        if m.seen:
            jlib.onboard(jw, m.name, seed=3)
            tlib.onboard(tw, m.name, seed=3)
    return ((jdata, jlib, JRetriever(janch)),
            (tdata, tlib, AnchorRetriever(tanch, device="cpu")))


# ---------------------------------------------------------------------------
# The loss and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("labels", [True, False])
def test_loss_fn_and_gradients_match_reference(bridged, labels):
    params, tparams = bridged
    batch = _lm_batch(1, labels=labels)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, JTINY, {k: jnp.asarray(v)
                                        for k, v in batch.items()}),
        has_aux=True)(params)
    loss, metrics, grads = _grads(
        tparams, tpipe.to_tensors(batch, "cpu"))
    assert float(loss) == pytest.approx(float(jloss), abs=F32_TOL)
    for k in ("ce", "acc", "aux"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]), abs=F32_TOL)
    jflat, tflat = io.flatten(jgrads), io.flatten(grads)
    assert list(jflat) == list(tflat)
    for key, jg in jflat.items():
        jg = np.asarray(jg, np.float32)
        tol = GRAD_TOL * max(float(np.abs(jg).max()), 1e-30)
        np.testing.assert_allclose(_np(tflat[key]), jg, rtol=0, atol=tol,
                                   err_msg=key)


def test_forward_train_logits_match_reference(bridged):
    params, tparams = bridged
    tokens = _lm_batch(2, labels=False)["tokens"]
    jlogits, jaux = JM.forward_train(params, JTINY,
                                     {"tokens": jnp.asarray(tokens)})
    logits, aux = TM.forward_train(tparams, TINY,
                                   {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), rtol=0,
                               atol=F32_TOL)
    assert float(aux) == float(jaux) == 0.0


def test_remat_on_and_off_give_the_same_gradients(bridged):
    _, tparams = bridged
    batch = tpipe.to_tensors(_lm_batch(3), "cpu")
    loss_a, _, ga = _grads(tparams, batch, remat=True)
    loss_b, _, gb = _grads(tparams, batch, remat=False)
    assert torch.equal(loss_a, loss_b)
    fa, fb = io.flatten(ga), io.flatten(gb)
    assert list(fa) == list(fb)
    for key in fa:
        assert torch.equal(fa[key], fb[key]), key


def test_stacked_leaf_gradient_is_stacked_once(bridged):
    """The training forward unbinds each stacked leaf once: its gradient is
    one (L, ...) tensor and every layer's slice is filled."""
    _, tparams = bridged
    _, _, grads = _grads(tparams, tpipe.to_tensors(_lm_batch(4), "cpu"))
    wq = grads["segments"][0]["0"]["attn"]["wq"]
    assert wq.shape == tparams["segments"][0]["0"]["attn"]["wq"].shape
    assert all(bool(wq[i].abs().sum() > 0) for i in range(TINY.num_layers))


# ---------------------------------------------------------------------------
# The plain flash backward (what the CUDA backward kernel is held to)
# ---------------------------------------------------------------------------
# b, hq, hkv, sq, sk, d, dv, kwargs; q_offset >= 0 so every row has a key
# (a row with none gives 0 in the port and the mean of v in ref.attention);
# softcap as the reference takes it (ref.attention's cap tanh(x / cap))
BWD_CASES = [
    (2, 4, 2, 17, 17, 32, 32, {}),
    (1, 8, 2, 40, 40, 64, 64, dict(window=7)),
    (1, 4, 4, 33, 50, 32, 32, dict(q_offset=17)),
    (2, 4, 1, 20, 20, 64, 32, {}),
    (1, 4, 2, 33, 50, 32, 32, dict(causal=False, window=9, q_offset=20)),
    (1, 6, 2, 25, 25, 32, 32, dict(window=4, q_offset=3)),
    (2, 4, 2, 17, 17, 32, 32, dict(softcap=20.0)),
    (1, 8, 2, 40, 40, 64, 64, dict(window=7, softcap=2.0)),
    (1, 4, 2, 33, 50, 32, 32, dict(causal=False, q_offset=20, softcap=5.0)),
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_backward_plain_matches_jax_grad(case):
    b, hq, hkv, sq, sk, d, dv, kw = case
    r = np.random.default_rng(sq * 7 + d)
    q, k, v = (r.standard_normal(s).astype(np.float32) for s in
               ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv)))
    dout = r.standard_normal((b, hq, sq, dv)).astype(np.float32)
    jg = jax.grad(lambda q_, k_, v_: jnp.sum(
        jops.flash_attention(q_, k_, v_, impl="ref", **kw) * dout),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    # the dispatcher on CPU tensors: autograd of the plain version
    out = FA.flash_attention(tq, tk, tv, **kw)
    tg = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for name, a, w in zip(("dq", "dk", "dv"), tg, jg, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0,
                                   atol=F32_TOL, err_msg=name)


def test_flash_backward_wrapper_needs_cuda():
    x = torch.zeros(1, 2, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bwd_cuda(x, x, x, x, x, torch.zeros(1, 2, 4))


# ---------------------------------------------------------------------------
# Data pipeline, SFT dataset, rewards
# ---------------------------------------------------------------------------
def test_pipeline_equals_reference():
    r = np.random.default_rng(0)
    prompts = [list(r.integers(16, 500, size=n)) for n in (5, 9, 1, 12, 7)]
    targets = [list(r.integers(16, 500, size=n)) for n in (3, 0, 6, 2, 9)]
    prompts = [[int(t) for t in p] for p in prompts]
    targets = [[int(t) for t in t_] for t_ in targets]
    for max_len in (8, 14, 20):
        want = jpipe.make_lm_batch(prompts, targets, max_len)
        got = tpipe.make_lm_batch(prompts, targets, max_len)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
            assert got[key].dtype == want[key].dtype
    for seq, n in (([1, 2, 3], 5), ([4, 5, 6, 7], 2), ([], 3)):
        np.testing.assert_array_equal(tpipe.pad_to(seq, n),
                                      jpipe.pad_to(seq, n))
    data = {"tokens": r.integers(0, 9, size=(23, 6)).astype(np.int32),
            "labels": r.integers(-100, 9, size=(23, 6)).astype(np.int32)}
    for kw in (dict(seed=0), dict(seed=3), dict(shuffle=False),
               dict(seed=1, drop_last=False)):
        want = list(jpipe.batches(data, 5, **kw))
        got = list(tpipe.batches(data, 5, device="cpu", **kw))
        assert len(got) == len(want)
        for gb, wb in zip(got, want, strict=True):
            for key in wb:
                assert gb[key].dtype == torch.int64
                np.testing.assert_array_equal(gb[key].numpy(),
                                              np.asarray(wb[key]))
    examples = [{"a": r.normal(size=3), "b": np.arange(i, i + 2)}
                for i in range(4)]
    want = jpipe.stack_examples(examples)
    got = tpipe.stack_examples(examples)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("cot", [True, False])
def test_build_sft_dataset_equals_reference(cot):
    (jd, jl, jr), (td, tl, tr) = _worlds()
    want = JSFT.build_sft_dataset(jd, jl, jr, cot=cot, max_examples=150,
                                  seed=1)
    got = TSFT.build_sft_dataset(td, tl, tr, cot=cot, max_examples=150,
                                 seed=1)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


@settings(max_examples=300, deadline=None)
@given(len_hat=st.floats(0, 5000), len_gt=st.floats(0, 5000),
       y_hat=st.integers(0, 1), y_gt=st.integers(0, 1),
       well_formed=st.booleans())
def test_rewards_equal_reference(len_hat, len_gt, y_hat, y_gt, well_formed):
    assert trw.adaptive_tolerance(len_gt) == jrw.adaptive_tolerance(len_gt)
    assert trw.token_reward(len_hat, len_gt) == jrw.token_reward(len_hat,
                                                                 len_gt)
    assert trw.correctness_reward(y_hat, y_gt) == jrw.correctness_reward(
        y_hat, y_gt)
    parsed = {"well_formed": well_formed, "y_hat": y_hat,
              "len_hat": len_hat}
    assert trw.grpo_reward(parsed, y_gt, len_gt) == jrw.grpo_reward(
        parsed, y_gt, len_gt)


# ---------------------------------------------------------------------------
# AdamW over the model tree, SFT steps
# ---------------------------------------------------------------------------
def test_adamw_on_the_model_tree_matches_reference_in_place(bridged):
    params, _ = bridged
    tparams = _bridge(params)
    cfg = JOpt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    r = np.random.default_rng(5)
    grads = jax.tree.map(
        lambda p: r.standard_normal(p.shape).astype(np.float32) * 0.05,
        params)
    jp, js = JOpt.adamw_update(cfg, grads, JOpt.adamw_init(params), params)
    state = TOpt.adamw_init(tparams)
    mu = state.mu
    tp, ts = TOpt.adamw_update(
        TOpt.AdamWConfig(**vars(cfg)),
        io.tree_map(torch.from_numpy, grads), state, tparams)
    assert tp is tparams and ts.mu is mu and ts.step == 1    # in place
    assert float(TOpt.global_norm(io.tree_map(torch.from_numpy, grads))) \
        == pytest.approx(float(JOpt.global_norm(grads)), rel=1e-6)
    for (key, want), got in zip(io.flatten(jp).items(),
                                io.flatten(tp).values(), strict=True):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=F32_TOL, err_msg=key)
    for want, got in zip(jax.tree.leaves(js.nu),
                         io.flatten(ts.nu).values(), strict=True):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=F32_TOL)


def test_adamw_in_pieces_equals_whole_leaves_bit_for_bit(bridged,
                                                        monkeypatch):
    """Leaves updated in pieces of 1000 elements (the embedding and every
    stacked leaf of scope-tiny span several, the last one short) give the
    whole-leaf update's params and moments bit for bit, over two steps."""
    params, _ = bridged
    cfg = TOpt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    r = np.random.default_rng(6)
    grads = [io.tree_map(lambda t: torch.from_numpy(
        r.standard_normal(tuple(t.shape)).astype(np.float32) * 0.05),
        _bridge(params)) for _ in range(2)]
    runs = []
    for piece in (TOpt.UPDATE_PIECE, 1000):
        monkeypatch.setattr(TOpt, "UPDATE_PIECE", piece)
        tparams = _bridge(params)
        state = TOpt.adamw_init(tparams)
        for g in grads:
            tparams, state = TOpt.adamw_update(cfg, g, state, tparams)
        runs.append([*io.flatten(tparams).values(),
                     *io.flatten(state.mu).values(),
                     *io.flatten(state.nu).values()])
    assert max(t.numel() for t in runs[0]) > 3 * 1000
    for a, b in zip(*runs, strict=True):
        assert torch.equal(a, b)


def test_sft_step_matches_reference(bridged):
    params, _ = bridged
    tparams = _bridge(params)
    batch = _lm_batch(6, b=4, s=24)
    cfg = JOpt.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=100)
    jp, _, jloss, jm = JSFT.sft_step(params, JTINY, JOpt.adamw_init(params),
                                     {k: jnp.asarray(v)
                                      for k, v in batch.items()}, cfg)
    tp, ts, tloss, tm = TSFT.sft_step(
        tparams, TINY, TOpt.adamw_init(tparams),
        tpipe.to_tensors(batch, "cpu"), TOpt.AdamWConfig(**vars(cfg)))
    assert float(tloss) == pytest.approx(float(jloss), abs=F32_TOL)
    assert float(tm["acc"]) == pytest.approx(float(jm["acc"]), abs=F32_TOL)
    assert ts.step == 1
    for (key, want), got in zip(io.flatten(jp).items(),
                                io.flatten(tp).values(), strict=True):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=F32_TOL, err_msg=key)
    assert all(not t.requires_grad for t in io.flatten(tp).values())


def test_train_sft_ten_steps_match_reference(bridged):
    params, _ = bridged
    tparams = _bridge(params)
    (jd, jl, jr), (td, tl, tr) = _worlds()
    jds = JSFT.build_sft_dataset(jd, jl, jr, max_examples=96, seed=0)
    tds = TSFT.build_sft_dataset(td, tl, tr, max_examples=96, seed=0)
    # 10 steps over 3 batches a shuffled epoch: the epochs' seeds differ
    _, jlosses = JSFT.train_sft(params, JTINY, jds, steps=10, batch_size=32)
    _, tlosses = TSFT.train_sft(tparams, TINY, tds, steps=10, batch_size=32)
    assert len(tlosses) == len(jlosses) == 10
    assert tlosses[0] == pytest.approx(jlosses[0], abs=F32_TOL)
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=STEP10_TOL)


def test_train_sft_refuses_a_dataset_smaller_than_one_batch():
    """40 examples at batch 64 make no batch: ``train_sft`` raises before
    its first step, naming both numbers (the reference's loop never ends,
    ``src/repro/training/sft.py:80``, so it is not run here)."""
    params = TM.init_params(TINY, seed=0, device="cpu")
    ds = _lm_batch(7, b=40, s=16)
    before = {k: v.clone() for k, v in io.flatten(params).items()}
    with pytest.raises(ValueError, match="40 examples.*batch of 64"):
        TSFT.train_sft(params, TINY, ds, steps=3, batch_size=64)
    assert all(torch.equal(t, before[k])
               for k, t in io.flatten(params).items())
    _, losses = TSFT.train_sft(params, TINY, _lm_batch(7, b=40, s=16),
                               steps=1, batch_size=40)
    assert len(losses) == 1


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
def test_port_checkpoint_loads_in_reference_bit_for_bit(bridged, tmp_path):
    params, _ = bridged
    tparams = TM.init_params(TINY, seed=3, device="cpu")
    tckpt.save(str(tmp_path / "port"), tparams)
    back = jckpt.load(str(tmp_path / "port"), params)
    for got, want in zip(jax.tree.leaves(back),
                         io.flatten(tparams).values(), strict=True):
        assert np.asarray(got).dtype == want.numpy().dtype
        np.testing.assert_array_equal(np.asarray(got), want.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_loads_in_port_bit_for_bit(tmp_path, dtype):
    jcfg = dataclasses.replace(JTINY, dtype=dtype)
    tcfg = dataclasses.replace(TINY, dtype=dtype)
    params = JM.init_params(jax.random.PRNGKey(4), jcfg)
    jckpt.save(str(tmp_path / "ref"), params)
    template = TM.init_params(tcfg, seed=0, device="cpu")
    got = tckpt.load(str(tmp_path / "ref.npz"), template)
    assert list(io.flatten(got)) == list(io.flatten(template))
    bits = io.flatten(io.params_from_numpy(jax.tree.map(np.asarray, params),
                                           tcfg, device="cpu"))
    for key, t in io.flatten(got).items():
        assert t.dtype == io.flatten(template)[key].dtype
        assert torch.equal(t, bits[key]), key
    # a port save of bf16 params reads back bit for bit, in the reference's
    # raw 2-byte records
    tckpt.save(str(tmp_path / "port"), got)
    again = tckpt.load(str(tmp_path / "port"), template)
    assert all(torch.equal(a, b) for a, b in zip(
        io.flatten(again).values(), io.flatten(got).values(), strict=True))
    with np.load(tmp_path / "port.npz") as z, \
            np.load(tmp_path / "ref.npz") as w:
        assert sorted(z.files) == sorted(w.files)
        assert all(z[k].dtype == w[k].dtype for k in w.files)


def test_checkpoint_load_checks_shapes(tmp_path):
    tparams = TM.init_params(TINY, seed=0, device="cpu")
    tckpt.save(str(tmp_path / "a"), tparams)
    small = dataclasses.replace(TINY, d_model=64)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load(str(tmp_path / "a"), TM.init_params(small, seed=0,
                                                       device="cpu"))
