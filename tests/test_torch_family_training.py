"""Training the dense, multimodal and MoE families against the reference:
the loss and every gradient leaf of the small starcoder2, internlm2,
qwen2-vl (with image stubs) and whisper (with frame stubs), with and
without the per-layer checkpoints; ten ``train_sft`` steps of one family
of each kind (starcoder2, whisper, qwen3-moe); the stub batch the trainer
feeds a multimodal config (``pipeline.with_stubs``); and the flash
backward's head dims, MLA's (192, 128) and (48, 32) among them.  gemma2,
qwen3-moe and deepseek-v2 have their gradient tests beside their serving
tests (``test_torch_dense_families.py``, ``test_torch_moe.py``,
``test_torch_mla.py``).

Tolerances, as ``test_torch_training.py``'s: loss, ce, acc and aux within
2e-5 (float32 on both sides, sums in other orders); each gradient leaf
within 1e-4 of that leaf's largest magnitude; ten SFT steps' losses within
1e-4, the first within 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_training import F32_TOL, GRAD_TOL, STEP10_TOL, _np, _worlds

from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.training import optimizer as JOpt
from repro.training import sft as JSFT
from repro_torch import io
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import model as TM
from repro_torch.training import optimizer as TOpt
from repro_torch.training import sft as TSFT

# the families whose gradients this file holds, each with the leaves a
# stub must reach (a substring of a gradient leaf's key)
GRAD_FAMILIES = {"starcoder2-3b": (), "internlm2-1.8b": (),
                 "qwen2-vl-7b": ("vision_proj",),
                 "whisper-medium": ("frontend_proj", "cross")}
# one family of each kind trains ten steps
SFT_FAMILIES = ("starcoder2-3b", "whisper-medium", "qwen3-moe-235b-a22b")


def _pair(name, seed=0):
    jcfg, tcfg = jget_config(name).reduced(), get_config(name).reduced()
    params = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = io.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, tcfg, params, tp


def _stub_batch(tcfg, seed, b=3, s=40):
    """Random tokens and labels (30 % ignored) with ``with_stubs``' inputs,
    as CPU tensors."""
    r = np.random.default_rng(seed)
    tokens = r.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.where(r.random((b, s)) < 0.3, -100,
                      r.integers(0, tcfg.vocab_size, (b, s))).astype(np.int32)
    return tpipe.with_stubs(tpipe.to_tensors(
        {"tokens": tokens, "labels": labels}, "cpu"), tcfg, seed=seed + 1)


def _jax(batch):
    """The port's batch as the reference takes it (int64 columns as
    int32)."""
    return {k: jnp.asarray(v.numpy().astype(np.int32)
                           if v.dtype == torch.int64 else v.numpy())
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=sorted(GRAD_FAMILIES))
def graded(request):
    """A family's configs, params, stub batch, and the reference's loss,
    metrics and gradient leaves, computed once for both remat cases."""
    jcfg, tcfg, params, tp = _pair(request.param, seed=11)
    batch = _stub_batch(tcfg, 12)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, _jax(batch)), has_aux=True)(params)
    return (request.param, tcfg, tp, batch, float(jloss),
            {k: float(v) for k, v in jm.items()}, io.flatten(jgrads))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_loss_and_gradients_match_reference(graded, remat):
    """Every leaf has a gradient equal to the reference's, the stubs'
    projections and the encoder and cross-attention included."""
    name, tcfg, tp, batch, jloss, jm, jflat = graded
    loss, metrics, grads = TOpt.value_and_grad(
        lambda p: TM.loss_fn(p, tcfg, batch, remat=remat), tp)
    assert float(loss) == pytest.approx(jloss, abs=F32_TOL)
    for k in ("ce", "acc", "aux"):
        assert float(metrics[k]) == pytest.approx(jm[k], abs=F32_TOL)
    tflat = io.flatten(grads)
    assert list(jflat) == list(tflat)
    for part in GRAD_FAMILIES[name]:
        hit = [k for k in tflat if part in k]
        assert hit and all(float(tflat[k].abs().max()) > 0 for k in hit), part
    for key, jg in jflat.items():
        jg = np.asarray(jg, np.float32)
        tol = GRAD_TOL * max(float(np.abs(jg).max()), 1e-30)
        np.testing.assert_allclose(_np(tflat[key]), jg, rtol=0, atol=tol,
                                   err_msg=key)


def _reference_train_sft(params, jcfg, tcfg, ds, steps, batch_size, seed=0):
    """The reference's ``train_sft`` loop (its batches, shuffles, AdamW and
    ``sft_step``), each batch given the stubs the port's trainer adds: the
    reference's trainer feeds text alone, which whisper's loss cannot
    take.  Returns the losses."""
    opt_cfg = JOpt.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    opt_state = JOpt.adamw_init(params)
    losses = []
    epoch = 0
    while len(losses) < steps:
        for b in jpipe.batches(ds, batch_size, seed=seed + epoch):
            batch = tpipe.with_stubs(
                tpipe.to_tensors({k: np.asarray(v) for k, v in b.items()},
                                 "cpu"), tcfg, seed=seed + len(losses))
            params, opt_state, loss, _ = JSFT.sft_step(
                params, jcfg, opt_state, _jax(batch), opt_cfg)
            losses.append(float(loss))
            if len(losses) >= steps:
                break
        epoch += 1
    return losses


@pytest.fixture(scope="module")
def sft_datasets():
    (jd, jl, jr), (td, tl, tr) = _worlds()
    return (JSFT.build_sft_dataset(jd, jl, jr, max_examples=24, seed=0),
            TSFT.build_sft_dataset(td, tl, tr, max_examples=24, seed=0))


@pytest.mark.parametrize("name", SFT_FAMILIES)
def test_train_sft_ten_steps_match_reference(sft_datasets, name):
    """Ten steps of 8 examples over shuffled epochs of 24; whisper's carry
    its frame stubs, on both sides the same."""
    jds, tds = sft_datasets
    jcfg, tcfg, params, tp = _pair(name)
    if tcfg.is_encoder_decoder:
        jlosses = _reference_train_sft(params, jcfg, tcfg, jds, 10, 8)
    else:
        _, jlosses = JSFT.train_sft(params, jcfg, jds, steps=10,
                                    batch_size=8)
    _, tlosses = TSFT.train_sft(tp, tcfg, tds, steps=10, batch_size=8)
    assert len(tlosses) == len(jlosses) == 10
    assert tlosses[0] == pytest.approx(jlosses[0], abs=F32_TOL)
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=STEP10_TOL)


# ---------------------------------------------------------------------------
# the stub batch
# ---------------------------------------------------------------------------
def test_with_stubs_lays_out_the_reference_inputs():
    """Text-only batches pass through; whisper gets frames, qwen2-vl its
    patches in front of the text on Qwen2-VL's grid, in the model dtype,
    the same values for the same seed on any device."""
    text = {"tokens": torch.arange(12).reshape(2, 6),
            "labels": torch.arange(12).reshape(2, 6)}
    assert tpipe.with_stubs(text, get_config("starcoder2-3b"), seed=0) is text
    audio = tpipe.with_stubs(text, get_config("whisper-medium"), seed=3)
    assert set(audio) == {"tokens", "labels", "enc_features"}
    assert audio["enc_features"].shape == (2, 1500, 1024)
    assert audio["enc_features"].dtype == torch.bfloat16
    assert audio["tokens"] is text["tokens"]
    again = tpipe.with_stubs(text, get_config("whisper-medium"), seed=3)
    assert torch.equal(again["enc_features"], audio["enc_features"])

    cfg = get_config("qwen2-vl-7b").reduced()        # 8 patches, float32
    vlm = tpipe.with_stubs(text, cfg, seed=4)
    P = cfg.num_stub_patches
    assert vlm["image_embeds"].shape == (2, P, cfg.d_model)
    assert vlm["image_embeds"].dtype == torch.float32
    assert torch.equal(vlm["tokens"][:, P:], text["tokens"])
    assert bool((vlm["tokens"][:, :P] == 0).all())
    assert bool((vlm["labels"][:, :P] == -100).all())
    assert torch.equal(vlm["labels"][:, P:], text["labels"])
    pos = vlm["positions_3d"]
    assert pos.shape == (3, 2, P + 6)
    side = 3                                           # ceil(sqrt(8))
    want = np.zeros((3, 2, P + 6), np.int64)
    want[1, :, :P], want[2, :, :P] = np.arange(P) // side, np.arange(P) % side
    want[:, :, P:] = side + np.arange(6)
    np.testing.assert_array_equal(pos.numpy(), want)


# ---------------------------------------------------------------------------
# the flash backward's head dims: one ``check_args`` for both kernels, which
# ``flash_attention_cuda`` and ``flash_attention_bwd_cuda`` each call
# ---------------------------------------------------------------------------
def _qkv(d, dv):
    q = torch.zeros(1, 2, 4, d)
    return q, torch.zeros(1, 2, 4, d), torch.zeros(1, 2, 4, dv)


@pytest.mark.parametrize("d,dv", [(192, 128), (48, 32), (112, 112),
                                  (256, 32), (64, 64)])
def test_flash_backward_takes_mla_pairs_and_the_square_dims(d, dv):
    FA.check_args(*_qkv(d, dv))


@pytest.mark.parametrize("d,dv", [(192, 64), (128, 192), (48, 48), (32, 48),
                                  (112, 128), (192, 192)])
def test_flash_backward_refuses_other_unequal_pairs(d, dv):
    with pytest.raises(ValueError, match="head dims.*the flash kernels"):
        FA.check_args(*_qkv(d, dv))
