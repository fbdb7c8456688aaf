"""Training the port's Mamba2 and zamba2 backbones against the reference:
the plain SSD scan backward (what ``csrc/ssd_scan_bwd.cu`` is held to on
the card) against ``jax.grad`` of ``repro.kernels.ref.ssd``, and the LM
loss, every gradient leaf, one SFT step and ten ``train_sft`` steps of the
small pure-SSM config and the small zamba2 hybrid against the reference on
bridged weights.

Tolerances: the plain SSD backward within 2e-5 x max(1, max|want|) of each
gradient (float32 on both sides, sums in other orders; a_cum in float64 on
the port's side); loss within 2e-5; each gradient leaf within 1e-4 of that
leaf's largest magnitude; ten SFT steps' losses within 1e-4, as in
``test_torch_training.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_training import (F32_TOL, GRAD_TOL, STEP10_TOL, _lm_batch,
                                 _np, _worlds)

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.training import optimizer as JOpt
from repro.training import sft as JSFT
from repro_torch import io
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ssd_scan as SS
from repro_torch.models import model as TM
from repro_torch.training import optimizer as TOpt
from repro_torch.training import sft as TSFT

# the small pure-SSM config (mamba2-1.3b.reduced() with its shared block
# off; reduced() alone is zamba2's layout) and the small zamba2 hybrid (two
# units of two mambas and the tied block, then a mamba; heads of 112)
CONFIGS = {"ssm": ("mamba2-1.3b", {}, True),
           "hybrid": ("zamba2-7b", dict(num_layers=5, d_model=448), False)}


def _configs(kind):
    name, kw, pure = CONFIGS[kind]
    jcfg, tcfg = jget_config(name).reduced(**kw), get_config(name).reduced(**kw)
    if pure:
        jcfg = dataclasses.replace(jcfg, shared_attn_every=0)
        tcfg = dataclasses.replace(tcfg, shared_attn_every=0)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    jcfg, tcfg = _configs(request.param)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params


def _bridge(params, tcfg):
    return io.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")


# ---------------------------------------------------------------------------
# The plain SSD backward
# ---------------------------------------------------------------------------
# b, l, h, p, n, chunk, dt scale, with a final-state gradient: chunk 1, chunk
# = l, several chunks, heads the kernel's group of 4 does not divide, large
# and small steps
SSD_BWD_CASES = [
    (2, 6, 3, 4, 5, 1, 1.0, False),
    (2, 12, 3, 4, 5, 12, 1.0, True),
    (2, 12, 3, 4, 5, 12, 1.0, False),
    (2, 24, 5, 8, 6, 6, 0.1, True),
    (1, 16, 2, 4, 4, 4, 3.0, False),
    (2, 20, 6, 8, 4, 5, 0.01, True),
]


def _ssd_case(seed, b, l, h, p, n, dt_scale, with_dstate):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((b, l, h, p)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(r.standard_normal((b, l, h)))) * dt_scale).astype(
        np.float32)
    A = (-np.exp(r.standard_normal(h) * 0.3)).astype(np.float32)
    B, C = ((r.standard_normal((b, l, n)) * 0.5).astype(np.float32)
            for _ in range(2))
    dy = r.standard_normal((b, l, h, p)).astype(np.float32)
    ds = (r.standard_normal((b, h, p, n)).astype(np.float32)
          if with_dstate else None)
    return (x, dt, A, B, C), dy, ds


def _close_each(got, want, what):
    want = np.asarray(want, np.float32)
    tol = F32_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("case", SSD_BWD_CASES)
def test_ssd_bwd_plain_matches_jax_grad(case):
    b, l, h, p, n, chunk, dt_scale, with_dstate = case
    inputs, dy, ds = _ssd_case(l * 7 + chunk, b, l, h, p, n, dt_scale,
                               with_dstate)

    def loss(*args):
        y, state = jref.ssd(*args, chunk=chunk)
        out = jnp.sum(y * dy)
        return out if ds is None else out + jnp.sum(state * ds)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, inputs))
    got = SS.ssd_scan_bwd_plain(
        *map(torch.from_numpy, inputs), torch.from_numpy(dy),
        None if ds is None else torch.from_numpy(ds), chunk=chunk)
    for name, g, w, x in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                             inputs, strict=True):
        assert g.dtype == torch.float32 and tuple(g.shape) == x.shape
        _close_each(g, w, name)


@pytest.mark.parametrize("case", SSD_BWD_CASES[:3])
def test_ssd_dispatch_on_cpu_is_autograd_of_the_plain_scan(case):
    """On CPU tensors that require grad, ``ops.ssd`` runs ``ref.ssd`` under
    autograd (no kernel, no ``SSDScan``), which gives the plain backward's
    gradients."""
    b, l, h, p, n, chunk, dt_scale, with_dstate = case
    inputs, dy, ds = _ssd_case(1, b, l, h, p, n, dt_scale, with_dstate)
    leaves = [torch.tensor(v, requires_grad=True) for v in inputs]
    before = launch_counts()
    y, state = SS.ssd_scan(*leaves, chunk=chunk)
    out = (y * torch.from_numpy(dy)).sum()
    if ds is not None:
        out = out + (state * torch.from_numpy(ds)).sum()
    got = torch.autograd.grad(out, leaves)
    assert launch_counts() == before
    want = SS.ssd_scan_bwd_plain(
        *map(torch.from_numpy, inputs), torch.from_numpy(dy),
        None if ds is None else torch.from_numpy(ds), chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                          strict=True):
        _close_each(g, w.numpy(), name)


def test_ssd_bwd_plain_keeps_input_dtypes():
    inputs, dy, _ = _ssd_case(2, 2, 8, 3, 4, 5, 1.0, False)
    x, dt, A, B, C = map(torch.from_numpy, inputs)
    bf = torch.bfloat16
    got = SS.ssd_scan_bwd_plain(x.to(bf), dt, A.to(bf), B, C,
                                torch.from_numpy(dy).to(bf), chunk=4)
    assert [g.dtype for g in got] == [bf, torch.float32, bf, torch.float32,
                                      torch.float32]


def test_ssd_bwd_wrapper_needs_cuda():
    """The backward's wrapper launches its kernel or raises: a CPU tensor
    never slides onto the plain version there."""
    x = torch.zeros(1, 4, 2, 8)
    dt, A = torch.zeros(1, 4, 2), torch.zeros(2)
    B = C = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        SS.ssd_scan_bwd_cuda(x, dt, A, B, C, x, None, None, chunk=4)


# (l, chunk, p, n) the backward kernel takes: the SFT shapes of
# mamba2-1.3b (state 128) and zamba2-7b (state 64), and a chunk of 128,
# walked in pieces of 64; then two whose shared memory passes 227 KB
@pytest.mark.parametrize("shape,ok", [
    ((57, 57, 64, 128), True), ((57, 57, 64, 64), True),
    ((256, 128, 64, 128), True), ((49, 7, 12, 6), True),
    ((64, 64, 64, 512), False), ((64, 64, 256, 16), False),
])
def test_ssd_backward_shared_memory(shape, ok):
    l, chunk, p, n = shape
    x = torch.zeros(1, l, 2, p)
    args = (x, torch.zeros(1, l, 2), torch.zeros(2), torch.zeros(1, l, n),
            torch.zeros(1, l, n), chunk)
    assert SS.bwd_smem_bytes(chunk, p, n, False) < SS.bwd_smem_bytes(
        chunk, p, n, True)
    if ok:
        SS.check_args(*args, backward=True)
        return
    try:
        SS.check_args(*args)          # the forward may still take it
    except ValueError:
        pass
    with pytest.raises(ValueError):
        SS.check_args(*args, backward=True)


# ---------------------------------------------------------------------------
# The loss, its gradients and SFT steps on the SSM and hybrid stacks
# ---------------------------------------------------------------------------
def _batch(seed, b=3, s=40):
    batch = _lm_batch(seed, b=b, s=s)
    return batch, {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradients_match_reference(pair, remat):
    """s 40 at the small configs' chunk of 16: the scan's largest chunk
    dividing 40 is 10, four chunks, so the state terms of the gradient run;
    the hybrid's tied block gets the sum of its two occurrences."""
    jcfg, tcfg, params = pair
    batch, jbatch = _batch(11)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jbatch), has_aux=True)(params)
    loss, metrics, grads = TOpt.value_and_grad(
        lambda p: TM.loss_fn(p, tcfg, tpipe.to_tensors(batch, "cpu"),
                             remat=remat), _bridge(params, tcfg))
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
    assert float(torch.stack([t.abs().sum() for t in tflat.values()]).min()) \
        > 0


def test_sft_step_matches_reference(pair):
    jcfg, tcfg, params = pair
    tparams = _bridge(params, tcfg)
    batch, jbatch = _batch(6, b=4, s=24)
    cfg = JOpt.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=100)
    jp, _, jloss, jm = JSFT.sft_step(params, jcfg, JOpt.adamw_init(params),
                                     jbatch, cfg)
    tp, ts, tloss, tm = TSFT.sft_step(
        tparams, tcfg, TOpt.adamw_init(tparams),
        tpipe.to_tensors(batch, "cpu"), TOpt.AdamWConfig(**vars(cfg)))
    assert float(tloss) == pytest.approx(float(jloss), abs=F32_TOL)
    assert float(tm["acc"]) == pytest.approx(float(jm["acc"]), abs=F32_TOL)
    assert ts.step == 1
    for (key, want), got in zip(io.flatten(jp).items(),
                                io.flatten(tp).values(), strict=True):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=F32_TOL, err_msg=key)


def test_train_sft_ten_steps_match_reference(pair):
    """Ten steps of 8 examples over shuffled epochs of 24 (kept small: the
    hybrid's steps are among the slowest of the port's CPU tests)."""
    jcfg, tcfg, params = pair
    (jd, jl, jr), (td, tl, tr) = _worlds()
    jds = JSFT.build_sft_dataset(jd, jl, jr, max_examples=24, seed=0)
    tds = TSFT.build_sft_dataset(td, tl, tr, max_examples=24, seed=0)
    _, jlosses = JSFT.train_sft(params, jcfg, jds, steps=10, batch_size=8)
    _, tlosses = TSFT.train_sft(_bridge(params, tcfg), tcfg, tds, steps=10,
                                batch_size=8)
    assert len(tlosses) == len(jlosses) == 10
    assert tlosses[0] == pytest.approx(jlosses[0], abs=F32_TOL)
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=STEP10_TOL)
