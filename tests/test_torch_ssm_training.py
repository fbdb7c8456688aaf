"""Training the port's Mamba2 and zamba2 backbones against the reference:
the plain SSD scan backward (what ``csrc/ssd_scan_bwd.cu`` is held to on
the card) against ``jax.grad`` of ``repro.kernels.ref.ssd``, and the LM
loss, every gradient leaf, one SFT step and ten ``train_sft`` steps of the
small pure-SSM config and the small zamba2 hybrid against the reference on
bridged weights.

Tolerances: the plain SSD backward within 2e-5 x max(1, max|want|) of each
gradient (float32 on both sides, sums in other orders; a_cum in float64 on
the port's side); the emulated arithmetic of the kernel's bf16 body within
3e-2 x max(1, max|want|) of the plain version in float64, the gate the
kernel meets on the card, for dx and dA (bf16), and within 1e-4 for the
float32 gradients; loss within 2e-5; each
gradient leaf within 1e-4 of that leaf's largest magnitude; ten SFT steps'
losses within 1e-4, as in ``test_torch_training.py``.
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


@pytest.mark.parametrize("shape", [
    (57, 57, 64, 128), (57, 57, 64, 64), (256, 128, 64, 128), (49, 7, 12, 6),
    (66, 33, 64, 64), (64, 64, 256, 16),
])
def test_ssd_backward_shared_memory_bf16(shape):
    """The bf16 body's layout takes every shape the float32 body takes, and
    p 256 at a chunk of 64 besides; state terms add to it; at both SFT
    shapes it leaves room for the three blocks an SM the body is built
    for."""
    l, chunk, p, n = shape
    bf = torch.bfloat16
    x = torch.zeros(1, l, 2, p, dtype=bf)
    SS.check_args(x, torch.zeros(1, l, 2), torch.zeros(2, dtype=bf),
                  torch.zeros(1, l, n), torch.zeros(1, l, n), chunk,
                  backward=True)
    assert SS.bwd_smem_bytes(chunk, p, n, False, bf) < SS.bwd_smem_bytes(
        chunk, p, n, True, bf) <= SS.MAX_SMEM_BYTES
    if (l, chunk, p) == (57, 57, 64):
        assert 3 * (SS.bwd_smem_bytes(chunk, p, n, False, bf) + 1024) \
            <= SS.SM_SMEM_BYTES


# ---------------------------------------------------------------------------
# The bf16 body's arithmetic, emulated
# ---------------------------------------------------------------------------
LOG2E = 1.4426950408889634


def _split(v):
    """f32 values -> (hi, lo): hi = bf16(v), lo = bf16(v - hi), as f32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _mma(eq, *ops):
    """An einsum of bf16-exact operands as the tensor cores form it: exact
    products, summed in float64 and rounded once to f32 (the mma's f32 sums
    differ from that by a few ulp)."""
    return torch.einsum(eq, *(o.double() for o in ops)).float()


def _emulate_bf16_bwd(x, dt, A, B, C, dy):
    """(dx, d(dt), dA, dB, dC) as ``csrc/ssd_scan_bwd.cu``'s bf16 body forms
    them for one chunk of at most 64 positions and no state term (the SFT
    shapes): the scores G^T = B C^T in three products of the f32 values
    split in bf16 hi + lo (lo.hi + hi.lo + hi.hi); dW^T = x dy^T exact, times
    dt[t] after the product; L = exp2 of the difference of a_cum log2(e)
    rounded to f32 (a_cum summed in float64); the weights G L split in hi +
    lo as the A operand of dxd = (G L)^T dy (two products); dG summed over
    the heads, M's row sums minus column sums, the reverse running sum in
    float64; dC = dG B and dB = dG^T C in f32."""
    b, l, h, p = x.shape
    assert l <= 64
    xf, dyf, Af = x.float(), dy.float(), A.float()
    Bh, Bl = _split(B)
    Ch, Cl = _split(C)
    GT = (_mma("btn,bsn->bts", Bl, Ch) + _mma("btn,bsn->bts", Bh, Cl)
          + _mma("btn,bsn->bts", Bh, Ch))                        # (b, t, s)
    acum = torch.cumsum(dt.double() * Af.double(), dim=1)        # (b, l, h)
    acl = (acum * LOG2E).float()
    causal = torch.tril(torch.ones(l, l, dtype=torch.bool)).T    # t <= s
    L = torch.where(causal[None, :, :, None],
                    torch.exp2(acl[:, None, :, :] - acl[:, :, None, :]),
                    torch.zeros(()))                             # (b, t, s, h)
    dWT = _mma("bthp,bshp->btsh", xf, dyf) * dt[:, :, None, :]
    WkT = GT[..., None] * L
    dGT = (dWT * L).sum(-1)
    M = dWT * WkT
    dacum = M.sum(1) - M.sum(2)                                  # (b, l, h)
    Wh, Wl = _split(WkT)
    dxd = _mma("btsh,bshp->bthp", Wl, dyf) + _mma("btsh,bshp->bthp", Wh, dyf)
    da = torch.flip(torch.cumsum(torch.flip(dacum.double(), [1]), 1),
                    [1]).float()
    ddt = Af * da + (dxd * xf).sum(-1)
    dx = (dxd * dt[..., None]).to(x.dtype)
    dA = (da * dt).sum((0, 1)).to(A.dtype)
    dC = torch.einsum("bts,btn->bsn", dGT, B)
    dB = torch.einsum("bts,bsn->btn", dGT, C)
    return dx, ddt, dA, dB, dC


def test_split_bf16_arithmetic_within_the_bf16_gate():
    """mamba2-1.3b's SFT shape (57 positions, one chunk; 64 heads of 64,
    state 128) cut to two rows, x and dy in bf16, dt, B and C as the model's
    random weights give them: every gradient of the emulated bf16 body
    within 3e-2 x max(1, max|want|) of the plain version in float64, the
    float32 ones (d(dt), dB, dC) within 1e-4 x max(1, max|want|) (weights
    without their lo part put d(dt) at ~2e-3), and the split scores within
    2^-14 of sum |C||B| of the exact ones."""
    r = np.random.default_rng(22)
    b, l, h, p, n = 2, 57, 64, 64, 128
    bf = torch.bfloat16
    x = torch.from_numpy(r.standard_normal((b, l, h, p)) * 0.5).float().to(bf)
    dt = torch.nn.functional.softplus(
        torch.from_numpy(r.standard_normal((b, l, h))).float())
    A = (-torch.exp(torch.from_numpy(r.standard_normal(h) * 0.3))).float() \
        .to(bf)
    B, C = (torch.from_numpy(r.standard_normal((b, l, n)) * 0.5).float()
            for _ in range(2))
    dy = torch.from_numpy(r.standard_normal((b, l, h, p))).float().to(bf)
    Bh, Bl = _split(B)
    Ch, Cl = _split(C)
    got_g = (_mma("btn,bsn->bts", Bl, Ch) + _mma("btn,bsn->bts", Bh, Cl)
             + _mma("btn,bsn->bts", Bh, Ch)).double()
    exact = torch.einsum("btn,bsn->bts", B.double(), C.double())
    size = torch.einsum("btn,bsn->bts", B.double().abs(), C.double().abs())
    assert bool(((got_g - exact).abs() <= 2.0 ** -14 * size).all())
    got = _emulate_bf16_bwd(x, dt, A, B, C, dy)
    want = SS.ssd_scan_bwd_plain(*(t.double() for t in (x, dt, A, B, C, dy)),
                                 chunk=l)
    for name, g, w, inp in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                               (x, dt, A, B, C), strict=True):
        assert g.dtype == inp.dtype and g.shape == inp.shape, name
        w = w.double()
        tol = (3e-2 if inp.dtype == bf else 1e-4) * max(1.0,
                                                        float(w.abs().max()))
        err = float((g.double() - w).abs().max())
        assert err <= tol, f"{name}: {err} > {tol}"


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
