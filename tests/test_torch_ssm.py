"""The port's Mamba2 SSM path against the JAX package on the same inputs.

The plain SSD scan against ``ref.ssd`` and the Pallas kernel (interpret
mode), the decode recurrence and the ``init_state`` handoff, the mamba
block, the pure-SSM model on bridged weights, the sampler (generation,
guards, refill of the conv/SSM rows) and ``ScopeEngine.serve``.

The CUDA kernels (the scan, the in-place decode step) run only on the card:
``chip_smoke.py`` holds them against the plain versions ``ref.ssd`` and
``ref.ssd_decode_step`` there.  Here the plain versions are held to JAX, a
float32 emulation of the scan kernel's arithmetic is held to the Pallas
kernel and to a float64 witness, and the wrappers' argument checks and
device dispatch are exercised on the CPU.
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
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as ssd_pallas
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro.serving import kv_pool as JK
from repro.serving import sampler as JS
from repro_torch import api as tapi
from repro_torch import io
from repro_torch.configs import get_config, zamba2_7b
from repro_torch.configs.base import ModelConfig
from repro_torch.core.estimator import ReasoningEstimator as TEstimator
from repro_torch.core.fingerprint import FingerprintLibrary, build_anchor_set
from repro_torch.core.retrieval import AnchorRetriever
from repro_torch.data.datasets import build_scope_data, stratified_anchors
from repro_torch.data.worldsim import World
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_decode_step as SD
from repro_torch.kernels import ssd_scan as SS
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import layer_view
from repro_torch.serving import kv_pool as TK
from repro_torch.serving import sampler as TS

F32_TOL = 2e-5
BF16_TOL = 3e-2
N_QUERIES = 8
PROMPT_LEN = 49            # SCOPE's structured prompts: chunk 7 at ssm_chunk 16

# b, l, h, p, n, chunk  (tests/test_kernels.py)
SSD_CASES = [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 3, 16, 8, 32),
    (2, 96, 1, 32, 16, 24),
    (1, 256, 4, 8, 4, 128),
]
# the chunks the port's main paths give the kernel: 7 (the small config's
# 49-token prompt), 49 (mamba2-1.3b's), with bf16 x and A at the latter
SSD_MORE = [
    (2, 49, 3, 16, 8, 7, "float32"),
    (2, 49, 4, 32, 16, 7, "bfloat16"),
    (1, 49, 2, 64, 128, 49, "bfloat16"),
]
SSD_ALL = [c + ("float32",) for c in SSD_CASES] + SSD_MORE


def _ssd_inputs(seed, b, l, h, p, n):
    """numpy inputs distributed as in ``tests/test_kernels.py``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32) * 0.5
    dt = (np.log1p(np.exp(rng.standard_normal((b, l, h)))) * 0.1).astype(
        np.float32)
    A = -np.exp(rng.standard_normal((h,)) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, l, n)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, l, n)).astype(np.float32) * 0.5
    return x, dt, A, B, C


def _both(x, dt, A, B, C, dtype="float32"):
    """(jax arrays, torch CPU tensors) of the same values; x and A in
    ``dtype``, dt, B, C in float32."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    j = (jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A, jdt),
         jnp.asarray(B), jnp.asarray(C))
    t = (torch.tensor(x).to(tdt), torch.tensor(dt), torch.tensor(A).to(tdt),
         torch.tensor(B), torch.tensor(C))
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", SSD_ALL)
@pytest.mark.parametrize("against", ["ref", "pallas"])
def test_ssd_plain_matches_jax(case, against):
    """y within 2e-5 (f32) or 3e-2 (bf16 y: a 1e-7 difference may round
    to the neighbouring bf16 value), the f32 final state within 2e-5."""
    b, l, h, p, n, chunk, dtype = case
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        *_ssd_inputs(0, b, l, h, p, n), dtype=dtype)
    if against == "ref":
        yw, sw = jref.ssd(jx, jdt, jA, jB, jC, chunk=chunk)
    else:
        yw, sw = ssd_pallas(jx, jdt, jA, jB, jC, chunk=chunk, interpret=True)
    yg, sg = ops.ssd(tx, tdt, tA, tB, tC, chunk=chunk)
    assert yg.dtype == tx.dtype and sg.dtype == torch.float32
    assert tuple(yg.shape) == (b, l, h, p) and tuple(sg.shape) == (b, h, p, n)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(yg), _np(yw), atol=tol, rtol=0)
    np.testing.assert_allclose(_np(sg), _np(sw), atol=F32_TOL, rtol=0)


def test_ssd_init_state_handoff_matches_jax():
    """Two chunked scans chained through ``init_state`` == one long scan,
    and == JAX's handoff on the same inputs."""
    b, l, h, p, n = 1, 64, 2, 8, 4
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        *_ssd_inputs(7, b, l, h, p, n))
    y_full, s_full = ops.ssd(tx, tdt, tA, tB, tC, chunk=16)
    h2 = l // 2
    y1, s1 = ops.ssd(tx[:, :h2], tdt[:, :h2], tA, tB[:, :h2], tC[:, :h2],
                     chunk=16)
    y2, s2 = ops.ssd(tx[:, h2:], tdt[:, h2:], tA, tB[:, h2:], tC[:, h2:],
                     chunk=16, init_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=F32_TOL)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=F32_TOL)
    jy1, js1 = jref.ssd(jx[:, :h2], jdt[:, :h2], jA, jB[:, :h2], jC[:, :h2],
                        chunk=16)
    jy2, js2 = jref.ssd(jx[:, h2:], jdt[:, h2:], jA, jB[:, h2:], jC[:, h2:],
                        chunk=16, init_state=js1)
    np.testing.assert_allclose(y2.numpy(), _np(jy2), atol=F32_TOL)
    np.testing.assert_allclose(s2.numpy(), _np(js2), atol=F32_TOL)


def test_ssd_decode_step_matches_chunked_scan_and_jax():
    b, l, h, p, n = 1, 32, 2, 8, 4
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        *_ssd_inputs(6, b, l, h, p, n))
    y_chunk, s_chunk = tref.ssd(tx, tdt, tA, tB, tC, chunk=8)
    st, jst, ys = torch.zeros((b, h, p, n)), jnp.zeros((b, h, p, n)), []
    for t in range(l):
        yt, st = ops.ssd_decode_step(st, tx[:, t], tdt[:, t], tA, tB[:, t],
                                     tC[:, t])
        jyt, jst = jref.ssd_decode_step(jst, jx[:, t], jdt[:, t], jA,
                                        jB[:, t], jC[:, t])
        np.testing.assert_allclose(yt.numpy(), _np(jyt), atol=F32_TOL)
        ys.append(yt)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_chunk.numpy(),
                               atol=F32_TOL)
    np.testing.assert_allclose(st.numpy(), s_chunk.numpy(), atol=F32_TOL)
    np.testing.assert_allclose(st.numpy(), _np(jst), atol=F32_TOL)


def test_ssd_cpu_dispatch_runs_plain_and_counts_no_launch():
    _, (tx, tdt, tA, tB, tC) = _both(*_ssd_inputs(1, 1, 32, 2, 8, 4))
    before = launch_counts()
    y, s = ops.ssd(tx, tdt, tA, tB, tC, chunk=8)
    yp, sp = tref.ssd(tx, tdt, tA, tB, tC, chunk=8)
    assert ops.ssd is SS.ssd_scan
    assert torch.equal(y, yp) and torch.equal(s, sp)
    assert launch_counts() == before
    assert "ssd_scan" in before


def test_ssd_off_cpu_launches_or_raises():
    """A non-CPU tensor never reaches the plain version: without a card a
    meta tensor raises before any launch, and an ``init_state`` raises as
    the reference's ``ops.ssd`` does for Pallas."""
    args = [torch.empty(s, device="meta") for s in
            ((1, 8, 2, 4), (1, 8, 2), (2,), (1, 8, 4), (1, 8, 4))]
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd(*args, chunk=8)
    with pytest.raises(ValueError, match="CUDA"):
        SS.ssd_scan_cuda(*args, chunk=8)
    with pytest.raises(NotImplementedError, match="zero state"):
        ops.ssd(*args, chunk=8,
                init_state=torch.zeros((1, 2, 4, 4), device="meta"))


def _args(b=1, l=8, h=2, p=4, n=4, xdt=torch.float32, dtdt=torch.float32):
    return (torch.zeros(b, l, h, p, dtype=xdt), torch.zeros(b, l, h,
                                                            dtype=dtdt),
            torch.zeros(h), torch.zeros(b, l, n), torch.zeros(b, l, n))


@pytest.mark.parametrize("args,chunk,match", [
    (_args(), 3, "chunk"),
    (_args(l=256), 256, "chunk"),
    (_args(l=128, p=8, n=1024), 128, "shared memory"),
    (_args(l=32, p=8, n=1024), 32, "shared memory"),
    (_args(dtdt=torch.bfloat16), 8, "float32"),
    (_args(xdt=torch.float16), 8, "float32 or bfloat16"),
    (_args()[:3] + (torch.zeros(1, 8, 3), torch.zeros(1, 8, 4)), 8,
     "shape mismatch"),
    ((torch.zeros(1, 8, 2, 8)[..., ::2],) + _args()[1:], 8, "contiguous"),
    (_args(l=64, p=128, n=128), 64, "register tiles"),
    (_args(p=4, n=2048), 8, "register tiles"),
])
def test_ssd_check_args_rejects(args, chunk, match):
    with pytest.raises(ValueError, match=match):
        SS.check_args(*args, chunk)


def test_ssd_check_args_takes_the_main_path_shapes():
    """mamba2-1.3b's prefill (chunk 49) and a full 128-token chunk fit; the
    single chunk of 49 leaves room for two blocks an SM (no staged state)."""
    for l, chunk in ((49, 49), (256, 128), (1, 1)):
        SS.check_args(*_args(b=1, l=l, h=2, p=64, n=128,
                             xdt=torch.bfloat16), chunk)
    assert SS.smem_bytes(256, 128, 64, 128) <= SS.MAX_SMEM_BYTES
    assert 2 * SS.smem_bytes(49, 49, 64, 128) <= SS.MAX_SMEM_BYTES
    assert SS.piece_len(128) == 64 and SS.piece_len(49) == 49


# ---------------------------------------------------------------------------
# the scan kernel's arithmetic (csrc/ssd_scan.cu), emulated on the CPU
# ---------------------------------------------------------------------------
def _emulate_ssd_kernel(x, dt, A, B, C, chunk):
    """float32 emulation of ``ssd_kernel``: blocks of ``SS.GROUP`` heads of
    one row, chunks walked in pieces of ``SS.piece_len(chunk)``, the scores
    C[s].B[t] computed once per piece and shared by the group's heads, and
    the kernel's summation orders: each score over k in order within the
    halves [0, kh) and [kh, n), then lo + hi; y_diag over t (W is 0 for
    t > s), then + (exp(a_cum[s]) C[s]) . h over k; the state scaled by
    exp(a_total), then + Xp[t] B[t]^T over t.  a_cum is summed in float64
    from the exact products dt * A; each exponent, a difference of two such
    sums, is rounded once to float32."""
    b, l, h, p = x.shape
    n = B.shape[2]
    xf, Af = x.float(), A.float()
    tp = SS.piece_len(chunk)
    kh = (SS._round4(n) // 8) * 4
    pieces = [(c * chunk + t0, min(tp, chunk - t0))
              for c in range(l // chunk) for t0 in range(0, chunk, tp)]
    y = torch.zeros(b, l, h, p)
    state = torch.zeros(b, h, p, n)
    for h0 in range(0, h, SS.GROUP):
        scores = {}                             # piece -> (b, T, T) C.B^T
        for hi in range(h0, min(h0 + SS.GROUP, h)):
            hs = torch.zeros(b, p, n)
            for q, (t0, tl) in enumerate(pieces):
                Bp, Cp = B[:, t0:t0 + tl], C[:, t0:t0 + tl]
                if q not in scores:
                    halves = []
                    for ks in (range(0, min(kh, n)), range(kh, n)):
                        S = torch.zeros(b, tl, tl)
                        for k in ks:
                            S = S + Cp[:, :, None, k] * Bp[:, None, :, k]
                        halves.append(S)
                    scores[q] = halves[0] + halves[1]
                dts = dt[:, t0:t0 + tl, hi]
                acum = torch.cumsum(dts.double() * Af[hi].double(), 1)
                a_total = acum[:, -1]
                Xd = xf[:, t0:t0 + tl, hi] * dts[..., None]     # (b, T, p)
                Xp = Xd * torch.exp((a_total[:, None] - acum).float())[
                    ..., None]
                causal = torch.tril(torch.ones(tl, tl, dtype=torch.bool))
                W = torch.where(causal, scores[q] * torch.exp(
                    (acum[:, :, None] - acum[:, None, :]).float()), 0.0)
                yd = torch.zeros(b, tl, p)
                for t in range(tl):
                    yd = yd + W[:, :, t, None] * Xd[:, None, t, :]
                if q > 0:
                    eC = torch.exp(acum.float())[..., None] * Cp
                    for k in range(n):
                        yd = yd + eC[:, :, None, k] * hs[:, None, :, k]
                y[:, t0:t0 + tl, hi] = yd
                hs = hs * torch.exp(a_total.float())[:, None, None]
                for t in range(tl):
                    hs = hs + Xp[:, t, :, None] * Bp[:, t, None, :]
            state[:, hi] = hs
    return y.to(x.dtype), state


# the reference's cases and the main paths' chunks, plus chunk 1, one head,
# heads the group of 4 does not divide (1, 3, 5), a chunk walked in two
# pieces (128 -> 64 + 64, 100 -> 50 + 50) and p, n not multiples of 4
SSD_EMULATED = SSD_ALL + [
    (2, 5, 3, 16, 8, 1, "float32"),
    (1, 200, 5, 8, 4, 100, "float32"),
    (2, 14, 5, 6, 10, 7, "float32"),
]


@pytest.mark.parametrize("case", SSD_EMULATED)
def test_ssd_kernel_emulation_within_budget_of_pallas_and_witness(case):
    """The emulated kernel against Pallas (interpret mode) and ``ref.ssd``
    in float64, each element within 2e-5 x max(1, |witness|) (3e-2 for bf16
    y): the bound ``chip_smoke.py`` holds the kernel to on the card."""
    b, l, h, p, n, chunk, dtype = case
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        *_ssd_inputs(0, b, l, h, p, n), dtype=dtype)
    ye, se = _emulate_ssd_kernel(tx, tdt, tA, tB, tC, chunk)
    assert ye.dtype == tx.dtype and tuple(se.shape) == (b, h, p, n)
    yw, sw = tref.ssd(*(t.double() for t in (tx, tdt, tA, tB, tC)),
                      chunk=chunk)
    yp, sp = ssd_pallas(jx, jdt, jA, jB, jC, chunk=chunk, interpret=True)
    y_tol = F32_TOL if dtype == "float32" else BF16_TOL
    for (yg, sg), (yr, sr) in (((ye, se), (yw, sw)),
                               ((ye, se), (yp, sp))):
        yr, sr = _np(yr).astype(np.float64), _np(sr).astype(np.float64)
        for got, want, tol in ((_np(yg), yr, y_tol), (_np(sg), sr, F32_TOL)):
            err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
            assert err.max() <= tol, (case, err.max())


# ---------------------------------------------------------------------------
# the decode step, in place
# ---------------------------------------------------------------------------
def _step_inputs(seed, b, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, p)).astype(np.float32) * 0.5
    dt = (np.log1p(np.exp(rng.standard_normal((b, h)))) * 0.1).astype(
        np.float32)
    B = rng.standard_normal((b, n)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, n)).astype(np.float32) * 0.5
    return x, dt, B, C


def test_ssd_decode_step_in_place_on_a_layer_view_matches_jax():
    """12 chained steps through ``ops.ssd_decode_step`` on layer 1 of a
    stacked (3, b, h, p, n) cache, from a scan's final state: y and the
    state within 2e-5 of JAX's ``ref.ssd_decode_step``, the returned state
    the argument itself, layers 0 and 2 untouched."""
    b, h, p, n = 2, 3, 16, 8
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        *_ssd_inputs(8, b, 16, h, p, n))
    _, s0 = ops.ssd(tx, tdt, tA, tB, tC, chunk=8)
    _, js = jref.ssd(jx, jdt, jA, jB, jC, chunk=8)
    stacked = torch.randn(3, b, h, p, n, generator=torch.Generator()
                          .manual_seed(0))
    stacked[1] = s0
    keep = stacked.clone()
    layer = stacked[1]
    for t in range(12):
        x, dt, B, C = _step_inputs(100 + t, b, h, p, n)
        y, st = ops.ssd_decode_step(layer, torch.tensor(x), torch.tensor(dt),
                                    tA, torch.tensor(B), torch.tensor(C))
        jy, js = jref.ssd_decode_step(js, jnp.asarray(x), jnp.asarray(dt),
                                      jA, jnp.asarray(B), jnp.asarray(C))
        assert st is layer
        np.testing.assert_allclose(y.numpy(), _np(jy), atol=F32_TOL,
                                   rtol=0)
        np.testing.assert_allclose(layer.numpy(), _np(js), atol=F32_TOL,
                                   rtol=0)
    assert torch.equal(stacked[0], keep[0]) and torch.equal(stacked[2],
                                                            keep[2])
    assert not torch.equal(stacked[1], keep[1])


def test_ssd_decode_step_cpu_dispatch_runs_plain_and_counts_no_launch():
    b, h, p, n = 1, 2, 8, 4
    x, dt, B, C = (torch.tensor(a) for a in _step_inputs(3, b, h, p, n))
    A = -torch.ones(h)
    state = torch.randn(b, h, p, n, generator=torch.Generator()
                        .manual_seed(1))
    yp, sp = tref.ssd_decode_step(state, x, dt, A, B, C)
    before = launch_counts()
    y, st = ops.ssd_decode_step(state, x, dt, A, B, C)
    assert ops.ssd_decode_step is SD.ssd_decode_step
    assert st is state and torch.equal(y, yp) and torch.equal(state, sp)
    assert launch_counts() == before
    assert "ssd_decode_step" in before


def test_ssd_decode_step_off_cpu_launches_or_raises():
    """A non-CPU state never reaches the plain version: without a card a
    meta tensor raises before any launch."""
    args = [torch.empty(s, device="meta") for s in
            ((1, 2, 4, 8), (1, 2, 4), (1, 2), (2,), (1, 8), (1, 8))]
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_decode_step(*args)
    with pytest.raises(ValueError, match="CUDA"):
        SD.ssd_decode_step_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        SD.ssd_decode_step_cuda(torch.zeros(1, 2, 4, 8), *args[1:])


def _step_args(b=1, h=2, p=4, n=8, sdt=torch.float32, adt=torch.float32):
    return (torch.zeros(b, h, p, n, dtype=sdt), torch.zeros(b, h, p),
            torch.zeros(b, h), torch.zeros(h, dtype=adt), torch.zeros(b, n),
            torch.zeros(b, n))


@pytest.mark.parametrize("args,match", [
    (_step_args(n=6), "multiple of 4"),
    (_step_args(sdt=torch.bfloat16), "float32"),
    (_step_args(adt=torch.float16), "float32 or bfloat16"),
    (_step_args()[:4] + (torch.zeros(1, 4), torch.zeros(1, 8)),
     "shape mismatch"),
    ((torch.zeros(1, 2, 4, 16)[..., ::2],) + _step_args()[1:], "strides"),
    ((torch.zeros(1, 2, 4, 10)[..., 2:],) + _step_args()[1:], "strides"),
    ((torch.zeros(2, 66)[:, :64].view(2, 2, 4, 8),) + _step_args(b=2)[1:],
     "strides"),
    ((torch.zeros(65)[1:].view(1, 2, 4, 8),) + _step_args()[1:],
     "16-byte aligned"),
    (_step_args()[:1] + (torch.zeros(1, 2, 4, dtype=torch.bfloat16),)
     + _step_args()[2:], "x is torch.bfloat16"),
    (_step_args(b=0), "empty"),
])
def test_ssd_decode_step_check_args_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        SD.check_args(*args)


def test_ssd_decode_step_check_args_takes_a_layer_view():
    """mamba_decode's inputs: the state a layer view of the stacked (L, b,
    h, p, n) cache, and x, B, C slices of the conv output, whose batch dim
    is the fastest (the einsum's layout, kept by ``.float()``)."""
    cache = torch.zeros(3, 2, 4, 16, 8)
    conv = torch.zeros(4 * 16 + 2 * 8, 2).t()          # (b, conv_dim)
    x, B, C = conv[:, :64].reshape(2, 4, 16), conv[:, 64:72], conv[:, 72:80]
    assert x.stride() == (1, 32, 2) and B.stride() == (1, 2)
    SD.check_args(cache[1], x, torch.zeros(2, 4),
                  torch.zeros(4, dtype=torch.bfloat16), B, C)


# ---------------------------------------------------------------------------
# configs, the mamba block and the model
# ---------------------------------------------------------------------------
def _port_cfg(jcfg) -> ModelConfig:
    """The port's config with the JAX config's values for every port field."""
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


@pytest.fixture(scope="module")
def ssm_pair():
    """The pure-SSM small config (``mamba2-1.3b.reduced()`` is the zamba2
    hybrid's layout, which ``test_torch_hybrid.py`` covers, so shared
    attention is switched off) and bridged random weights."""
    jcfg = dataclasses.replace(jget_config("mamba2-1.3b").reduced(),
                               shared_attn_every=0)
    tcfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                               shared_attn_every=0)
    assert tcfg == _port_cfg(jcfg)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = io.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, tcfg, params, tp


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("name", ["mamba2-1.3b", "scope-qwen3-4b",
                                  "zamba2-7b"])
def test_configs_and_reduced_variants_match_jax(name):
    for cfg, jcfg in ((get_config(name), jget_config(name)),
                      (get_config(name).reduced(),
                       jget_config(name).reduced())):
        for f in dataclasses.fields(ModelConfig):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


def test_mamba2_config_and_registry():
    cfg = get_config("mamba2-1.3b")
    assert (cfg.d_inner, cfg.resolved_ssm_heads) == (4096, 64)
    assert cfg.is_attention_free() and cfg.has_ssm()
    assert TT.build_plan(cfg) == [(("mamba",), 48)]
    for name in ("scope-qwen3-4b", "scope-tiny"):
        assert get_config(name).name == name
    assert get_config("zamba2-7b") is zamba2_7b.CONFIG
    assert get_config("qwen3-moe-235b-a22b").name == "qwen3-moe-235b-a22b"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("qwen3-moe-235b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_cache_match_jax_structure_and_dtypes(ssm_pair,
                                                              dtype):
    """Every per-layer leaf (A_log, D, dt_bias, conv_b included) in the
    model dtype, as JAX's post-stacking cast leaves them."""
    jcfg = dataclasses.replace(ssm_pair[0], dtype=dtype)
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


def test_bridge_is_leaf_for_leaf(ssm_pair):
    _, _, params, tp = ssm_pair
    jf, tf_ = _flat(params), _flat(tp)
    assert set(jf) == set(tf_) and any("A_log" in k for k in jf)
    for path, leaf in jf.items():
        np.testing.assert_array_equal(_np(tf_[path]), _np(leaf),
                                      err_msg=path)


def test_mamba_block_full_and_decode_match_jax(ssm_pair):
    """``mamba_full`` (chunk 7) and three ``mamba_decode`` steps of layer 0;
    the decode writes the new window and state into the cache tensors."""
    jcfg, tcfg, params, tp = ssm_pair
    jp = jax.tree.map(lambda a: a[0], params["segments"][0]["0"]["mamba"])
    tpl = layer_view(tp["segments"][0]["0"]["mamba"], 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, PROMPT_LEN, tcfg.d_model)).astype(np.float32)
    jy, jc = JSSM.mamba_full(jp, jcfg, jnp.asarray(x))
    ty, tc = TSSM.mamba_full(tpl, tcfg, torch.tensor(x))
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=F32_TOL, rtol=F32_TOL)
    for name in ("conv", "ssm"):
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        np.testing.assert_allclose(tc[name].numpy(), _np(jc[name]),
                                   atol=F32_TOL, rtol=F32_TOL)
    cache = {k: v.clone() for k, v in tc.items()}
    ids = {k: id(v) for k, v in cache.items()}
    for t in range(3):
        xt = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        jy, jc = JSSM.mamba_decode(jp, jcfg, jnp.asarray(xt), jc)
        ty = TSSM.mamba_decode(tpl, tcfg, torch.tensor(xt), cache)
        np.testing.assert_allclose(ty.numpy(), _np(jy), atol=F32_TOL,
                                   rtol=F32_TOL)
    assert {k: id(v) for k, v in cache.items()} == ids
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(cache[name].numpy(), _np(jc[name]),
                                   atol=F32_TOL, rtol=F32_TOL)


def test_prefill_and_decode_logits_match_jax(ssm_pair):
    jcfg, tcfg, params, tp = ssm_pair
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (3, PROMPT_LEN)).astype(np.int32)
    steps = rng.integers(0, 512, (3, 3)).astype(np.int32)
    jl, jc = JM.prefill(params, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=F32_TOL, rtol=F32_TOL)
    jc = JS._pad_caches(jc, PROMPT_LEN + 3, PROMPT_LEN)
    tc = TS._pad_caches(tc, PROMPT_LEN + 3, PROMPT_LEN)
    pos = np.full((3,), PROMPT_LEN, np.int32)
    for t in range(3):
        jl, jc = JM.decode_step(params, jcfg, jnp.asarray(steps[:, t:t + 1]),
                                jc, jnp.asarray(pos + t))
        tl, tc2 = TM.decode_step(tp, tcfg, torch.tensor(steps[:, t:t + 1]),
                                 tc, torch.tensor(pos + t))
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=F32_TOL,
                                   rtol=F32_TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tc[0]["0"][name].numpy(),
                                   _np(jc[0]["0"][name]), atol=F32_TOL,
                                   rtol=F32_TOL)


def test_pad_caches_passes_state_leaves_through(ssm_pair):
    """conv/ssm have no seq axis: never grown, even where a dim equals the
    prompt length (conv width - 1 == 3 here)."""
    _, tcfg, _, tp = ssm_pair
    _, caches = TM.prefill(tp, tcfg, {"tokens": torch.zeros((2, 3),
                                                            dtype=torch.long)})
    grown = TS._pad_caches(caches, 10, 3)
    for name in ("conv", "ssm"):
        assert grown[0]["0"][name] is caches[0]["0"][name]


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------
def _prompts(seed, b, width=PROMPT_LEN):
    return np.random.default_rng(seed).integers(4, 512, (b, width)).astype(
        np.int32)


def test_generate_token_streams_equal(ssm_pair):
    jcfg, tcfg, params, tp = ssm_pair
    prompts = _prompts(4, 4)
    jg, jd = JS.generate(params, jcfg, prompts, max_new_tokens=8)
    tg, td = TS.generate(tp, tcfg, prompts, max_new_tokens=8)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_allclose(td, jd, atol=F32_TOL, rtol=F32_TOL)


def test_ragged_padded_and_paged_guards_raise_as_in_jax(ssm_pair):
    jcfg, tcfg, params, tp = ssm_pair
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


@pytest.mark.parametrize("fused", [False, True])
def test_refill_replaces_conv_and_ssm_rows_like_jax(ssm_pair, fused):
    """Decode, refill slot 1 with a fresh exact-fit prompt, decode again:
    tokens, decision logits and the conv/SSM caches as in JAX's
    ``refill_slots`` / fused ``decode_segment(refill=...)``."""
    jcfg, tcfg, params, tp = ssm_pair
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
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(ts.caches[0]["0"][name].numpy(),
                                   _np(js.caches[0]["0"][name]),
                                   atol=F32_TOL, rtol=F32_TOL)
    # the refilled row decodes as a fresh run of its own prompt
    alone_g, _ = TS.generate(tp, tcfg, fresh[1:2], max_new_tokens=4)
    np.testing.assert_array_equal(tg2.numpy()[1], alone_g[0])


# ---------------------------------------------------------------------------
# the slice as a whole: ScopeEngine.serve on an SSM estimator
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ssm_engines(ssm_pair, scope_data, library, retriever):
    jcfg, tcfg, params, tp = ssm_pair
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


@pytest.mark.parametrize("policy", ["alpha0.7", "budget"])
def test_engine_serve_decisions_equal(ssm_engines, policy):
    jeng, teng, jdata, tdata, qids = ssm_engines
    jreq = japi.RouteRequest([jdata.queries[q] for q in qids])
    treq = tapi.RouteRequest([tdata.queries[q] for q in qids])
    jp = jeng.predict(jreq, use_cache=False)
    tp = teng.predict(treq, use_cache=False)
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
