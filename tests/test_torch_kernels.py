"""The port's plain kernel versions against the JAX oracles and the Pallas
kernels (interpret mode), on the same numpy-seeded inputs.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each one against these plain versions there.  Here the plain versions are
held to JAX, and the wrappers' argument checks and device dispatch are
exercised on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import KernelType
from repro.kernels.decode_attention import decode_attention as da_pallas
from repro.kernels.flash_attention import flash_attention as fa_pallas
from repro.kernels.topk_retrieval import topk_retrieval as topk_pallas
from repro_torch.kernels import build, launch_counts, ops
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_retrieval as TK

F32_TOL = 2e-5
BF16_TOL = 3e-2
TOPK_TOL = 1e-5


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(seed, b, hq, hkv, sq, sk, d, dv=None):
    return (_normal(seed, b, hq, sq, d), _normal(seed + 1, b, hkv, sk, d),
            _normal(seed + 2, b, hkv, sk, dv or d))


def _both(*arrays, dtype=torch.float32):
    """numpy arrays -> (jax arrays, torch CPU tensors) of the same values."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.tensor(a).to(dtype) for a in arrays])


# b, hq, hkv, sq, sk, d, causal, window, softcap  (tests/test_kernels.py)
ATTN_CASES = [
    (1, 2, 2, 128, 128, 32, True, 0, 0.0),
    (2, 4, 2, 256, 256, 64, True, 0, 0.0),
    (2, 4, 1, 192, 192, 64, True, 64, 0.0),
    (1, 8, 4, 128, 128, 32, True, 0, 50.0),
    (2, 2, 2, 96, 160, 32, False, 0, 0.0),
    (1, 4, 4, 256, 256, 64, True, 100, 30.0),
]


# zamba2-7b's shared attention: head dim 112, one q-head a kv-head (g = 1),
# its 49-token prompts, then a windowed, softcapped ragged case
D112_CASES = [
    (2, 4, 4, 49, 49, 112, True, 0, 0.0),
    (1, 4, 4, 70, 70, 112, True, 16, 30.0),
]


@pytest.mark.parametrize("case", ATTN_CASES + D112_CASES)
def test_flash_plain_matches_jax_ref(case):
    b, hq, hkv, sq, sk, d, causal, window, cap = case
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(0, b, hq, hkv, sq, sk, d))
    want = jref.attention(jq, jk, jv, causal=causal, window=window,
                          softcap=cap)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("case", [ATTN_CASES[0], ATTN_CASES[3],
                                  ATTN_CASES[4]] + D112_CASES)
def test_flash_plain_matches_pallas_interpret(case):
    b, hq, hkv, sq, sk, d, causal, window, cap = case
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(1, b, hq, hkv, sq, sk, d))
    want = fa_pallas(jq, jk, jv, causal=causal, window=window, softcap=cap,
                     block_q=64, block_k=64, interpret=True)
    got = FA.flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                   softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plain_dtypes(dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(2, 2, 4, 2, 64, 64, 64),
                                       dtype=dtype)
    want = jref.attention(jq, jk, jv, causal=True)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == dtype
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_flash_plain_separate_v_dim_and_offset():
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(3, 2, 4, 2, 24, 40, 48, dv=32))
    want = jref.attention(jq, jk, jv, causal=True, q_offset=16)
    got = ops.flash_attention(tq, tk, tv, causal=True, q_offset=16)
    assert tuple(got.shape) == (2, 4, 24, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


@pytest.mark.parametrize("hkv", [1, 2])
def test_flash_gqa_head_mapping(hkv):
    """q-head h reads kv-head h // group (repeat_interleave, not repeat)."""
    hq = 4
    q, k, v = _qkv(4, 1, hq, hkv, 20, 20, 32)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    group = hq // hkv
    for h in range(hq):
        one = tref.attention(tq[:, h:h + 1], tk[:, h // group:h // group + 1],
                             tv[:, h // group:h // group + 1], causal=True)
        np.testing.assert_allclose(got[:, h:h + 1].numpy(), one.numpy(),
                                   atol=F32_TOL)
    want = jref.attention(jq, jk, jv, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


def test_flash_fully_masked_row_gives_zero_like_pallas():
    """Rows with no valid key (causal, q_offset < 0): the plain version and
    the Pallas kernel give 0, never NaN.  The JAX oracle averages v there
    (-1e30 logits, uniform softmax); the port's ``ref.attention`` mirrors
    that, and the two agree on every row that has a valid key."""
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(5, 1, 4, 2, 16, 16, 32))
    got = FA.flash_attention_plain(tq, tk, tv, causal=True, q_offset=-5)
    pallas = fa_pallas(jq, jk, jv, causal=True, q_offset=-5, block_q=16,
                       block_k=16, interpret=True)
    assert torch.isfinite(got).all()
    assert (got[:, :, :5] == 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=F32_TOL)
    oracle = jref.attention(jq, jk, jv, causal=True, q_offset=-5)
    np.testing.assert_allclose(
        tref.attention(tq, tk, tv, causal=True, q_offset=-5).numpy(),
        np.asarray(oracle), atol=F32_TOL)
    np.testing.assert_allclose(got[:, :, 5:].numpy(),
                               np.asarray(oracle)[:, :, 5:], atol=F32_TOL)


# ---------------------------------------------------------------------------
# The bf16 tensor-core flash kernel's rounding budget, on the CPU
# ---------------------------------------------------------------------------
LOG2E = 1.4426950408889634


def _emulate_bf16_flash(q, k, v, *, causal=True, window=0, softcap=0.0,
                        q_offset=0, block_k=32, return_lse=False):
    """The numerics of ``flash_mma_kernel`` (``csrc/flash_attention.cu``),
    test-only: bf16 q, k, v; S = q.k^T summed in f32 and scaled after the
    product, inside the exponent (2^(s c - m c), c = scale log2 e, or
    log2 e after a softcap); an online softmax in f32 over 32-key tiles
    with the TPU kernel's guards; P rounded to bf16 before P.V, which sums
    in f32; l sums the unrounded P.  With ``return_lse`` also the saved
    log-sum-exp, scale m + ln l (m + ln l after a softcap), +inf where l is
    0."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    x = q.float() @ kf.transpose(-1, -2)                 # (b, hq, sq, sk)
    c = LOG2E
    if softcap > 0.0:
        x = softcap * torch.tanh(x * (scale / softcap))
    else:
        c = scale * LOG2E
    mask = tref.attention_mask(sq, sk, causal=causal, window=window,
                               q_offset=q_offset, device=q.device)
    neg = tref.NEG_INF
    m = torch.full((b, hq, sq, 1), neg)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, v.shape[-1]))
    for t0 in range(0, sk, block_k):
        xt = torch.where(mask[:, t0:t0 + block_k],
                         x[..., t0:t0 + block_k], neg)
        m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
        m_safe = torch.where(m_new <= neg, 0.0, m_new)
        p = torch.exp2(xt * c - m_safe * c)               # masked -> 0
        alpha = torch.where(m <= neg, 0.0, torch.exp2(m * c - m_safe * c))
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, t0:t0 + block_k]
        m = m_new
    out = (acc / torch.where(l == 0.0, 1.0, l)).bfloat16()
    if not return_lse:
        return out
    lse = (m if softcap > 0.0 else m * scale) + torch.log(l)
    return out, torch.where(l == 0.0, float("inf"), lse)[..., 0]


@pytest.mark.parametrize("kw", [{}, dict(window=16, softcap=30.0),
                                dict(q_offset=-5)],
                         ids=["causal", "window+softcap", "q_offset=-5"])
def test_bf16_tensor_core_numerics_within_budget_of_pallas(kw):
    """The one new rounding of the bf16 kernel (P to bf16 before P.V) and
    its other reorderings stay within the bf16 tolerance of the Pallas
    kernel (interpret mode) at the main path's head geometry (d 128, group
    4, 49 tokens) and of the port's plain version."""
    _check_bf16_flash(_qkv(21, 2, 8, 2, 49, 49, 128), kw)


@pytest.mark.parametrize("kw", [{}, dict(window=16, softcap=30.0),
                                dict(q_offset=-5)],
                         ids=["causal", "window+softcap", "q_offset=-5"])
def test_bf16_tensor_core_numerics_within_budget_of_pallas_at_d112(kw):
    """The same at zamba2-7b's head geometry (d 112, group 1, 49 tokens)."""
    _check_bf16_flash(_qkv(22, 2, 4, 4, 49, 49, 112), kw)


def _check_bf16_flash(qkv, kw):
    (jq, jk, jv), (tq, tk, tv) = _both(*qkv, dtype=torch.bfloat16)
    got = _emulate_bf16_flash(tq, tk, tv, **kw)
    pallas = fa_pallas(jq, jk, jv, interpret=True, **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32),
                               atol=BF16_TOL, rtol=0)
    plain = FA.flash_attention_plain(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               atol=BF16_TOL, rtol=0)
    if kw.get("q_offset", 0) < 0:
        assert (got[:, :, :5] == 0).all()


# b, hq, hkv, S, d, cache_len, window, softcap  (tests/test_kernels.py)
DECODE_CASES = [
    (2, 4, 2, 128, 32, 100, 0, 0.0),
    (1, 8, 4, 256, 64, 256, 0, 50.0),
    (2, 2, 1, 96, 32, 40, 16, 0.0),
    (1, 4, 4, 300, 32, 123, 0, 0.0),
    (3, 8, 2, 61, 32, (49, 61, 55), 0, 0.0),
    (3, 4, 2, 64, 32, (10, 64, 33), 8, 30.0),
]


# zamba2-7b's decode: d 112, g 1, its 61-key cache with ragged lengths,
# then a window and softcap
D112_DECODE_CASES = [
    (2, 4, 4, 61, 112, (61, 49), 0, 0.0),
    (2, 2, 2, 40, 112, (33, 40), 8, 30.0),
]


@pytest.mark.parametrize("case", DECODE_CASES + D112_DECODE_CASES)
def test_decode_plain_matches_jax(case):
    b, hq, hkv, S, d, clen, window, cap = case
    q, kc, vc = _qkv(6, b, hq, hkv, 1, S, d)
    (jq, jk, jv), (tq, tk, tv) = _both(q, kc, vc)
    jlen = jnp.asarray(clen, jnp.int32)
    tlen = torch.tensor(clen, dtype=torch.int32)
    want = jops.decode_attention(jq, jk, jv, jlen, window=window, softcap=cap)
    pallas = da_pallas(jq, jk, jv, jlen, window=window, softcap=cap,
                       block_k=32, interpret=True)
    got = ops.decode_attention(tq, tk, tv, tlen, window=window, softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=F32_TOL,
                               rtol=F32_TOL)


def test_decode_plain_empty_row_gives_zero_like_pallas():
    q, kc, vc = _qkv(7, 2, 4, 2, 1, 32, 32)
    (jq, jk, jv), (tq, tk, tv) = _both(q, kc, vc)
    lens = (0, 17)
    got = ops.decode_attention(tq, tk, tv, torch.tensor(lens,
                                                        dtype=torch.int32))
    pallas = da_pallas(jq, jk, jv, jnp.asarray(lens, jnp.int32), block_k=16,
                       interpret=True)
    assert (got[0] == 0).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=F32_TOL)


def test_decode_plain_is_causal_attention_at_its_length():
    """Decode at cache_len == full causal attention's last row."""
    q, kc, vc = _qkv(8, 2, 4, 2, 1, 64, 32)
    _, (tq, tk, tv) = _both(q, kc, vc)
    got = ops.decode_attention(tq, tk, tv, 40)
    want = tref.attention(tq, tk[:, :, :40], tv[:, :, :40], causal=True,
                          q_offset=39)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL)


# ---------------------------------------------------------------------------
# The decode kernels' arithmetic (csrc/decode_common.cuh), on the CPU
# ---------------------------------------------------------------------------
DEC_CHUNK, DEC_WARPS = 16, 4


def _emulate_decode_block(q, fetch, lo, hi, *, softcap=0.0, scale=None):
    """The numerics of ``decode_block`` (``csrc/decode_common.cuh``),
    test-only: f32 math on the storage-type q, K, V; keys in chunks of 16
    by logical position, chunk c to warp c % 4; an online softmax per warp
    over its own chunks in order, with the TPU kernel's guards; the warps'
    (m, l, acc) merged in warp order, a warp without a valid key skipped;
    l == 0 -> 1.  q: (b, hkv, g, d); lo, hi: (b,) key intervals; fetch(kpos,
    valid) -> the chunk's K (b, hkv, 16, d) and V (b, hkv, 16, dv), read
    through the cache's own addressing, 0 where not valid.  Every operation
    runs on (b, hkv, g, 16)-shaped tiles, so the result depends only on the
    logical keys, not on how the cache is laid out."""
    b, hkv, g, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    neg = tref.NEG_INF
    qf = q.float() * scale
    warps = []
    for w in range(DEC_WARPS):
        m = torch.full((b, hkv, g), neg)
        l = torch.zeros((b, hkv, g))
        acc = None
        for c in range(w, -(-int(hi.max()) // DEC_CHUNK), DEC_WARPS):
            kpos = c * DEC_CHUNK + torch.arange(DEC_CHUNK)
            valid = (kpos[None] >= lo[:, None]) & (kpos[None] < hi[:, None])
            k, v = fetch(kpos, valid)
            s = torch.einsum("bhgd,bhjd->bhgj", qf, k.float())
            if softcap > 0.0:
                s = softcap * torch.tanh(s / softcap)
            vmask = valid[:, None, None]
            s = torch.where(vmask, s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(m_new <= neg, 0.0, m_new)
            p = torch.where(vmask, torch.exp(s - m_safe[..., None]), 0.0)
            alpha = torch.where(m <= neg, 0.0, torch.exp(m - m_safe))
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bhgj,bhjd->bhgd", p, v.float())
            acc = pv if acc is None else acc * alpha[..., None] + pv
            m = m_new
        warps.append((m, l, acc))
    mx = torch.stack([m for m, _, _ in warps]).amax(0)
    m_safe = torch.where(mx <= neg, 0.0, mx)
    lsum, a = torch.zeros_like(mx), None
    for m, l, acc in warps:
        if acc is None:                       # the warp owns no chunk
            continue
        f = torch.where(m <= neg, 0.0, torch.exp(m - m_safe))
        lsum = lsum + l * f
        a = acc * f[..., None] if a is None else a + acc * f[..., None]
    out = a / torch.where(lsum == 0.0, 1.0, lsum)[..., None]
    return out.reshape(b, hkv * g, 1, -1).to(q.dtype)


def _dense_fetch(k_cache, v_cache):
    S = k_cache.shape[2]

    def fetch(kpos, valid):
        idx = kpos.clamp(max=S - 1)
        keep = valid[:, None, :, None]
        return (torch.where(keep, k_cache[:, :, idx], 0.0).contiguous(),
                torch.where(keep, v_cache[:, :, idx], 0.0).contiguous())
    return fetch


def _paged_fetch(k_pages, v_pages, table, page):
    rows = torch.arange(table.shape[0])[:, None]

    def fetch(kpos, valid):
        lp = (kpos // page).clamp(max=table.shape[1] - 1)
        phys = table.long()[rows, lp[None]]               # (b, 16)
        slot = (kpos % page)[None].expand_as(phys)
        keep = valid[:, None, :, None]
        k = k_pages[phys, :, slot].permute(0, 2, 1, 3)     # (b, hkv, 16, d)
        v = v_pages[phys, :, slot].permute(0, 2, 1, 3)
        return (torch.where(keep, k, 0.0).contiguous(),
                torch.where(keep, v, 0.0).contiguous())
    return fetch


def _emulate_dense(q, k_cache, v_cache, lens, *, window=0, softcap=0.0):
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    lens = torch.as_tensor(lens, dtype=torch.int64).reshape(-1).expand(b)
    hi = lens.clamp(max=k_cache.shape[2])
    lo = (lens - window).clamp(min=0) if window > 0 else torch.zeros_like(hi)
    return _emulate_decode_block(q.reshape(b, hkv, hq // hkv, d),
                                 _dense_fetch(k_cache, v_cache), lo, hi,
                                 softcap=softcap)


def _emulate_paged(q, k_pages, v_pages, lens, table, *, page_size, kv_cap,
                   softcap=0.0):
    b, hq, _, d = q.shape
    hkv = k_pages.shape[1]
    hi = torch.as_tensor(lens, dtype=torch.int64).clamp(max=kv_cap)
    return _emulate_decode_block(
        q.reshape(b, hkv, hq // hkv, d),
        _paged_fetch(k_pages, v_pages, table, page_size), torch.zeros_like(hi),
        hi, softcap=softcap)


def _paged_copy(kc, vc, page, n_spare=5, seed=0):
    """The dense caches' keys in block-paged storage behind a permuted page
    table, random values in the trash page and every unreferenced page."""
    b, hkv, S, _ = kc.shape
    n_w = -(-S // page)
    n_pages = b * n_w + n_spare
    g = torch.Generator().manual_seed(seed)
    kp = torch.randn((n_pages + 1, hkv, page, kc.shape[3]), generator=g)
    vp = torch.randn((n_pages + 1, hkv, page, vc.shape[3]), generator=g)
    kp, vp = kp.to(kc.dtype), vp.to(vc.dtype)
    table = torch.randperm(n_pages, generator=g)[: b * n_w].reshape(b, n_w)
    for i in range(b):
        for w in range(n_w):
            n = min(page, S - w * page)
            kp[table[i, w], :, :n] = kc[i, :, w * page: w * page + n]
            vp[table[i, w], :, :n] = vc[i, :, w * page: w * page + n]
    return kp, vp, table.to(torch.int32)


# DECODE_CASES, then the main path's head geometry (g 4, d 128, 61 keys)
# and an empty row
EMULATED_DECODE_CASES = DECODE_CASES + [
    (2, 8, 2, 61, 128, (61, 49), 0, 0.0),
    (2, 4, 2, 32, 32, (0, 17), 0, 0.0),
] + D112_DECODE_CASES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", EMULATED_DECODE_CASES)
def test_decode_kernel_numerics_within_budget_of_pallas(case, dtype):
    """The redesigned decode body's arithmetic (chunks by logical position
    over 4 warps, per-warp online softmax, one combine in warp order) stays
    within 2e-5 (f32) / 3e-2 (bf16 storage, f32 math) of the Pallas kernel
    (interpret mode) and of the port's plain version."""
    b, hq, hkv, S, d, clen, window, cap = case
    q, kc, vc = _qkv(6, b, hq, hkv, 1, S, d)
    (jq, jk, jv), (tq, tk, tv) = _both(q, kc, vc, dtype=dtype)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    tlen = torch.tensor(clen, dtype=torch.int32)
    got = _emulate_dense(tq, tk, tv, tlen, window=window, softcap=cap)
    pallas = da_pallas(jq, jk, jv, jnp.asarray(clen, jnp.int32),
                       window=window, softcap=cap, block_k=32, interpret=True)
    plain = DA.decode_attention_plain(tq, tk, tv, tlen, window=window,
                                      softcap=cap)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               atol=tol, rtol=tol)
    if 0 in np.atleast_1d(clen):
        assert (got[list(np.atleast_1d(clen)).index(0)] == 0).all()


# test_torch_paged.PAGED_CASES (b, hq, hkv, S, d, page, lens, softcap), then
# the stream's head geometry (g 4, d 128, 16-token pages, 61 keys)
EMULATED_PAGED_CASES = [
    (2, 4, 2, 128, 32, 16, (100, 128), 0.0),
    (1, 8, 4, 64, 64, 8, (40,), 50.0),
    (3, 4, 2, 96, 32, 32, (10, 77, 96), 0.0),
    (2, 8, 2, 61, 128, 16, (61, 50), 0.0),
    (2, 4, 4, 61, 112, 16, (61, 50), 0.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", EMULATED_PAGED_CASES)
def test_paged_kernel_numerics_within_budget_of_pallas(case, dtype):
    """The same body over block-paged storage (a clipped last page where S
    is not a multiple of the page) against the Pallas paged kernel
    (interpret mode) and the plain paged version; bit for bit the dense
    emulation on the same logical cache."""
    b, hq, hkv, S, d, page, lens, cap = case
    q, kc, vc = _qkv(16, b, hq, hkv, 1, S, d)
    tq, tk, tv = (torch.tensor(a).to(dtype) for a in (q, kc, vc))
    kp, vp, table = _paged_copy(tk, tv, page, seed=S)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    tlen = torch.tensor(lens, dtype=torch.int32)
    kw = dict(page_size=page, kv_cap=S, softcap=cap)
    got = _emulate_paged(tq, kp, vp, tlen, table, **kw)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pallas = jops.paged_decode_attention(
        *(jnp.asarray(t.float().numpy(), jdt) for t in (tq, kp, vp)),
        jnp.asarray(lens, jnp.int32), jnp.asarray(table.numpy()),
        kernel=KernelType.PALLAS, **kw)
    plain = DA.paged_decode_attention_plain(tq, kp, vp, tlen, table, **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               atol=tol, rtol=tol)
    assert torch.equal(got, _emulate_dense(tq, tk, tv, tlen, softcap=cap))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_emulation_row_bits_independent_of_layout(dtype):
    """Requirement of the kernels' design, at the level of the algorithm: a
    row's output depends only on its logical keys and length.  One row of 61
    keys gives the same bits from dense caches of depth 61 and 98 and from
    paged caches with pages of 8 and 16 and kv_caps of 61 and 80."""
    q, kc, vc = _qkv(31, 1, 8, 2, 1, 98, 128)
    tq, tk, tv = (torch.tensor(a).to(dtype) for a in (q, kc, vc))
    lens = torch.tensor([61], dtype=torch.int32)
    outs = {f"dense S={S}": _emulate_dense(tq, tk[:, :, :S].contiguous(),
                                           tv[:, :, :S].contiguous(), lens)
            for S in (61, 98)}
    for page, kv_cap in ((8, 61), (16, 61), (16, 80), (8, 80)):
        kp, vp, table = _paged_copy(tk[:, :, :kv_cap], tv[:, :, :kv_cap],
                                    page, seed=page + kv_cap)
        outs[f"paged page={page} kv_cap={kv_cap}"] = _emulate_paged(
            tq, kp, vp, lens, table, page_size=page, kv_cap=kv_cap)
    base = outs["dense S=61"]
    for name, out in outs.items():
        assert torch.equal(out, base), name
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    plain = DA.decode_attention_plain(tq, tk, tv, lens)
    np.testing.assert_allclose(base.float().numpy(), plain.float().numpy(),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# The flash backward kernel's arithmetic (csrc/flash_attention_bwd.cu), on
# the CPU
# ---------------------------------------------------------------------------
BWD_KEYS = 64    # keys of a dK/dV block
BWD_ROWS = 32    # position-major rows of a dK/dV step
DQ_ROWS = 64     # position-major rows of a dQ block
DQ_KEYS = 32     # keys of a dQ tile


def _group_rows(t, bi, kvh, group):
    """(b, hq, sq, w) -> the (sq * group, w) rows of kv-head kvh's group,
    position-major: row qi * group + head-in-group."""
    return t[bi, kvh * group:(kvh + 1) * group].transpose(0, 1).reshape(
        -1, t.shape[-1])


def _emulate_flash_bwd(q, k, v, o, g, lse, *, causal=True, window=0,
                       softcap=0.0, q_offset=0, scale=None, bf16=False):
    """The tensor-core backward kernel's tiles and orders, test-only, on
    the forward's log-sum-exp ``lse``: delta = rowsum(dO * O) as two
    partial sums of alternate 8-element chunks; per (batch, kv-head) the
    group's rows position-major; dK/dV per 64-key block over the rows that
    may see it, 32 at a time (S^T, dP^T, P = 2^(x c - lse log2 e), dS = P
    (dP - delta) (1 - t^2 after a softcap)); dQ per 64-row block, counted
    back from the last row, over 32-key tiles of the block's keys; dK and
    dQ times the scale at the end.  With ``bf16`` the mma operands P and dS
    are rounded to bf16 and so are the outputs, as on the card; without,
    the same arithmetic in f32."""
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5

    def rnd(t):
        return t.bfloat16().float() if bf16 else t

    q, k, v, o, g = (t.float() for t in (q, k, v, o, g))
    prod = (o * g).reshape(b, hq, sq, dv // 8, 8)
    delta = prod[..., 0::2, :].sum((-1, -2)) + prod[..., 1::2, :].sum((-1, -2))
    mask = tref.attention_mask(sq, sk, causal=causal, window=window,
                               q_offset=q_offset, device=q.device)
    c = LOG2E if softcap > 0.0 else scale * LOG2E

    def tile(qr, gr, kt, vt, lr, dr, m):
        """P and dS of rows x keys, 0 outside each row's keys."""
        x, f = qr @ kt.T, 1.0
        if softcap > 0.0:
            t = torch.tanh(x * (scale / softcap))
            x, f = softcap * t, 1.0 - t * t
        p = torch.where(m, torch.exp2(x * c - lr[:, None] * LOG2E), 0.0)
        ds = torch.where(m, p * (gr @ vt.T - dr[:, None]) * f, 0.0)
        return p, ds

    dq = torch.zeros(b, hq, sq, d)
    dk = torch.zeros(b, hkv, sk, d)
    dvv = torch.zeros(b, hkv, sk, dv)
    nrows = sq * group
    row_qi = torch.arange(nrows) // group
    for bi in range(b):
        for kvh in range(hkv):
            Q, G = _group_rows(q, bi, kvh, group), _group_rows(g, bi, kvh,
                                                                group)
            L = _group_rows(lse[..., None], bi, kvh, group)[:, 0]
            Dl = _group_rows(delta[..., None], bi, kvh, group)[:, 0]
            Mr = mask[row_qi]
            K, V = k[bi, kvh], v[bi, kvh]
            for k0 in range(0, sk, BWD_KEYS):
                k1 = min(k0 + BWD_KEYS, sk)
                qlo = max(k0 - q_offset, 0) if causal else 0
                qhi = (min(sq, k1 + window - 1 - q_offset) if window > 0
                       else sq)
                r_lo, r_hi = qlo * group, max(qhi, qlo) * group
                for r0 in range(r_lo, r_hi, BWD_ROWS):
                    rs = slice(r0, min(r0 + BWD_ROWS, r_hi))
                    p, ds = tile(Q[rs], G[rs], K[k0:k1], V[k0:k1], L[rs],
                                 Dl[rs], Mr[rs, k0:k1])
                    dvv[bi, kvh, k0:k1] += rnd(p).T @ G[rs]
                    dk[bi, kvh, k0:k1] += rnd(ds).T @ Q[rs]
            dq_rows = torch.zeros(nrows, d)
            for row_end in range(nrows, 0, -DQ_ROWS):
                rs = slice(max(row_end - DQ_ROWS, 0), row_end)
                seen = Mr[rs].any(0).nonzero()
                if not len(seen):
                    continue
                klo, khi = int(seen[0]), int(seen[-1]) + 1
                for t0 in range(klo // DQ_KEYS * DQ_KEYS, khi, DQ_KEYS):
                    t1 = min(t0 + DQ_KEYS, sk)
                    _, ds = tile(Q[rs], G[rs], K[t0:t1], V[t0:t1], L[rs],
                                 Dl[rs], Mr[rs, t0:t1])
                    dq_rows[rs] += rnd(ds) @ K[t0:t1]
            dq[bi, kvh * group:(kvh + 1) * group] = (
                dq_rows * scale).reshape(sq, group, d).transpose(0, 1)
    dk *= scale
    if bf16:
        return dq.bfloat16(), dk.bfloat16(), dvv.bfloat16()
    return dq, dk, dvv


# b, hq, hkv, sq, sk, d, dv, kwargs: GQA groups 1 / 2 / 4 / 8, ragged
# lengths (17, 33, 50, 150: a partial last 32-row step, 32-key tile and
# 64-key block; 150 keys take three 64-key blocks), window, positive and
# negative q_offset (rows with no key), dv != d, non-causal, softcap
BWD_EMU_CASES = [
    (1, 4, 2, 17, 17, 32, 32, {}),
    (1, 4, 1, 33, 33, 32, 16, dict(window=7)),
    (1, 2, 2, 20, 37, 32, 32, dict(q_offset=17)),
    (1, 2, 1, 20, 20, 16, 16, dict(q_offset=-5)),
    (1, 2, 1, 33, 50, 16, 16, dict(causal=False, window=9, q_offset=20)),
    (1, 4, 2, 150, 150, 32, 32, {}),
    (1, 8, 1, 40, 40, 32, 32, {}),
    (1, 4, 2, 70, 70, 32, 32, dict(window=24, softcap=20.0)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_EMU_CASES)
def test_flash_backward_kernel_arithmetic_matches_autograd(case, dtype):
    """The emulated kernel (its tiles, key and row ranges, summation
    orders, on the emulated forward's log-sum-exp) against autograd of the
    plain version: in f32 within 2e-5, with the bf16 roundings on bf16
    inputs within 3e-2 x max(1, max|want|); a row with no valid key gets
    zero gradient."""
    b, hq, hkv, sq, sk, d, dv, kw = case
    q, k, v = (torch.tensor(x).to(dtype).requires_grad_(True) for x in
               _qkv(sq + d, b, hq, hkv, sq, sk, d, dv))
    g = torch.tensor(_normal(sq * 3 + dv, b, hq, sq, dv)).to(dtype)
    out = FA.flash_attention_plain(q, k, v, **kw)
    want = torch.autograd.grad(out, (q, k, v), g)
    _, lse = _emulate_bf16_flash(q.detach(), k.detach(), v.detach(),
                                 return_lse=True, **kw)
    got = _emulate_flash_bwd(q.detach(), k.detach(), v.detach(),
                             out.detach(), g, lse, bf16=dtype != torch.float32,
                             **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert a.dtype == w.dtype, name
        tol = (F32_TOL if dtype == torch.float32
               else BF16_TOL * max(1.0, w.float().abs().max().item()))
        np.testing.assert_allclose(a.float().numpy(), w.float().numpy(),
                                   rtol=0, atol=tol, err_msg=name)
    if kw.get("q_offset", 0) < 0:
        assert bool((got[0][:, :, :-kw["q_offset"]] == 0).all())


@pytest.mark.parametrize("kw", [{}, dict(window=16, softcap=30.0),
                                dict(q_offset=-5),
                                dict(causal=False, q_offset=20)],
                         ids=["causal", "window+softcap", "q_offset=-5",
                              "non-causal"])
def test_emulated_forward_lse_matches_logsumexp(kw):
    """The log-sum-exp the forward kernel saves (emulated: scale m + ln l
    from its online softmax) against torch.logsumexp of the plain
    version's scaled, masked (softcapped) scores, within 2e-5 x max(1,
    |want|); +inf on a row with no key, where the plain one is -inf."""
    q, k, v = _qkv(33, 2, 8, 2, 49, 70, 64)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    _, got = _emulate_bf16_flash(tq, tk, tv, return_lse=True, **kw)
    cap, scale = kw.get("softcap", 0.0), 64 ** -0.5
    x = (tq * scale) @ tk.repeat_interleave(4, dim=1).transpose(-1, -2)
    if cap > 0.0:
        x = cap * torch.tanh(x / cap)
    mask = tref.attention_mask(49, 70, causal=kw.get("causal", True),
                               window=kw.get("window", 0),
                               q_offset=kw.get("q_offset", 0),
                               device="cpu")
    want = torch.logsumexp(x.masked_fill(~mask, float("-inf")), dim=-1)
    empty = torch.isinf(want)
    assert bool(empty.any()) == (kw.get("q_offset", 0) < 0)
    assert bool(torch.isposinf(got[empty]).all())
    assert bool(torch.isfinite(got[~empty]).all())
    np.testing.assert_array_less(
        ((got - want)[~empty].abs() / want[~empty].abs().clamp(min=1.0))
        .numpy(), F32_TOL)
    np.testing.assert_allclose(
        FA.flash_lse_plain(tq, tk, tv, **kw).numpy(),
        torch.where(empty, float("inf"), want).numpy(), rtol=0, atol=1e-5)


# nq, na, d, k  (tests/test_kernels.py, plus the SCOPE shape)
TOPK_CASES = [(16, 64, 8, 3), (37, 301, 24, 5), (128, 250, 32, 5),
              (5, 1000, 16, 10), (8, 250, 32, 5)]


@pytest.mark.parametrize("case", TOPK_CASES)
def test_topk_plain_matches_jax(case):
    nq, na, d, k = case
    (jq, ja), (tq, ta) = _both(_normal(9, nq, d), _normal(10, na, d))
    sr, ir = jref.topk_retrieval(jq, ja, k)
    sp, ip = topk_pallas(jq, ja, k, block_q=16, block_n=64, interpret=True)
    st, it = ops.topk_retrieval(tq, ta, k)
    assert it.dtype == torch.int32 and st.dtype == torch.float32
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), atol=TOPK_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sp), atol=TOPK_TOL)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ir))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ip))


def test_topk_exact_ties_go_to_the_lower_index():
    """One-hot rows make every similarity exact (0, 1 or 2 / sqrt 2 ...
    computed without rounding), so ties are real ties in every framework:
    all three implementations must order them by anchor index."""
    anchors = np.zeros((300, 32), np.float32)
    anchors[np.arange(300), np.arange(300) % 32] = 1.0
    queries = np.zeros((7, 32), np.float32)
    queries[np.arange(7), np.arange(7) * 3] = 1.0
    queries[0, 5] = 1.0
    (jq, ja), (tq, ta) = _both(queries, anchors)
    sr, ir = jref.topk_retrieval(jq, ja, 12, anchors_prenormalized=True)
    sp, ip = topk_pallas(jq, ja, 12, block_q=8, block_n=64, interpret=True,
                         anchors_prenormalized=True)
    st, it = ops.topk_retrieval(tq, ta, 12, anchors_prenormalized=True)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ir))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ip))
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), atol=TOPK_TOL)
    assert it[1].tolist() == [3 + 32 * j for j in range(10)] + [0, 1]


# ---------------------------------------------------------------------------
# Wrappers: argument checks, device dispatch, no fallback
# ---------------------------------------------------------------------------
def test_cpu_dispatch_runs_plain_versions_and_counts_no_launch():
    before = launch_counts()
    _, (tq, tk, tv) = _both(*_qkv(11, 1, 4, 2, 8, 8, 32))
    ops.flash_attention(tq, tk, tv)
    ops.decode_attention(tq[:, :, :1], tk, tv, 5)
    ops.topk_retrieval(tq[0, 0], tk[0, 0], 3)
    assert launch_counts() == before


@pytest.mark.parametrize("fn", [
    lambda t: FA.flash_attention(t, t, t),
    lambda t: DA.decode_attention(t[:, :, :1], t, t, 3),
    lambda t: TK.topk_retrieval(t[0, 0], t[0, 0], 2),
])
def test_non_cpu_non_cuda_tensor_raises(fn):
    """Only a CPU tensor takes the plain version; anything else must reach
    the kernel or raise — here a meta tensor raises before any launch."""
    t = torch.empty((1, 2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fn(t)


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("q,k,v,match", [
    (_t(1, 2, 8, 48), _t(1, 2, 8, 48), _t(1, 2, 8, 48), "head dims"),
    (_t(1, 2, 8, 32), _t(1, 2, 8, 32), _t(1, 2, 8, 40), "head dims"),
    (_t(1, 2, 8, 32, dtype=torch.float16), _t(1, 2, 8, 32,
                                              dtype=torch.float16),
     _t(1, 2, 8, 32, dtype=torch.float16), "dtypes"),
    (_t(1, 2, 8, 32), _t(1, 2, 8, 32, dtype=torch.bfloat16),
     _t(1, 2, 8, 32), "dtypes"),
    (_t(1, 3, 8, 32), _t(1, 2, 8, 32), _t(1, 2, 8, 32), "multiple"),
    (_t(1, 2, 8, 32), _t(1, 2, 8, 32), _t(1, 2, 9, 32), "mismatch"),
    (_t(1, 2, 32, 8).transpose(2, 3), _t(1, 2, 8, 32), _t(1, 2, 8, 32),
     "contiguous"),
    # bf16 rows are copied in 16-byte pieces: strides in multiples of 8
    # elements, 16-byte aligned bases
    (_t(1, 2, 8, 36, dtype=torch.bfloat16)[..., :32],
     _t(1, 2, 8, 32, dtype=torch.bfloat16),
     _t(1, 2, 8, 32, dtype=torch.bfloat16), "multiples of 8"),
    (_t(1, 2, 8, 32, dtype=torch.bfloat16),
     _t(1, 2, 8, 40, dtype=torch.bfloat16)[..., 1:33],
     _t(1, 2, 8, 32, dtype=torch.bfloat16), "aligned"),
])
def test_flash_check_args_rejects(q, k, v, match):
    with pytest.raises(ValueError, match=match):
        FA.check_args(q, k, v)


def test_flash_check_args_accepts_model_layout_and_f32_odd_strides():
    """The model's bf16 views ((b, s, h, d) projections transposed) pass the
    16-byte rules; float32 runs the FMA kernel, which takes any stride."""
    bf = torch.bfloat16
    q = _t(2, 49, 32, 128, dtype=bf).transpose(1, 2)
    kv = _t(2, 49, 8, 128, dtype=bf).transpose(1, 2)
    FA.check_args(q, kv, kv)
    odd = _t(1, 2, 8, 36)[..., 1:33]
    FA.check_args(odd, odd, odd)


def test_flash_forward_takes_d112_and_backward_refuses_it():
    """d = dv = 112 (zamba2-7b's tied block, which trains) is a head dim of
    the flash kernels, forward and backward alike (one ``check_args``), in
    the model's bf16 layout too; they still refuse 112 paired with another
    dv, by name."""
    bf = torch.bfloat16
    q = _t(2, 49, 32, 112, dtype=bf).transpose(1, 2)
    FA.check_args(q, q, q)
    FA.check_args(_t(1, 4, 8, 112), _t(1, 4, 8, 112), _t(1, 4, 8, 112))
    for d, dv in ((112, 128), (128, 112), (112, 64)):
        with pytest.raises(ValueError, match="head dims.*the flash kernels"):
            FA.check_args(_t(1, 2, 8, d), _t(1, 2, 8, d), _t(1, 2, 8, dv))
    FA.check_args(_t(1, 2, 8, 128), _t(1, 2, 8, 128), _t(1, 2, 8, 64))


def test_decode_kernels_take_d112_only_with_dv_112():
    lens = torch.tensor([3, 4], dtype=torch.int32)
    q, kc = _t(2, 4, 1, 112), _t(2, 4, 16, 112)
    DA.check_args(q, kc, kc, lens)
    table = torch.zeros((2, 2), dtype=torch.int32)
    DA.check_paged_args(q, _t(5, 4, 8, 112), _t(5, 4, 8, 112), lens, table,
                        8, 16)
    with pytest.raises(ValueError, match="head dims"):
        DA.check_args(q, kc, _t(2, 4, 16, 64), lens)
    with pytest.raises(ValueError, match="paged decode kernel"):
        DA.check_paged_args(q, _t(5, 4, 8, 112), _t(5, 4, 8, 128), lens,
                            table, 8, 16)


def test_decode_check_args_rejects():
    q, kc = _t(2, 4, 1, 32), _t(2, 2, 16, 32)
    lens = torch.tensor([3, 4], dtype=torch.int32)
    DA.check_args(q, kc, kc, lens)                     # accepted
    with pytest.raises(ValueError, match="one query token"):
        DA.check_args(_t(2, 4, 2, 32), kc, kc, lens)
    with pytest.raises(ValueError, match="group"):
        DA.check_args(_t(2, 34, 1, 32), _t(2, 2, 16, 32), _t(2, 2, 16, 32),
                      lens)
    with pytest.raises(ValueError, match="int32"):
        DA.check_args(q, kc, kc, lens.long())
    with pytest.raises(ValueError, match="head dims"):
        DA.check_args(_t(2, 4, 1, 96), _t(2, 2, 16, 96), _t(2, 2, 16, 96),
                      lens)


def test_topk_check_args_rejects():
    TK.check_args(_t(3, 32), _t(250, 32), 5)           # accepted
    with pytest.raises(ValueError, match="k="):
        TK.check_args(_t(3, 32), _t(250, 32), 65)
    with pytest.raises(ValueError, match="k="):
        TK.check_args(_t(3, 32), _t(4, 32), 5)
    with pytest.raises(ValueError, match="float32"):
        TK.check_args(_t(3, 32, dtype=torch.bfloat16), _t(250, 32), 5)
    with pytest.raises(ValueError, match="contiguous"):
        TK.check_args(_t(32, 3).T, _t(250, 32), 2)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No compiler, no kernel: the build fails loudly rather than letting a
    caller slide onto a plain version."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "NVCC_PATHS", (str(tmp_path / "no-nvcc"),))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["topk_retrieval"])
    assert not list(tmp_path.iterdir())


def test_library_path_tracks_sources():
    p = build.lib_path("flash_attention")
    assert p.parent == build.BUILD_DIR and p.suffix == ".so"
    assert p == build.lib_path("flash_attention")
    assert p != build.lib_path("decode_attention")
