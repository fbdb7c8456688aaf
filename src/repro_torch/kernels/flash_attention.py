"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its plain
PyTorch version.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (Pallas TPU).
On the H100 the prefill shape is bound by moving q/k/v/o once.  One C entry
point picks the kernel by dtype: bf16 (the model's path) runs on tensor
cores (``mma.sync``, one block per (batch, kv-head) and 64 of its group's
query rows, tiles loaded with 16-byte ``cp.async``); float32 runs the FMA
kernel, which keeps the 2e-5 parity tensor cores cannot.  Both keep the
online softmax in registers and read strided q/k/v views directly, so the
model passes its transposed projections without a copy.  See the source
for the design.

The gradient is the CUDA kernel ``csrc/flash_attention_bwd.cu`` (two grid
launches a call: dQ by 64 position-major rows of a GQA group, which also
writes each row's delta = rowsum(dO * O), then dK/dV by 64 keys; bf16 on
tensor cores, f32 on FMAs), wired in by ``FlashAttention``, an autograd
Function whose forward is the forward kernel asked to save each row's
log-sum-exp, which the backward reads instead of recomputing it.

``flash_attention`` dispatches on the tensor's device: a CPU tensor goes to
``flash_attention_plain`` (whose autograd is the plain version of both
directions); on a CUDA tensor, a call that autograd records (grad enabled,
an input that requires grad) goes through ``FlashAttention``, any other
launches the forward kernel; either raises on what the kernels do not
take.  ``launches`` counts forward launches, ``shape_launches`` the same
launches by (sq, sk, causal), which tells a model's calls apart (an
encoder's, a decoder's self- and cross-attention), ``bwd_launches`` and
``bwd_shape_launches`` backward calls, in all and by the same key.  Both
kernels take the same head dims, MLA's (d, dv) pairs included, so a loss
through any stack the forward serves trains on the card.  Calls outside
autograd (the serve path, rollouts, no-grad forwards) pass no log-sum-exp
buffer, and the kernel writes none.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import build, ref

# what both kernels take: any pair of PAIR_HEAD_DIMS, 112 with dv = d
# (zamba2-7b), and MLA's (d, dv) pairs: deepseek-v2-lite's nope + rope 192
# with v 128, and 48 with 32 on its reduced config
HEAD_DIMS = build.PAIR_HEAD_DIMS + (112,)
PAIRS = ((192, 128), (48, 32))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
shape_launches: Counter = Counter()
bwd_launches = 0
bwd_shape_launches: Counter = Counter()

GRID_Y_MAX = 65535
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 9
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                 + [ctypes.c_longlong] * 15
                 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                    ctypes.c_int, ctypes.c_void_p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (b, hq, sq, d); k: (b, hkv, sk, d); v: (b, hkv, sk, dv)
    -> (b, hq, sq, dv) in q's dtype, math in f32."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                    q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap, scale=scale,
                                q_offset=q_offset)


class FlashAttention(torch.autograd.Function):
    """Autograd over the two CUDA kernels: the forward kernel, which also
    writes each row's log-sum-exp, and the backward kernel on the saved q,
    k, v, output and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset):
        mask = dict(causal=causal, window=window, softcap=softcap,
                    scale=scale, q_offset=q_offset)
        out, lse = flash_attention_cuda(q, k, v, return_lse=True, **mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if not _rows_fit(dout):
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                              **ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, scale: Optional[float] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """``ref.attention``, except that a query row with no valid key gives 0
    (the TPU kernel's ``l == 0`` guard) where the oracle averages v."""
    out = ref.attention(q, k, v, causal=causal, window=window,
                        softcap=softcap, scale=scale, q_offset=q_offset)
    mask = ref.attention_mask(q.shape[2], k.shape[2], causal=causal,
                              window=window, q_offset=q_offset,
                              device=q.device)
    return out.masked_fill(~mask.any(dim=-1)[:, None], 0.0)


def flash_lse_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """(b, hq, sq) f32: each row's log-sum-exp over its valid keys of the
    scaled (then softcapped) scores, the forward kernel's ``lse`` output;
    +inf for a row with no valid key."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    x = (q.float() * scale) @ kf.transpose(-1, -2)
    if softcap > 0.0:
        x = ref.softcap_fn(x, softcap)
    mask = ref.attention_mask(sq, sk, causal=causal, window=window,
                              q_offset=q_offset, device=q.device)
    lse = torch.logsumexp(x.masked_fill(~mask, float("-inf")), dim=-1)
    return lse.masked_fill(~mask.any(dim=-1), float("inf"))


def check_args(q, k, v) -> None:
    """Raise ``ValueError`` on any input the kernels (forward and backward
    alike) do not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D (b, h, s, d)")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         "takes float32 or bfloat16, all the same")
    if k.shape[0] != b or v.shape[0] != b or v.shape[1] != hkv \
            or v.shape[2] != sk or k.shape[3] != d:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"hq {hq} is not a multiple of hkv {hkv}")
    build.check_head_dims(d, v.shape[3], HEAD_DIMS, "the flash kernels",
                          PAIRS)
    if b == 0 or sq == 0 or sk == 0:
        raise ValueError("empty batch or sequence")
    # the grids' y extents (csrc/flash_attention.cu, flash_attention_bwd.cu):
    # bf16 tiles of 64 position-major rows (group x sq) and of 64 keys;
    # f32 tiles of 16 query rows forward, and the backward's (b x hq) and
    # (b x hkv) blocks
    g = hq // hkv
    ys = ((-(-g * sq // 64), -(-sk // 64)) if q.dtype == torch.bfloat16
          else (-(-sq // 16), b * hq))
    if max(ys) > GRID_Y_MAX:
        raise ValueError(f"b {b}, hq {hq}, group {g}, sq {sq}, sk {sk}: a "
                         f"grid of {max(ys)} blocks in y, past the "
                         f"{GRID_Y_MAX} CUDA allows")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        if not _rows_fit(t):
            raise ValueError(f"bf16 {name} needs strides {t.stride()} that "
                             "are multiples of 8 elements and a 16-byte "
                             "aligned base")


def _rows_fit(t: torch.Tensor) -> bool:
    """Whether the kernels can read ``t``'s rows: a contiguous last dim and,
    in bf16 (copied in 16-byte pieces), strides that are multiples of 8
    elements and a 16-byte aligned base."""
    return t.stride(3) == 1 and not (
        t.dtype == torch.bfloat16
        and (any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16))


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, scale: Optional[float] = None,
                         q_offset: int = 0, return_lse: bool = False):
    """The forward kernel's output; with ``return_lse`` also each row's
    log-sum-exp (b, hq, sq) f32 (``flash_lse_plain``), which only then is
    written."""
    global launches
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention kernel needs CUDA tensors on one "
                         f"device, got {q.device}/{k.device}/{v.device}")
    check_args(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = build.load("flash_attention", "repro_flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(),
             DTYPES[q.dtype], b, hq, hkv, sq, sk, d, dv,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             int(causal), int(window), float(softcap), float(scale),
             int(q_offset), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    # scopelint-torch: allow[device-body-side-effect] -- counted at the Python call; a CUDA graph replay repeats the launch without counting it (ROADMAP item 8b)
    launches += 1
    # scopelint-torch: allow[device-body-side-effect] -- counted at the Python call; a CUDA graph replay repeats the launch without counting it (ROADMAP item 8b)
    shape_launches[(sq, sk, bool(causal))] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             scale: Optional[float] = None,
                             q_offset: int = 0):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` whose output is ``out``
    and log-sum-exp ``lse`` (the forward kernel's, ``return_lse=True``) for
    the upstream gradient ``dout`` (b, hq, sq, dv); each in its input's
    shape and dtype, contiguous."""
    global bwd_launches
    if any(t.device != q.device for t in (k, v, out, dout, lse)) \
            or q.device.type != "cuda":
        raise ValueError("flash_attention backward needs CUDA tensors on one "
                         "device")
    check_args(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != (b, hq, sq, dv) or t.dtype != q.dtype \
                or not _rows_fit(t):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} strides "
                             f"{t.stride()} must be ({b}, {hq}, {sq}, {dv}) "
                             f"{q.dtype}, laid out as check_args asks of q")
    if tuple(lse.shape) != (b, hq, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} must be "
                         f"({b}, {hq}, {sq}) float32, contiguous")
    scale = scale if scale is not None else d ** -0.5
    dq = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, hkv, sk, d), dtype=q.dtype, device=q.device)
    dvv = torch.empty((b, hkv, sk, dv), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    fn = build.load("flash_attention_bwd", "repro_flash_attention_bwd",
                    _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
             lse.data_ptr(), delta.data_ptr(),
             DTYPES[q.dtype], b, hq, hkv, sq, sk, d, dv,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], *dout.stride()[:3],
             int(causal), int(window), float(softcap), float(scale),
             int(q_offset), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_bwd")
    # scopelint-torch: allow[device-body-side-effect] -- counted at the Python call; a CUDA graph replay repeats the launch without counting it (ROADMAP item 8b)
    bwd_launches += 1
    # scopelint-torch: allow[device-body-side-effect] -- counted at the Python call; a CUDA graph replay repeats the launch without counting it (ROADMAP item 8b)
    bwd_shape_launches[(sq, sk, bool(causal))] += 1
    return dq, dk, dvv
