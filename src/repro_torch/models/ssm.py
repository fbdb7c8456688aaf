"""Mamba2 block (SSD — state-space duality) [arXiv:2405.21060].

The full-sequence path (prefill) runs the chunked SSD scan
(``kernels.ops.ssd``: the ``ssd_scan`` kernel on the card); decode keeps an
O(1) recurrent state per row, the last ``width - 1`` pre-conv inputs and
the (heads, head_dim, n) SSM state, and writes both into the cache in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, init_rmsnorm, rmsnorm


def init_mamba(generator: torch.Generator, cfg: ModelConfig, *, device,
               dtype) -> Dict:
    """One layer's leaves, all in ``dtype``: after stacking every leaf has
    rank >= 2, and the JAX ``init_params`` casts those to the model dtype,
    the conv bias, ``A_log``, ``D`` and ``dt_bias`` included."""
    d, din, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    heads = cfg.resolved_ssm_heads
    conv_dim = din + 2 * n

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "in_proj": dense_init((d, 2 * din + 2 * n + heads), generator,
                              device=device, dtype=dtype),
        "conv_w": dense_init((cfg.ssm_conv_width, conv_dim), generator,
                             device=device, dtype=dtype, scale=1.0),
        "conv_b": full((conv_dim,), 0.0),
        "A_log": full((heads,), 0.0),              # A = -exp(A_log) = -1
        "D": full((heads,), 1.0),
        "dt_bias": full((heads,), 0.0),
        "norm": init_rmsnorm(din, device=device, dtype=dtype),
        "out_proj": dense_init((din, d), generator, device=device,
                               dtype=dtype),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    din, n, heads = cfg.d_inner, cfg.ssm_state, cfg.resolved_ssm_heads
    z = zxbcdt[..., :din]
    xBC = zxbcdt[..., din:din + din + 2 * n]
    dt = zxbcdt[..., -heads:]
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq: xBC (b, l, c); w (width, c)."""
    width, l = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + l] * w[i][None, None] for i in range(width))
    return F.silu(out + b[None, None])


def _largest_chunk(l: int, preferred: int) -> int:
    for c in range(min(preferred, l), 0, -1):
        if l % c == 0:
            return c
    return 1


def _conv_tail(cfg: ModelConfig, zxbcdt: torch.Tensor) -> torch.Tensor:
    """Last (width-1) pre-conv xBC inputs — the decode conv state."""
    _, xBC, _ = _split_proj(cfg, zxbcdt)
    w = cfg.ssm_conv_width
    b, l, c = xBC.shape
    if l >= w - 1:
        return xBC[:, l - (w - 1):]
    pad = torch.zeros((b, w - 1 - l, c), dtype=xBC.dtype, device=xBC.device)
    return torch.cat([pad, xBC], dim=1)


def mamba_full(p: Dict, cfg: ModelConfig,
               x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """x: (b, l, d) -> (y, cache {"conv", "ssm"})."""
    b, l, _ = x.shape
    din, n = cfg.d_inner, cfg.ssm_state
    heads, hd = cfg.resolved_ssm_heads, cfg.ssm_head_dim

    zxbcdt = x @ p["in_proj"]
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    x_in, B, C = xBC[..., :din], xBC[..., din:din + n], xBC[..., din + n:]
    dt = F.softplus(dt.float() + p["dt_bias"][None, None])      # (b, l, h)
    A = -torch.exp(p["A_log"])

    xh = x_in.reshape(b, l, heads, hd)      # a strided view of the conv out
    chunk = cfg.ssm_chunk if l % cfg.ssm_chunk == 0 else (
        1 if l == 1 else _largest_chunk(l, cfg.ssm_chunk))
    y, final_state = ops.ssd(xh, dt, A, B.float(), C.float(), chunk=chunk)
    y = y + xh * p["D"][None, None, :, None].to(xh.dtype)
    y = y.reshape(b, l, din)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.rmsnorm_eps)
    out = y @ p["out_proj"]
    return out, {"conv": _conv_tail(cfg, zxbcdt), "ssm": final_state}


def mamba_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict) -> torch.Tensor:
    """Single-token recurrent step.

    x: (b, 1, d); cache: {"conv": (b, width-1, conv_dim), "ssm": (b, heads,
    head_dim, n)}, both written in place with the new window and state
    (JAX returns new arrays): the state by ``ops.ssd_decode_step`` itself,
    the kernel on the card updating it where it lies."""
    b = x.shape[0]
    din, n = cfg.d_inner, cfg.ssm_state
    heads, hd = cfg.resolved_ssm_heads, cfg.ssm_head_dim

    zxbcdt = x @ p["in_proj"]
    z, xBC_new, dt = _split_proj(cfg, zxbcdt)                   # (b,1,·)
    conv_in = torch.cat([cache["conv"], xBC_new], dim=1)        # (b,w,c)
    conv_out = torch.einsum("bwc,wc->bc", conv_in.float(),
                            p["conv_w"].float())
    xBC = F.silu(conv_out + p["conv_b"][None]).to(x.dtype)
    x_in, B, C = xBC[:, :din], xBC[:, din:din + n], xBC[:, din + n:]
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"][None])
    A = -torch.exp(p["A_log"])

    xh = x_in.reshape(b, heads, hd)
    y, _ = ops.ssd_decode_step(
        cache["ssm"], xh.float(), dt, A, B.float(), C.float())
    y = y + xh.float() * p["D"][None, :, None]
    y = y.reshape(b, 1, din).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.rmsnorm_eps)
    cache["conv"].copy_(conv_in[:, 1:])
    return y @ p["out_proj"]
