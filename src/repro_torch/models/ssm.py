"""Mamba2 block (SSD — state-space duality) [arXiv:2405.21060].

The full-sequence path (prefill) runs the chunked SSD scan
(``kernels.ops.ssd``: the ``ssd_scan`` kernel on the card); decode keeps an
O(1) recurrent state per row, the last ``width - 1`` pre-conv inputs and
the (heads, head_dim, n) SSM state, and writes both into the cache in place.

Split over ``model`` (``tp``, the layer's ``collectives.TP``), a rank
computes h / n of the SSD heads: its heads' columns of ``z``, ``x`` and
``dt`` from the whole ``in_proj`` and the whole ``B`` and ``C`` (one group,
shared by every head), the conv over its ``x`` channels and ``B`` / ``C``,
the scan or step on its heads, the gated norm over all of ``d_inner`` (its
sum of squares summed over ``model``), and its rows of ``out_proj`` in
float32, summed over ``model``.  Its caches hold ``conv`` (b, width - 1,
d_inner / n + 2 n) and ``ssm`` (b, h / n, head_dim, n).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.kernels import ops
from repro_torch.models.common import (dense_init, init_rmsnorm, out_proj,
                                       rmsnorm)


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


def _dims(cfg: ModelConfig, tp) -> Tuple[int, int, int]:
    """(d_inner, heads, state) a rank computes: its share of the inner
    width and of the heads under ``tp``, all of them otherwise."""
    din, heads = cfg.d_inner, cfg.resolved_ssm_heads
    if tp is None:
        return din, heads, cfg.ssm_state
    return din // tp.n, heads // tp.n, cfg.ssm_state


def _rank_leaves(p: Dict, cfg: ModelConfig, tp) -> Dict:
    """The layer's leaves as this rank uses them: ``in_proj``'s columns of
    its heads' z, x and dt and of the whole B and C, in the layout of the
    whole matrix ([z | x | B | C | dt]); the conv's x channels of its heads
    and all of B and C; its heads' ``A_log``, ``D``, ``dt_bias`` and norm
    scales; ``out_proj`` as given (its block of rows is the rank's).  The
    leaves themselves under no split."""
    if tp is None:
        return p
    din, heads, n = cfg.d_inner, cfg.resolved_ssm_heads, cfg.ssm_state
    dl, hl = din // tp.n, heads // tp.n
    x0, h0 = tp.rank * dl, tp.rank * hl

    def channels(w):
        return torch.cat([w[..., x0:x0 + dl], w[..., din:]], dim=-1)

    w = p["in_proj"]
    dt0 = 2 * din + 2 * n + h0
    return {"in_proj": torch.cat([w[:, x0:x0 + dl],
                                  w[:, din + x0:din + x0 + dl],
                                  w[:, 2 * din:2 * din + 2 * n],
                                  w[:, dt0:dt0 + hl]], dim=1),
            "conv_w": channels(p["conv_w"]), "conv_b": channels(p["conv_b"]),
            "A_log": p["A_log"][h0:h0 + hl], "D": p["D"][h0:h0 + hl],
            "dt_bias": p["dt_bias"][h0:h0 + hl],
            "norm": {"scale": p["norm"]["scale"][x0:x0 + dl]},
            "out_proj": p["out_proj"]}


def _split_proj(dims: Tuple[int, int, int], zxbcdt: torch.Tensor):
    din, heads, n = dims
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


def _conv_tail(cfg: ModelConfig, dims: Tuple[int, int, int],
               zxbcdt: torch.Tensor) -> torch.Tensor:
    """Last (width-1) pre-conv xBC inputs — the decode conv state."""
    _, xBC, _ = _split_proj(dims, zxbcdt)
    w = cfg.ssm_conv_width
    b, l, c = xBC.shape
    if l >= w - 1:
        return xBC[:, l - (w - 1):]
    pad = torch.zeros((b, w - 1 - l, c), dtype=xBC.dtype, device=xBC.device)
    return torch.cat([pad, xBC], dim=1)


def _gated_norm(p: Dict, cfg: ModelConfig, y: torch.Tensor,
                z: torch.Tensor, tp) -> torch.Tensor:
    """RMSNorm of y * silu(z) over all of ``d_inner``: under ``tp`` the
    float32 sum of squares of the rank's share summed over ``model``."""
    g = y * F.silu(z)
    if tp is None:
        return rmsnorm(p["norm"], g, cfg.rmsnorm_eps)
    g32 = g.float()
    total = coll.shared_sum(g32.square().sum(dim=-1, keepdim=True),
                            tp.group)
    out = g32 * torch.rsqrt(total / cfg.d_inner + cfg.rmsnorm_eps)
    return (out * p["norm"]["scale"].float()).to(g.dtype)


def _out(p: Dict, y: torch.Tensor, tp, dtype: torch.dtype) -> torch.Tensor:
    """``y @ out_proj``: under ``tp`` the rank's rows in float32, summed
    over ``model`` and rounded once."""
    if tp is None:
        return y @ p["out_proj"]
    return coll.leave(out_proj(y, p["out_proj"], partial=True),
                      tp.group).to(dtype)


def mamba_full(p: Dict, cfg: ModelConfig, x: torch.Tensor, *,
               tp=None) -> Tuple[torch.Tensor, Dict]:
    """x: (b, l, d) -> (y, cache {"conv", "ssm"}); ``tp`` computes this
    rank's heads (module docstring)."""
    b, l, _ = x.shape
    dims = _dims(cfg, tp)
    din, heads, n = dims
    hd = cfg.ssm_head_dim
    p = _rank_leaves(p, cfg, tp)
    if tp is not None:
        x = coll.enter(x, tp.group)

    zxbcdt = x @ p["in_proj"]
    z, xBC, dt = _split_proj(dims, zxbcdt)
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
    y = _gated_norm(p, cfg, y, z, tp)
    out = _out(p, y, tp, x.dtype)
    return out, {"conv": _conv_tail(cfg, dims, zxbcdt), "ssm": final_state}


def mamba_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict, *, tp=None) -> torch.Tensor:
    """Single-token recurrent step.

    x: (b, 1, d); cache: {"conv": (b, width-1, conv_dim), "ssm": (b, heads,
    head_dim, n)} (a rank's channels and heads under ``tp``), both written
    in place with the new window and state (JAX returns new arrays): the
    state by ``ops.ssd_decode_step`` itself, the kernel on the card
    updating it where it lies."""
    b = x.shape[0]
    dims = _dims(cfg, tp)
    din, heads, n = dims
    hd = cfg.ssm_head_dim
    p = _rank_leaves(p, cfg, tp)

    zxbcdt = x @ p["in_proj"]
    z, xBC_new, dt = _split_proj(dims, zxbcdt)                  # (b,1,·)
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
    y = _gated_norm(p, cfg, y, z, tp)
    cache["conv"].copy_(conv_in[:, 1:])
    return _out(p, y, tp, x.dtype)
