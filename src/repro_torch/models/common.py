"""Shared model building blocks: initializers, RMSNorm, the logit softcap,
sinusoid positions, dtypes.

Parameters are plain nested dicts of tensors laid out exactly as the JAX
package's pytrees (per-segment layer stacks on axis 0), so the weight
bridge is a leaf-for-leaf copy.
"""
from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init(shape, generator: torch.Generator, *, device,
               dtype=torch.float32, scale: float = 1.0,
               stacked: bool = False) -> torch.Tensor:
    """Truncated-normal fan-in init, the distribution of the JAX
    ``dense_init`` (std = scale / sqrt(fan_in), cut at +-2 std).
    ``stacked``: ``shape[0]`` counts matrices of ``shape[1:]`` (a MoE
    layer's experts, the reference's ``vmap`` of ``dense_init``), each with
    the fan-in ``shape[1]``."""
    mat = shape[1:] if stacked else shape
    fan_in = mat[0] if len(mat) >= 2 else max(1, mat[-1])
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale / fan_in ** 0.5).to(dtype)


def embed_init(shape, generator: torch.Generator, *, device,
               dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 0.02), the distribution of the JAX ``embed_init``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(0.0, 0.02, generator=generator)
    return t.to(dtype)


def init_rmsnorm(dim: int, *, device, dtype=torch.float32):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def out_proj(y: torch.Tensor, w: torch.Tensor, partial: bool = False
             ) -> torch.Tensor:
    """``y @ w``; with ``partial`` (one rank's share of a product split over
    ``model``) in float32, so that the sum over the ranks is rounded to the
    model dtype once, as the whole product is."""
    return y.float() @ w.float() if partial else y @ w


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2-style logit soft-capping: cap * tanh(x / cap); a no-op at
    ``cap <= 0``."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def sinusoidal_positions(length: int, dim: int, *, device,
                         dtype=torch.float32) -> torch.Tensor:
    """The standard (whisper-style) sinusoid table (length, dim): sin at
    even, cos at odd columns, built in float32 and cast to ``dtype``."""
    return sinusoid_at(torch.arange(length, device=device), dim).to(dtype)


def sinusoid_at(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., dim) float32 sinusoid embedding at each position of ``pos``
    (...,), the rows of ``sinusoidal_positions``.  The frequencies are
    exp(2i * (-log(10000) / dim)), each factor rounded to float32 as the
    reference computes them."""
    # on the host: a float32 scalar the product reads as a kernel argument,
    # where one made on the card would be a copy that waits for the stream
    log_base = torch.log(torch.tensor(10000.0))
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=pos.device) * (-log_base / dim))
    ang = pos.float()[..., None] * div
    return torch.stack([torch.sin(ang), torch.cos(ang)],
                       dim=-1).reshape(*ang.shape[:-1], dim)


def promoted_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.matmul``
    promotes (float32 stubs times bfloat16 weights give float32);
    ``torch.matmul`` refuses mixed dtypes."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)
