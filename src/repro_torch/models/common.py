"""Shared model building blocks: initializers, RMSNorm, the logit softcap,
dtypes.

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
               dtype=torch.float32, scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init, the distribution of the JAX
    ``dense_init`` (std = scale / sqrt(fan_in), cut at +-2 std)."""
    fan_in = shape[0] if len(shape) >= 2 else max(1, shape[-1])
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * (scale / fan_in ** 0.5)).to(dtype)


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


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2-style logit soft-capping: cap * tanh(x / cap); a no-op at
    ``cap <= 0``."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)
