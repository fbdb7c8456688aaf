"""Rotary position embeddings (standard RoPE, half-split rotation)."""
from __future__ import annotations

from typing import Tuple

import torch


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., seq) int -> cos/sin of shape (..., seq, head_dim)."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (batch, seq, heads, head_dim); cos/sin: (batch, seq, head_dim)."""
    x32 = x.float()
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return (x32 * c + _rotate_half(x32) * s).to(x.dtype)
