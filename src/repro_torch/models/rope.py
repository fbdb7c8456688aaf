"""Rotary position embeddings: standard RoPE (half-split rotation) and
Qwen2-VL's M-RoPE.

M-RoPE splits the head dim into (temporal, height, width) sections; each
section rotates by its own position stream.  For text-only tokens all three
streams coincide, which gives standard RoPE bit for bit.
"""
from __future__ import annotations

from typing import Sequence, Tuple

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


def mrope_cos_sin(positions_3d: torch.Tensor, head_dim: int, theta: float,
                  sections: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE.

    positions_3d: (3, batch, seq) int — temporal / height / width streams.
    ``sections`` gives each stream's share of head_dim (summing to it):
    stream i owns the next ``sections[i] // 2`` of the hd/2 frequency slots,
    taken in order; the merged angles are then duplicated, as in standard
    RoPE.  -> cos/sin of shape (batch, seq, head_dim).
    """
    if sum(sections) != head_dim:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim {head_dim}")
    freqs = rope_frequencies(head_dim, theta, positions_3d.device)
    angles = positions_3d[..., None].float() * freqs     # (3, b, s, hd/2)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(angles[i, ..., start:start + sec // 2])
        start += sec // 2
    merged = torch.cat(parts, dim=-1)                    # (b, s, hd/2)
    merged = torch.cat([merged, merged], dim=-1)         # (b, s, hd)
    return torch.cos(merged), torch.sin(merged)


def text_positions_3d(positions: torch.Tensor) -> torch.Tensor:
    """Lift 1-D positions (batch, seq) to degenerate 3-D M-RoPE streams."""
    return positions[None].expand((3,) + tuple(positions.shape))
