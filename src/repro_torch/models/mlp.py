"""Feed-forward blocks: SwiGLU (the llama / qwen / gemma families) and GELU
(whisper); weights stored (in, out), applied as x @ W."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, out_proj


def init_mlp(generator: torch.Generator, cfg: ModelConfig, *, device,
             dtype, d_ff: int = 0) -> Dict:
    """An MLP of hidden width ``d_ff`` (0: ``cfg.d_ff``)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    names = ((("w1", (d, f)), ("w2", (f, d))) if cfg.mlp_kind == "gelu" else
             (("wi_gate", (d, f)), ("wi_up", (d, f)), ("wo", (f, d))))
    return {name: dense_init(shape, generator, device=device, dtype=dtype)
            for name, shape in names}


def mlp_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor, *,
                partial: bool = False) -> torch.Tensor:
    """``partial``: the columns are one rank's share of a split over
    ``model``; the output is their float32 share (``common.out_proj``)."""
    if cfg.mlp_kind == "gelu":
        # jax.nn.gelu's default is the tanh approximation; F.gelu's the erf
        return out_proj(F.gelu(x @ p["w1"], approximate="tanh"), p["w2"],
                        partial)
    return out_proj(F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"]), p["wo"],
                    partial)
