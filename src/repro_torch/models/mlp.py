"""SwiGLU feed-forward block; weights stored (in, out), applied as x @ W."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init


def init_mlp(generator: torch.Generator, cfg: ModelConfig, *, device,
             dtype) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"wi_gate": dense_init((d, f), generator, device=device,
                                  dtype=dtype),
            "wi_up": dense_init((d, f), generator, device=device, dtype=dtype),
            "wo": dense_init((f, d), generator, device=device, dtype=dtype)}


def mlp_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"]
