"""AdamW with gradient clipping and LR schedules, over a dict of tensors.

The port of ``repro/training/optimizer.py``: the reference's warmup +
cosine (or constant) schedule, global-norm clipping and decoupled weight
decay, written out functionally in float32 so one update matches the
reference's.  ``adamw_update`` runs under ``torch.no_grad`` and returns new
tensors; it never mutates ``params`` or the state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"          # cosine | constant


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step``, a float32 scalar on the CPU."""
    step = torch.as_tensor(step, dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), one)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, leaves in sorted key order
    (the reference's pytree order)."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float()))
                          for k in sorted(tree)))


def adamw_init(params: Tree) -> AdamWState:
    return AdamWState(
        step=0,
        mu={k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()})


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tree, state: AdamWState,
                 params: Tree) -> Tuple[Tree, AdamWState]:
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    grads = {k: g.float() * scale for k, g in grads.items()}

    step = state.step + 1
    # float32 scalars computed on the host, applied as Python floats (each
    # exactly a float32 value, so the products below stay float32's)
    step_f = torch.tensor(float(step), dtype=torch.float32)
    lr = float(lr_at(cfg, step))
    b1c = float(1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** step_f)
    b2c = float(1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** step_f)

    mu = {k: cfg.b1 * state.mu[k] + (1 - cfg.b1) * g
          for k, g in grads.items()}
    nu = {k: cfg.b2 * state.nu[k] + (1 - cfg.b2) * g * g
          for k, g in grads.items()}

    def upd(p, m, v):
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay \
            * p.float()
        return (p.float() - lr * delta).to(p.dtype)

    new_params = {k: upd(p, mu[k], nu[k]) for k, p in params.items()}
    return new_params, AdamWState(step=step, mu=mu, nu=nu)
