"""GRPO reward (SCOPE Eq. 6, 9, 10): a copy of ``repro/core/rewards.py``.

R(o) = G(o) * (R_corr + R_token)
  G       — binary format gate (well-formed structured prediction)
  R_corr  — 1 iff predicted correctness label matches ground truth
  R_token — plateau-with-decay around the ground-truth token count with the
            adaptive tolerance tau = max(200, 0.5 * len_gt): full reward
            within tau/2, linear decay to zero at tau.
"""
from __future__ import annotations

from typing import Dict


def adaptive_tolerance(len_gt: float) -> float:
    return max(200.0, 0.5 * float(len_gt))


def token_reward(len_hat: float, len_gt: float) -> float:
    tau = adaptive_tolerance(len_gt)
    d = abs(float(len_hat) - float(len_gt))
    if d <= tau / 2:
        return 1.0
    if d <= tau:
        return (tau - d) / (0.5 * tau)
    return 0.0


def correctness_reward(y_hat: int, y_gt: int) -> float:
    return 1.0 if int(y_hat) == int(y_gt) else 0.0


def grpo_reward(parsed: Dict, y_gt: int, len_gt: float) -> float:
    """parsed: output of ``tokenizer.parse_prediction``."""
    gate = 1.0 if parsed.get("well_formed", False) else 0.0
    if gate == 0.0:
        return 0.0
    return gate * (correctness_reward(parsed["y_hat"], y_gt)
                   + token_reward(parsed["len_hat"], len_gt))
