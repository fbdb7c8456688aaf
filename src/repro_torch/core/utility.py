"""Utility formulation and cost normalization (SCOPE §5.1, App. B.3).

  c~      — log-transformed min-max normalization (Eq. 11)
  gamma   — dynamic cost sensitivity gamma_dyn = gamma_base*(1+beta*(1-a)) (Eq. 13)
  u       — alpha * p_hat + (1-alpha) * (1-c~)^gamma_dyn (Eq. 12)
"""
from __future__ import annotations

from typing import Optional

import numpy as np

EPS = 1e-6


def normalize_cost(costs: np.ndarray, *, c_min: Optional[float] = None,
                   c_max: Optional[float] = None,
                   axis: Optional[int] = None) -> np.ndarray:
    """Log min-max normalization (Eq. 11); bounds default to the given set
    (per-query predicted costs online, per-cluster costs in calibration).

    ``axis`` takes bounds per slice along that axis — e.g. ``axis=1`` on a
    (Q, M) cost matrix normalizes each query row independently, matching a
    per-row loop of the scalar form.  Explicit ``c_min``/``c_max`` bounds
    are incompatible with ``axis``.
    """
    c = np.asarray(costs, np.float64)
    if axis is not None:
        if c_min is not None or c_max is not None:
            raise ValueError("pass either axis or explicit bounds, not both")
        lo = np.log(c.min(axis=axis, keepdims=True) + EPS)
        hi = np.log(c.max(axis=axis, keepdims=True) + EPS)
        span = hi - lo
        degenerate = span < 1e-12
        out = (np.log(c + EPS) - lo) / np.where(degenerate, 1.0, span)
        out = np.where(degenerate, 0.0, out)
        return np.clip(out, 0.0, 1.0)
    lo = np.log((c_min if c_min is not None else c.min()) + EPS)
    hi = np.log((c_max if c_max is not None else c.max()) + EPS)
    if hi - lo < 1e-12:
        return np.zeros_like(c)
    out = (np.log(c + EPS) - lo) / (hi - lo)
    return np.clip(out, 0.0, 1.0)


def gamma_dyn(alpha: float, *, gamma_base: float = 1.0,
              beta: float = 2.0) -> float:
    return gamma_base * (1.0 + beta * (1.0 - float(alpha)))


def cost_score(c_norm: np.ndarray, alpha: float, *, gamma_base: float = 1.0,
               beta: float = 2.0) -> np.ndarray:
    g = gamma_dyn(alpha, gamma_base=gamma_base, beta=beta)
    return np.power(np.clip(1.0 - np.asarray(c_norm), 0.0, 1.0), g)


def predicted_utility(p_hat: np.ndarray, c_norm: np.ndarray, alpha: float,
                      *, gamma_base: float = 1.0, beta: float = 2.0
                      ) -> np.ndarray:
    """Eq. 12 over aligned arrays of shape (..., M)."""
    s = cost_score(c_norm, alpha, gamma_base=gamma_base, beta=beta)
    return float(alpha) * np.asarray(p_hat, np.float64) + (1.0 - float(alpha)) * s


def w_cal(alpha: float, *, w_base: float = 0.2) -> float:
    """Dynamic calibration weight (Eq. 14): 0.1 at alpha=0 -> 0.2 at alpha=1."""
    return w_base * (0.5 + 0.5 * float(alpha))
