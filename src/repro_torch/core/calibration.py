"""Anchor-based calibration (SCOPE §5.2, Fig. 11).

U_cal(M) aggregates the *ground-truth* performance of the retrieved anchors,
similarity-weighted, then maps through the same utility as the prediction:
a historical prior that corrects estimator errors and smooths the frontier
(Fig. 7 right).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.core.fingerprint import Fingerprint
from repro_torch.core.utility import normalize_cost, predicted_utility


def anchor_stats(fp: Fingerprint, idx: np.ndarray, sims: np.ndarray):
    """Similarity-weighted accuracy / cost of the retrieved slice."""
    w = np.clip(np.asarray(sims, np.float64), 0.0, None) + 1e-6
    w = w / w.sum()
    y = fp.y[idx].astype(np.float64)
    c = fp.cost[idx].astype(np.float64)
    return float(np.sum(w * y)), float(np.sum(w * c))


def calibration_utilities(fps: Dict[str, Fingerprint], models: Sequence[str],
                          idx: np.ndarray, sims: np.ndarray, alpha: float,
                          *, gamma_base: float = 1.0, beta: float = 2.0
                          ) -> np.ndarray:
    """U_cal per model for one query's retrieved anchor cluster."""
    p_cal = np.zeros(len(models))
    c_cal = np.zeros(len(models))
    for j, m in enumerate(models):
        p_cal[j], c_cal[j] = anchor_stats(fps[m], idx, sims)
    # cluster-wise log min-max normalization (Eq. 11 with cluster bounds)
    c_norm = normalize_cost(c_cal)
    return predicted_utility(p_cal, c_norm, alpha,
                             gamma_base=gamma_base, beta=beta)


def calibration_utilities_batch(fps: Dict[str, Fingerprint],
                                models: Sequence[str], idx: np.ndarray,
                                sims: np.ndarray, alpha: float, *,
                                gamma_base: float = 1.0, beta: float = 2.0
                                ) -> np.ndarray:
    """U_cal for a whole batch: idx/sims (Q, K) -> utilities (Q, M).

    Vectorizes ``calibration_utilities`` over queries — one gather per
    anchor statistic instead of a per-query Python loop on the serve path.
    """
    idx = np.asarray(idx, int)
    w = np.clip(np.asarray(sims, np.float64), 0.0, None) + 1e-6
    w = w / w.sum(axis=-1, keepdims=True)               # (Q, K)
    Y = np.stack([fps[m].y for m in models]).astype(np.float64)     # (M, A)
    C = np.stack([fps[m].cost for m in models]).astype(np.float64)  # (M, A)
    p_cal = np.einsum("qk,mqk->qm", w, Y[:, idx])
    c_cal = np.einsum("qk,mqk->qm", w, C[:, idx])
    c_norm = normalize_cost(c_cal, axis=-1)             # per-cluster bounds
    return predicted_utility(p_cal, c_norm, alpha,
                             gamma_base=gamma_base, beta=beta)
