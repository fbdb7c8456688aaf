"""Budget-controlled alpha selection (SCOPE Appendix D, Prop. D.1).

For a query set X and budget B, find alpha* maximizing the expected accuracy
proxy P(alpha; X) subject to C(alpha; X) <= B.  Per Prop. D.1, routing
decisions under the affine score u = alpha*p + (1-alpha)*s only change at
pairwise intersection breakpoints; enumerating {0, 1, breakpoints, interval
representatives} suffices.

Everything here is vectorized numpy — the policies (``SetBudgetPolicy``,
``AccuracyFloorPolicy``) run this per serve batch, so the O(Q*M^2) pairwise
intersection enumeration and the O(A*Q*M) candidate sweep must not be
Python loops.  Float comparisons use ``TIE_TOL``: breakpoints are deduped
with a tolerance (exact ``set()`` dedup on floats kept near-identical
alphas that route identically) and the best-candidate tiebreak treats
performances within the tolerance as equal (an exact ``==`` tiebreak is
brittle under reordered float sums).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

TIE_TOL = 1e-9          # tolerance for dedup + perf/cost tie-breaking
_PARALLEL_EPS = 1e-12   # slopes closer than this never intersect usefully
_SWEEP_BLOCK = 256      # candidate alphas per vectorized routing block


def route_for_alpha(p_hat: np.ndarray, s_hat: np.ndarray, alpha: float
                    ) -> np.ndarray:
    """Affine decision (Eq. 17) with deterministic lowest-index tiebreak.

    p_hat, s_hat: (Q, M).  Returns argmax indices (Q,).
    """
    u = alpha * p_hat + (1.0 - alpha) * s_hat
    return np.argmax(u, axis=1)            # np.argmax: first max index


def route_for_alphas(p_hat: np.ndarray, s_hat: np.ndarray,
                     alphas: np.ndarray, *, block: int = _SWEEP_BLOCK
                     ) -> np.ndarray:
    """Vectorized ``route_for_alpha`` over a whole candidate set.

    Returns (A, Q) argmax indices.  Blocked so the (A, Q, M) utility tensor
    never materializes for large candidate sets (A grows as Q*M^2).
    """
    alphas = np.asarray(alphas, np.float64)
    A, Q = len(alphas), p_hat.shape[0]
    out = np.empty((A, Q), np.int64)
    for i in range(0, A, block):
        a = alphas[i: i + block][:, None, None]
        u = a * p_hat[None] + (1.0 - a) * s_hat[None]
        out[i: i + len(u)] = np.argmax(u, axis=2)
    return out


def breakpoints(p_hat: np.ndarray, s_hat: np.ndarray, *,
                tol: float = TIE_TOL) -> np.ndarray:
    """All pairwise intersection alphas in (0, 1) (Eq. 22-23).

    One vectorized pass over the upper-triangle (i, j) pair grid; sorted and
    deduped with ``tol``.
    """
    p = np.asarray(p_hat, np.float64)
    s = np.asarray(s_hat, np.float64)
    M = p.shape[1]
    if M < 2:
        return np.zeros(0)
    iu, ju = np.triu_indices(M, k=1)
    slopes = p - s                                   # (Q, M)
    denom = slopes[:, iu] - slopes[:, ju]            # (Q, P)
    num = s[:, ju] - s[:, iu]
    ok = np.abs(denom) >= _PARALLEL_EPS
    a = num[ok] / denom[ok]
    a = a[(a > 0.0) & (a < 1.0)]
    if a.size == 0:
        return np.zeros(0)
    a = np.sort(a)
    keep = np.empty(a.shape, bool)
    keep[0] = True
    np.greater(np.diff(a), tol, out=keep[1:])
    return a[keep]


def candidate_alphas(p_hat: np.ndarray, s_hat: np.ndarray) -> np.ndarray:
    """{0, 1} + breakpoints + interval representatives (Prop. D.1)."""
    bps = breakpoints(p_hat, s_hat)
    grid = np.concatenate([[0.0], bps, [1.0]])
    reps = (grid[:-1] + grid[1:]) / 2.0
    return np.unique(np.concatenate([grid, reps]))


def budget_alpha(p_hat: np.ndarray, s_hat: np.ndarray, c_hat: np.ndarray,
                 budget: float) -> Tuple[float, np.ndarray, Dict]:
    """Solve Eq. 20: maximize sum p_hat(chosen) s.t. sum c_hat(chosen) <= B.

    Returns (alpha*, choices (Q,), info).  If no alpha is feasible, falls
    back to the cheapest-cost alpha (most budget-conservative policy).
    Among feasible candidates, performances within ``TIE_TOL`` count as
    tied and the cheaper routing wins; remaining ties go to the smallest
    alpha (candidates are enumerated in ascending order).
    """
    cands = candidate_alphas(p_hat, s_hat)
    choices = route_for_alphas(p_hat, s_hat, cands)          # (A, Q)
    rows = np.arange(p_hat.shape[0])
    costs = np.asarray(c_hat, np.float64)[rows[None], choices].sum(axis=1)
    perfs = np.asarray(p_hat, np.float64)[rows[None], choices].sum(axis=1)

    cheapest_i = int(np.argmin(costs))                       # first min
    feas = costs <= budget
    feasible = bool(feas.any())
    if feasible:
        fi = np.flatnonzero(feas)
        best_perf = perfs[fi].max()
        tied = fi[perfs[fi] >= best_perf - TIE_TOL]          # perf ties
        best_i = int(tied[np.argmin(costs[tied])])           # cheapest, first
    else:
        best_i = cheapest_i
    return (float(cands[best_i]), choices[best_i],
            {"expected_cost": float(costs[best_i]),
             "expected_perf": float(perfs[best_i]),
             "feasible": feasible,
             "num_candidates": len(cands)})
