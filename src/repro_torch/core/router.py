"""Pool-wide prediction container for SCOPE routing.

``PoolPredictions`` is the alpha-independent product of the pre-hoc
estimation pass (SCOPE §5, Eq. 15/16/20): everything a ``RoutingPolicy``
needs to decide, for every (query, model) pair.  The decision math and the
serving verbs live on ``repro.api.ScopeEngine`` — the legacy ``ScopeRouter``
/ ``RouterService`` shims were removed once every caller migrated to the
engine + policy surface.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.status import STATUS_OK


@dataclasses.dataclass
class PoolPredictions:
    """Pool-wide pre-hoc estimates for a query set (alpha-independent)."""
    models: List[str]
    p_hat: np.ndarray           # (Q, M) correctness confidence in [0,1]
    y_hat: np.ndarray           # (Q, M) binary labels
    len_hat: np.ndarray         # (Q, M) predicted completion tokens
    cost_hat: np.ndarray        # (Q, M) predicted $ per call
    well_formed: np.ndarray     # (Q, M) format gate
    pred_overhead: np.ndarray   # (Q, M) estimator tokens spent on this call
    sims: np.ndarray            # (Q, K) retrieval similarities
    idx: np.ndarray             # (Q, K) retrieved anchor ids
    cache_hits: int = 0         # pairs served from the PredictionCache
    cache_misses: int = 0       # pairs that ran the estimator
    status: Optional[np.ndarray] = None     # (Q, M) core.status codes;
    #                                         None -> all OK (batch path)
    tier0_answered: int = 0     # pairs answered by the tier-0 pre-router
    escalated: int = 0          # pairs the gate sent to the reasoning
    #                             decode (== cache_misses with a tier-0
    #                             head configured; 0 without one)

    @property
    def degraded_fraction(self) -> float:
        """Fraction of (query, model) pairs not answered by a full
        estimator decode (DEGRADED or FAILED)."""
        if self.status is None or self.status.size == 0:
            return 0.0
        return float((self.status != STATUS_OK).mean())
