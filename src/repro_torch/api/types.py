"""Typed protocol of the public routing surface.

These dataclasses are the stable contract between callers and the
``ScopeEngine`` facade: a ``RouteRequest`` goes in, ``RouteDecision`` /
``BatchReport`` come out, and ``EngineConfig`` is the one input of
``ScopeEngine.build``.
The port's ``EngineConfig`` carries the fields the batch routing path reads;
the streaming, fault, tier-0 and drift knobs arrive with their slices.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.router import PoolPredictions  # noqa: F401  (re-export)
from repro_torch.data.worldsim import Query

if TYPE_CHECKING:                               # components, no runtime cycle
    from repro_torch.api.registry import PoolRegistry
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.core.fingerprint import FingerprintLibrary
    from repro_torch.core.retrieval import AnchorRetriever
    from repro_torch.data.worldsim import PoolModel


@dataclasses.dataclass
class EngineConfig:
    """Everything ``ScopeEngine.build`` needs: owned components + knobs.

    Exactly one of ``registry`` / ``models_meta`` describes the pool;
    ``models_meta`` is the legacy dict form and is wrapped in a fresh
    ``PoolRegistry`` by ``ScopeEngine.build``.
    """
    estimator: "ReasoningEstimator"
    retriever: "AnchorRetriever"
    library: "FingerprintLibrary"
    registry: Optional["PoolRegistry"] = None
    models_meta: Optional[Dict[str, "PoolModel"]] = None
    # router hyper-parameters (SCOPE Eq. 12-15)
    k: int = 5
    gamma_base: float = 1.0
    beta: float = 2.0
    w_base: float = 0.2
    use_confidence: bool = True
    # prediction cache
    estimator_version: str = "v0"
    enable_cache: bool = True
    cache_capacity: Optional[int] = None


@dataclasses.dataclass
class RouteRequest:
    """A batch of queries to route.

    ``models`` defaults to the engine's full registered pool; ``query_embs``
    may carry precomputed retrieval embeddings (one row per query).
    """
    queries: List[Query]
    models: Optional[Sequence[str]] = None
    query_embs: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.queries)


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """One routed query: which model, under what trade-off, at what estimate."""
    query_id: int
    model: str
    alpha: Optional[float]
    p_hat: float                # estimator's P(correct) for the chosen model
    cost_hat: float             # predicted $ for the chosen model
    status: str = "OK"          # how the chosen pair was estimated
    #                             (core.status: OK / DEGRADED / FAILED)


@dataclasses.dataclass
class BatchReport:
    """Outcome of routing (and optionally executing) one request batch."""
    policy: str
    alpha: Optional[float]
    decisions: List[RouteDecision]
    accuracy: float             # realized on execution, expected otherwise
    total_cost: float
    exec_tokens: int
    overhead_tokens: int        # estimator tokens spent on *this* call
    per_model_share: Dict[str, float]
    cache_hits: int = 0
    cache_misses: int = 0
    executed: bool = True
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def choices(self) -> np.ndarray:
        return np.asarray([d.model for d in self.decisions])

    @property
    def n_queries(self) -> int:
        return len(self.decisions)

    @classmethod
    def empty(cls, policy: str, models: Sequence[str]) -> "BatchReport":
        return cls(policy=policy, alpha=None, decisions=[], accuracy=0.0,
                   total_cost=0.0, exec_tokens=0, overhead_tokens=0,
                   per_model_share={m: 0.0 for m in models},
                   executed=False, info={"empty": True})
