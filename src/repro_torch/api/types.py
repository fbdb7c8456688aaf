"""Typed protocol of the public routing surface.

These dataclasses are the stable contract between callers and the
``ScopeEngine`` facade: a ``RouteRequest`` goes in, ``RouteDecision`` /
``BatchReport`` come out, and ``EngineConfig`` is the one input of
``ScopeEngine.build``.  The port's ``EngineConfig`` has the reference's
fields and defaults: the batch routing path, the streaming serve stack
(refill, paged KV, fault tolerance), two-tier routing and drift-aware
self-healing.
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
    from repro_torch.models.tier0 import Tier0Head
    from repro_torch.serving.faults import FaultPlan


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
    # streaming serve runtime (predict_stream / serve_stream)
    refill: bool = False            # segment-chunked mid-batch slot refill
    segment_len: int = 4            # decode steps per segment (refill)
    refill_horizon: Optional[int] = None    # decode-slot capacity in steps
    #                                         (None = 4x max_new_tokens)
    max_pending: Optional[int] = None       # in-flight microbatches in the
    #                                         ServeRuntime pipeline (None =
    #                                         1 if overlap else 0)
    # paged KV cache (refill path only): block-paged decode-cache pool
    # instead of the dense per-slot horizon — KV memory scales with live
    # tokens, admission gates on free pages
    kv_paged: bool = False
    kv_page_size: int = 16          # token positions per KV page
    kv_pool_pages: Optional[int] = None     # pool size in pages (None =
    #                                         auto-size to the opening
    #                                         bucket's worst case)
    kv_kernel: str = "xla"          # the reference's paged-attention names,
    #                                 "xla" or "pallas"; both run the CUDA
    #                                 kernel on the card and its plain
    #                                 version on the CPU
    # fault tolerance (stream paths): a failed microbatch / slot segment
    # requeues its rows and retries up to max_retries times (exponential
    # backoff from retry_backoff_s); rows that keep failing are
    # quarantined and answered from retrieval priors (degrade=True) or
    # marked FAILED.  deadline_ms bounds a request's queue + in-flight
    # age — past it the pair is answered degraded immediately.
    # fault_plan (serving.faults.FaultPlan) injects deterministic chaos;
    # None and FaultPlan.none() are identical no-ops.
    max_retries: int = 2
    retry_backoff_s: float = 0.0
    deadline_ms: Optional[float] = None
    degrade: bool = True
    fault_plan: Optional["FaultPlan"] = None
    # two-tier routing: a distilled pre-router head answers (query, model)
    # pairs whose calibrated confidence max(p, 1-p) clears
    # escalation_threshold in one head forward; only the remainder pays
    # the reasoning decode.  Thresholds <= 0.5 escalate nothing (conf is
    # always >= 0.5); thresholds > 1.0 escalate everything, identical to
    # tier0=None.  Tier-0 answers never enter the scheduler or the
    # in-flight dedup map, and their cache entries carry tier=0 so an
    # escalated decode overwrites them but never the reverse.
    tier0: Optional["Tier0Head"] = None
    escalation_threshold: float = 0.9
    # drift-aware self-healing (serving.feedback): with drift_detect on,
    # every executed (query, model) pair's (predicted, observed) outcome
    # lands in a bounded replay buffer and feeds a per-model Page–Hinkley
    # detector over the calibration residual p_hat - y.  On alarm the
    # model's cached predictions are demoted to DRIFTED (an OK write
    # after onboard(refresh=True) heals them), its serve-time status
    # columns are stamped DRIFTED, and DriftAwarePolicy can exclude or
    # down-weight it.  Collection is passive: with no model_drift fault
    # in the plan, detector-on serving is identical to detector-off
    # (predictions, cache contents, stats outside the drift block).
    # drift_threshold is the Page–Hinkley alarm mass (lambda),
    # drift_delta the per-observation drift allowance, drift_min_obs the
    # observations a model needs before it may alarm, feedback_capacity
    # the replay-buffer bound in rows; FeedbackMonitor validates them.
    drift_detect: bool = False
    drift_threshold: float = 5.0
    drift_delta: float = 0.05
    drift_min_obs: int = 8
    feedback_capacity: int = 4096


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
