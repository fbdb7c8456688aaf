"""repro_torch.api — the public SCOPE routing surface.

  ScopeEngine      — facade owning estimator, retriever, library, and pool
  EngineConfig     — the one typed input of ``ScopeEngine.build``
  PoolRegistry     — live pool: add_model / remove_model / onboard
  RoutingPolicy    — pluggable decision policies (subclass to extend)
  PredictionCache  — (query_id, model, estimator_version) -> estimate
"""
from repro_torch.api.cache import CachedPrediction, CacheStats, PredictionCache
from repro_torch.api.engine import ScopeEngine
from repro_torch.api.policy import (
    AccuracyFloorPolicy, CostCeilingPolicy, DriftAwarePolicy,
    FixedAlphaPolicy, PolicyDecision, RoutingPolicy, SetBudgetPolicy)
from repro_torch.api.registry import PoolRegistry
from repro_torch.api.types import (
    BatchReport, EngineConfig, PoolPredictions, RouteDecision, RouteRequest)

__all__ = [
    "AccuracyFloorPolicy",
    "BatchReport",
    "CacheStats",
    "CachedPrediction",
    "CostCeilingPolicy",
    "DriftAwarePolicy",
    "EngineConfig",
    "FixedAlphaPolicy",
    "PolicyDecision",
    "PoolPredictions",
    "PoolRegistry",
    "PredictionCache",
    "RouteDecision",
    "RouteRequest",
    "RoutingPolicy",
    "ScopeEngine",
    "SetBudgetPolicy",
]
