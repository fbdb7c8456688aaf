"""SCOPE-60K / SCOPE-250 style dataset construction over the world sim.

``build_scope_data`` produces the (query, model, y, tokens, cost) interaction
corpus (SCOPE-60K analogue, size configurable); ``stratified_anchors``
produces the compact anchor set whose domain composition mirrors the full
corpus (SCOPE-250, Fig. 15).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.worldsim import (
    DOMAIN_WEIGHTS, NUM_DOMAINS, PoolModel, Query, World)


@dataclasses.dataclass
class Interaction:
    qid: int
    model: str
    y: int
    tokens: int
    cost: float


@dataclasses.dataclass
class ScopeData:
    world: World
    queries: List[Query]
    models: List[str]
    records: Dict[Tuple[int, str], Interaction]
    train_qids: np.ndarray
    test_qids: np.ndarray

    def record(self, qid: int, model: str) -> Interaction:
        return self.records[(qid, model)]

    def extend_models(self, names: Sequence[str], *, seed: int = 0) -> None:
        """Sample interactions for newly onboarded models over the existing
        query set — the world-sim analogue of serving them live."""
        rng = np.random.default_rng(seed)
        for name in names:
            if name in self.models:
                continue
            m = self.world.models[name]
            for q in self.queries:
                y, tokens, cost = self.world.sample_interaction(m, q, rng)
                self.records[(q.qid, name)] = Interaction(q.qid, name, y,
                                                          tokens, cost)
            self.models.append(name)


def build_scope_data(world: World, *, n_queries: int = 2000,
                     models: Optional[Sequence[str]] = None,
                     test_frac: float = 0.05, seed: int = 0,
                     difficulty_shift: float = 0.0) -> ScopeData:
    """Sample the interaction corpus for the given model pool."""
    names = list(models) if models is not None else [
        m.name for m in world.pool if m.seen]
    rng = np.random.default_rng(seed + 1)
    queries = world.sample_queries(n_queries, seed=seed + 2,
                                   difficulty_shift=difficulty_shift)
    records: Dict[Tuple[int, str], Interaction] = {}
    for q in queries:
        for name in names:
            m = world.models[name]
            y, tokens, cost = world.sample_interaction(m, q, rng)
            records[(q.qid, name)] = Interaction(q.qid, name, y, tokens, cost)
    qids = np.arange(n_queries)
    rng.shuffle(qids)
    n_test = max(1, int(n_queries * test_frac))
    return ScopeData(world, queries, names, records,
                     train_qids=np.sort(qids[n_test:]),
                     test_qids=np.sort(qids[:n_test]))


def stratified_anchors(world: World, n: int = 250, seed: int = 7
                       ) -> List[Query]:
    """Anchor queries whose domain mix mirrors DOMAIN_WEIGHTS (Fig. 15)."""
    rng = np.random.default_rng(seed)
    weights = DOMAIN_WEIGHTS / DOMAIN_WEIGHTS.sum()
    counts = np.floor(weights * n).astype(int)
    while counts.sum() < n:
        counts[int(rng.integers(NUM_DOMAINS))] += 1
    anchors: List[Query] = []
    pool = world.sample_queries(n * 8, seed=seed + 1)
    by_domain: Dict[int, List[Query]] = {d: [] for d in range(NUM_DOMAINS)}
    for q in pool:
        by_domain[q.domain].append(q)
    qid = 0
    for d in range(NUM_DOMAINS):
        take = by_domain[d][: counts[d]]
        for q in take:
            anchors.append(Query(qid, q.domain, q.difficulty, q.embedding))
            qid += 1
    return anchors


def ood_queries(world: World, n: int = 250, seed: int = 11) -> List[Query]:
    """Frontier-difficulty OOD queries (AIME/HLE analogue)."""
    return world.sample_queries(n, difficulty_shift=0.9, seed=seed)
