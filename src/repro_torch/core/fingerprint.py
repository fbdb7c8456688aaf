"""Model fingerprinting over a fixed anchor set (SCOPE §3.1, Eq. 1).

A fingerprint phi_B(M) = {(x_i, y_i^M, c_i^M)} records a model's realized
correctness and token cost on every anchor query.  Onboarding a new model is
training-free: one pass over the anchor set (here: one batch of world-sim
interactions, standing in for one batch of API calls).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.data.worldsim import PoolModel, Query, World


@dataclasses.dataclass
class Fingerprint:
    model: str
    y: np.ndarray           # (N,) int — correctness on anchors
    tokens: np.ndarray      # (N,) int — completion tokens on anchors
    cost: np.ndarray        # (N,) float — $ per anchor

    def slice(self, idx: np.ndarray) -> "Fingerprint":
        return Fingerprint(self.model, self.y[idx], self.tokens[idx],
                           self.cost[idx])


@dataclasses.dataclass
class AnchorSet:
    queries: List[Query]
    embeddings: np.ndarray  # (N, d) retrieval embeddings

    def __len__(self):
        return len(self.queries)


def build_anchor_set(world: World, anchors: Sequence[Query]) -> AnchorSet:
    embs = np.stack([world.embed(q) for q in anchors])
    return AnchorSet(list(anchors), embs)


def build_fingerprint(world: World, model_name: str, anchor_set: AnchorSet,
                      seed: int = 0) -> Fingerprint:
    """One pass of model ``model_name`` over the anchor set."""
    rng = np.random.default_rng(seed)
    m = world.models[model_name]
    y, tokens, cost = [], [], []
    for q in anchor_set.queries:
        yi, ti, ci = world.sample_interaction(m, q, rng)
        y.append(yi)
        tokens.append(ti)
        cost.append(ci)
    return Fingerprint(model_name, np.asarray(y), np.asarray(tokens),
                       np.asarray(cost, np.float64))


class FingerprintLibrary:
    """The maintained fingerprint store: model name -> Fingerprint.

    Adding an unseen model never touches estimator weights — this is the
    mechanism behind SCOPE's training-free generalization (Table 1 OOD).
    """

    def __init__(self, anchor_set: AnchorSet):
        self.anchor_set = anchor_set
        self._store: Dict[str, Fingerprint] = {}

    def add(self, fp: Fingerprint) -> None:
        if len(fp.y) != len(self.anchor_set):
            raise ValueError("fingerprint/anchor size mismatch")
        self._store[fp.model] = fp

    def onboard(self, world: World, model_name: str, seed: int = 0) -> Fingerprint:
        fp = build_fingerprint(world, model_name, self.anchor_set, seed)
        self.add(fp)
        return fp

    def get(self, model: str) -> Fingerprint:
        return self._store[model]

    def models(self) -> List[str]:
        return list(self._store)

    def __contains__(self, model: str) -> bool:
        return model in self._store
