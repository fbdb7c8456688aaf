"""Router baselines the paper compares against (Table 1, Fig. 7).

Static: Random / Cheapest / Most-Expensive.
Supervised classifiers over query embeddings (trained on the same data as
SCOPE): KNN, MLP, Linear-hinge ("SVM").  Labels follow the oracle policy
(cheapest model that answers correctly; cheapest overall if none do).
Decision-rule baselines for the Fig. 7 ablation: augmented Chebyshev
scalarization and Highest-Cost-under-budget.  Plus test-time scaling (TTS):
execute every model, keep the best outcome (Fig. 9 token comparison).

The port of ``repro/core/baselines.py``.  The MLP and hinge routers train
with autograd and the port's AdamW on ``device`` (the card unless the
caller asks for the CPU); ``fit(..., init=...)`` takes the starting params
as numpy arrays, which a test hands to both sides, else they are drawn
from a ``torch.Generator`` seeded with ``seed``.  Predictions are numpy.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.utility import normalize_cost
from repro_torch.data.datasets import ScopeData
from repro_torch.data.worldsim import World
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, value_and_grad)


# ---------------------------------------------------------------------------
# Oracle / labels
# ---------------------------------------------------------------------------
def oracle_choice(data: ScopeData, qid: int, models: Sequence[str]) -> int:
    """Cheapest model that answers correctly; cheapest overall otherwise."""
    recs = [data.record(qid, m) for m in models]
    correct = [i for i, r in enumerate(recs) if r.y == 1]
    pool = correct if correct else range(len(models))
    return min(pool, key=lambda i: recs[i].cost)


def oracle_labels(data: ScopeData, qids: Sequence[int],
                  models: Sequence[str]) -> np.ndarray:
    return np.array([oracle_choice(data, int(q), models) for q in qids])


# ---------------------------------------------------------------------------
# Static baselines
# ---------------------------------------------------------------------------
def random_choices(n: int, num_models: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, num_models, n)


def price_rank_choice(world: World, models: Sequence[str],
                      highest: bool) -> int:
    prices = [world.models[m].price_out for m in models]
    return int(np.argmax(prices) if highest else np.argmin(prices))


# ---------------------------------------------------------------------------
# KNN router
# ---------------------------------------------------------------------------
class KNNRouter:
    def __init__(self, k: int = 8):
        self.k = k
        self._embs: Optional[np.ndarray] = None
        self._labels: Optional[np.ndarray] = None
        self.num_models = 0

    def fit(self, embs: np.ndarray, labels: np.ndarray, num_models: int):
        self._embs = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-8)
        self._labels = labels
        self.num_models = num_models

    def predict(self, embs: np.ndarray) -> np.ndarray:
        q = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-8)
        sims = q @ self._embs.T
        nn = np.argsort(-sims, axis=1)[:, : self.k]
        votes = self._labels[nn]                          # (Q, k)
        out = np.zeros(len(embs), int)
        for i, v in enumerate(votes):
            out[i] = np.bincount(v, minlength=self.num_models).argmax()
        return out


# ---------------------------------------------------------------------------
# Trained routers (autograd + AdamW, full batch)
# ---------------------------------------------------------------------------
def _init_params(init: Optional[Dict[str, np.ndarray]], shapes: Dict,
                 seed: int, dev: torch.device) -> Dict[str, torch.Tensor]:
    """``init`` as float32 tensors on ``dev``, checked against ``shapes``;
    without it, each ``("normal", shape, std)`` entry drawn in key order
    from a generator seeded with ``seed`` and each ``("zeros", shape)``
    zero."""
    if init is not None:
        if set(init) != set(shapes):
            raise ValueError(f"init keys {sorted(init)} != {sorted(shapes)}")
        out = {}
        for k, spec in shapes.items():
            arr = np.asarray(init[k], np.float32)
            if arr.shape != spec[1]:
                raise ValueError(f"init {k} {arr.shape} != {spec[1]}")
            out[k] = torch.tensor(arr, device=dev)
        return out
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for k, spec in shapes.items():
        if spec[0] == "normal":
            out[k] = torch.randn(spec[1], generator=gen, device=dev) * spec[2]
        else:
            out[k] = torch.zeros(spec[1], device=dev)
    return out


def _fit(loss_fn, params, ocfg: AdamWConfig, steps: int
         ) -> Dict[str, np.ndarray]:
    ostate = adamw_init(params)
    for _ in range(steps):
        _, _, grads = value_and_grad(lambda p: (loss_fn(p), {}), params)
        params, ostate = adamw_update(ocfg, grads, ostate, params)
    return {k: v.cpu().numpy() for k, v in params.items()}


class MLPRouter:
    def __init__(self, hidden: int = 64, steps: int = 400, lr: float = 1e-2,
                 seed: int = 0, device: DeviceLike = None):
        self.hidden = hidden
        self.steps = steps
        self.lr = lr
        self.seed = seed
        self.device = device
        self.params = None

    def fit(self, embs: np.ndarray, labels: np.ndarray, num_models: int, *,
            init: Optional[Dict[str, np.ndarray]] = None):
        dev = resolve_device(self.device)
        d = embs.shape[1]
        params = _init_params(init, {
            "w1": ("normal", (d, self.hidden), 1 / np.sqrt(d)),
            "b1": ("zeros", (self.hidden,)),
            "w2": ("normal", (self.hidden, num_models),
                   1 / np.sqrt(self.hidden)),
            "b2": ("zeros", (num_models,)),
        }, self.seed, dev)
        x = torch.tensor(np.asarray(embs, np.float32), device=dev)
        y = torch.tensor(np.asarray(labels), device=dev).long()
        ocfg = AdamWConfig(lr=self.lr, warmup_steps=10, total_steps=self.steps,
                           weight_decay=1e-4)

        def loss_fn(p):
            h = torch.tanh(x @ p["w1"] + p["b1"])
            lp = torch.log_softmax(h @ p["w2"] + p["b2"], dim=-1)
            return -torch.mean(torch.gather(lp, 1, y[:, None]))

        self.params = _fit(loss_fn, params, ocfg, self.steps)

    def predict(self, embs: np.ndarray) -> np.ndarray:
        p = self.params
        h = np.tanh(embs @ p["w1"] + p["b1"])
        return np.argmax(h @ p["w2"] + p["b2"], axis=1)


# ---------------------------------------------------------------------------
# Linear hinge router ("SVM")
# ---------------------------------------------------------------------------
class LinearSVMRouter:
    def __init__(self, steps: int = 400, lr: float = 5e-3, margin: float = 1.0,
                 seed: int = 0, device: DeviceLike = None):
        self.steps = steps
        self.lr = lr
        self.margin = margin
        self.seed = seed
        self.device = device
        self.params = None

    def fit(self, embs: np.ndarray, labels: np.ndarray, num_models: int, *,
            init: Optional[Dict[str, np.ndarray]] = None):
        dev = resolve_device(self.device)
        d = embs.shape[1]
        params = _init_params(init, {
            "w": ("normal", (d, num_models), 1 / np.sqrt(d)),
            "b": ("zeros", (num_models,)),
        }, self.seed, dev)
        x = torch.tensor(np.asarray(embs, np.float32), device=dev)
        y = torch.tensor(np.asarray(labels), device=dev).long()
        ocfg = AdamWConfig(lr=self.lr, warmup_steps=10, total_steps=self.steps,
                           weight_decay=1e-3)
        off_target = 1.0 - torch.nn.functional.one_hot(y, num_models).float()

        def loss_fn(p):
            scores = x @ p["w"] + p["b"]                   # (N, M)
            true = torch.gather(scores, 1, y[:, None])
            viol = torch.clamp(self.margin + scores - true, min=0.0)
            return torch.mean(torch.sum(viol * off_target, dim=1))

        self.params = _fit(loss_fn, params, ocfg, self.steps)

    def predict(self, embs: np.ndarray) -> np.ndarray:
        p = self.params
        return np.argmax(embs @ p["w"] + p["b"], axis=1)


# ---------------------------------------------------------------------------
# Decision-rule baselines over SCOPE's own predictions (Fig. 7 left)
# ---------------------------------------------------------------------------
def chebyshev_choices(p_hat: np.ndarray, cost_hat: np.ndarray, alpha: float,
                      rho: float = 0.05) -> np.ndarray:
    """Augmented Chebyshev scalarization (minimize the max weighted regret)."""
    Q, M = p_hat.shape
    out = np.zeros(Q, int)
    for q in range(Q):
        c = normalize_cost(cost_hat[q])
        t1 = alpha * (1.0 - p_hat[q])
        t2 = (1.0 - alpha) * c
        score = np.maximum(t1, t2) + rho * (t1 + t2)
        out[q] = int(np.argmin(score))
    return out


def highest_cost_choices(cost_hat: np.ndarray, per_query_budget: float
                         ) -> np.ndarray:
    """Always the most expensive model within the per-query budget."""
    Q, M = cost_hat.shape
    out = np.zeros(Q, int)
    for q in range(Q):
        ok = np.where(cost_hat[q] <= per_query_budget)[0]
        out[q] = int(ok[np.argmax(cost_hat[q][ok])]) if len(ok) \
            else int(np.argmin(cost_hat[q]))
    return out


# ---------------------------------------------------------------------------
# Test-time scaling (Fig. 9)
# ---------------------------------------------------------------------------
def tts_outcome(data: ScopeData, qid: int, models: Sequence[str]
                ) -> Tuple[int, int, float]:
    """Execute all models; pick best (correct, cheapest).  Returns
    (accuracy, total tokens executed, total $)."""
    recs = [data.record(qid, m) for m in models]
    tokens = sum(r.tokens for r in recs)
    cost = sum(r.cost for r in recs)
    acc = int(any(r.y == 1 for r in recs))
    return acc, tokens, cost
