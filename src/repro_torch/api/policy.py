"""Pluggable routing policies.

A ``RoutingPolicy`` turns pool-wide pre-hoc estimates into per-query model
choices.  The four shipped policies cover the paper's control scenarios —
fixed alpha (Eq. 15), set-level budget (Appendix D) — plus two new ones the
decomposition makes one-subclass cheap: an expected-accuracy floor and a
per-query cost ceiling.  New trade-off scenarios subclass ``RoutingPolicy``
instead of growing another kwarg on the serving entry point.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import TYPE_CHECKING, Any, Dict, Optional

import numpy as np

from repro_torch.core import alpha_search
from repro_torch.core.router import PoolPredictions

if TYPE_CHECKING:
    from repro_torch.api.engine import ScopeEngine


@dataclasses.dataclass
class PolicyDecision:
    """What a policy resolved for one batch: trade-off point + choices."""
    alpha: Optional[float]      # None when the policy is not alpha-shaped
    choices: np.ndarray         # (Q,) indices into pool.models
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)


class RoutingPolicy(abc.ABC):
    """Maps (pool predictions, engine) -> PolicyDecision."""

    name: str = "policy"

    @abc.abstractmethod
    def decide(self, pool: PoolPredictions, engine: "ScopeEngine"
               ) -> PolicyDecision:
        ...


class FixedAlphaPolicy(RoutingPolicy):
    """Route every query at one accuracy/cost trade-off point (Eq. 15)."""

    name = "fixed_alpha"

    def __init__(self, alpha: float, *, with_calibration: bool = True):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.with_calibration = with_calibration

    def decide(self, pool: PoolPredictions, engine: "ScopeEngine"
               ) -> PolicyDecision:
        u = engine.utilities(pool, self.alpha,
                             with_calibration=self.with_calibration)
        return PolicyDecision(self.alpha, np.argmax(u, axis=1))


class SetBudgetPolicy(RoutingPolicy):
    """Solve for alpha* under a set-level dollar budget (App. D, Prop. D.1).

    Degenerate budgets behave conservatively: below the cheapest routing
    the policy falls back to the cheapest candidate (``feasible=False`` in
    the decision info); above the most expensive it reduces to max expected
    accuracy.
    """

    name = "set_budget"

    def __init__(self, budget: float):
        if budget < 0.0:
            raise ValueError(f"budget must be >= 0, got {budget}")
        self.budget = float(budget)

    def decide(self, pool: PoolPredictions, engine: "ScopeEngine"
               ) -> PolicyDecision:
        p_hat, s_hat = engine.affine_scores(pool)
        alpha, choices, info = alpha_search.budget_alpha(
            p_hat, s_hat, pool.cost_hat, self.budget)
        info = dict(info, budget=self.budget)
        return PolicyDecision(alpha, choices, info)


class AccuracyFloorPolicy(RoutingPolicy):
    """Cheapest alpha whose *expected* mean accuracy clears a floor.

    Enumerates the same Prop. D.1 candidate set as the budget search, keeps
    the alphas with mean p_hat >= floor, and picks the one with minimum
    expected cost.  If no alpha clears the floor, falls back to the most
    accurate candidate (``feasible=False``).
    """

    name = "accuracy_floor"

    def __init__(self, floor: float):
        if not 0.0 <= floor <= 1.0:
            raise ValueError(f"floor must be in [0, 1], got {floor}")
        self.floor = float(floor)

    def decide(self, pool: PoolPredictions, engine: "ScopeEngine"
               ) -> PolicyDecision:
        p_hat, s_hat = engine.affine_scores(pool)
        rows = np.arange(p_hat.shape[0])
        cands = alpha_search.candidate_alphas(p_hat, s_hat)
        all_choices = alpha_search.route_for_alphas(p_hat, s_hat, cands)
        accs = p_hat[rows[None], all_choices].mean(axis=1)
        costs = pool.cost_hat[rows[None], all_choices].sum(axis=1)
        feas = np.flatnonzero(accs >= self.floor)
        feasible = bool(len(feas))
        if feasible:
            # cheapest feasible; ties by higher acc, then smallest alpha
            order = np.lexsort((np.arange(len(feas)), -accs[feas],
                                costs[feas]))
            i = int(feas[order[0]])
        else:
            # most accurate overall; ties by lower cost, then smallest alpha
            order = np.lexsort((np.arange(len(cands)), costs, -accs))
            i = int(order[0])
        return PolicyDecision(float(cands[i]), all_choices[i],
                              {"floor": self.floor, "feasible": feasible,
                               "expected_acc": float(accs[i]),
                               "expected_cost": float(costs[i])})


class CostCeilingPolicy(RoutingPolicy):
    """Per-query hard cost cap: never pick a model whose predicted cost
    exceeds the ceiling; route at ``alpha`` among the survivors.

    Queries where every model busts the cap fall back to the cheapest
    predicted model (counted in ``info['fallback_queries']``).
    """

    name = "cost_ceiling"

    def __init__(self, ceiling: float, *, alpha: float = 0.6,
                 with_calibration: bool = True):
        if ceiling <= 0.0:
            raise ValueError(f"ceiling must be > 0, got {ceiling}")
        self.ceiling = float(ceiling)
        self.alpha = float(alpha)
        self.with_calibration = with_calibration

    def decide(self, pool: PoolPredictions, engine: "ScopeEngine"
               ) -> PolicyDecision:
        u = engine.utilities(pool, self.alpha,
                             with_calibration=self.with_calibration)
        over = pool.cost_hat > self.ceiling
        u = np.where(over, -np.inf, u)
        choices = np.argmax(u, axis=1)
        all_over = over.all(axis=1)
        if all_over.any():
            choices = np.where(all_over, np.argmin(pool.cost_hat, axis=1),
                               choices)
        return PolicyDecision(self.alpha, choices,
                              {"ceiling": self.ceiling,
                               "capped_pairs": int(over.sum()),
                               "fallback_queries": int(all_over.sum())})


class DriftAwarePolicy(RoutingPolicy):
    """Quarantine-aware wrapper: route around drifted models.

    Reads the engine's ``FeedbackMonitor`` quarantine set and either
    removes the drifted models from the candidate pool before delegating
    to ``inner`` (``mode="exclude"``) or scales their p_hat down by
    ``1 - weight`` so the inner policy's own utility math deprioritizes
    them (``mode="downweight"`` — a drifted model can still win when
    nothing else is affordable).  With no monitor or an empty quarantine
    set the wrapper is a pass-through: the inner policy sees the pool
    unchanged, decision-identical to running unwrapped.  If *every* model
    is quarantined, excluding would leave nothing to route — the wrapper
    falls back to the full pool (``info["drift_all_quarantined"]``).
    """

    def __init__(self, inner: RoutingPolicy, *, mode: str = "exclude",
                 weight: float = 0.5):
        if mode not in ("exclude", "downweight"):
            raise ValueError(f"unknown mode {mode!r} "
                             "(expected 'exclude' or 'downweight')")
        if not 0.0 <= weight <= 1.0:
            raise ValueError(f"weight must be in [0, 1], got {weight}")
        self.inner = inner
        self.mode = mode
        self.weight = float(weight)
        self.name = f"drift_aware({inner.name})"

    def decide(self, pool: PoolPredictions, engine: "ScopeEngine"
               ) -> PolicyDecision:
        monitor = getattr(engine, "monitor", None)
        drifted = (monitor.drifted if monitor is not None else set())
        hit = [m for m in pool.models if m in drifted]
        if not hit:
            return self.inner.decide(pool, engine)
        if self.mode == "downweight":
            mask = np.asarray([m in drifted for m in pool.models])
            p = np.where(mask[None, :], pool.p_hat * (1.0 - self.weight),
                         pool.p_hat)
            decision = self.inner.decide(
                dataclasses.replace(pool, p_hat=p), engine)
            decision.info["drift_downweighted"] = hit
            return decision
        keep = np.asarray([i for i, m in enumerate(pool.models)
                           if m not in drifted], int)
        if len(keep) == 0:
            decision = self.inner.decide(pool, engine)
            decision.info["drift_all_quarantined"] = True
            return decision
        sliced = dataclasses.replace(
            pool,
            models=[pool.models[i] for i in keep],
            p_hat=pool.p_hat[:, keep], y_hat=pool.y_hat[:, keep],
            len_hat=pool.len_hat[:, keep], cost_hat=pool.cost_hat[:, keep],
            well_formed=pool.well_formed[:, keep],
            pred_overhead=pool.pred_overhead[:, keep],
            status=(None if pool.status is None else pool.status[:, keep]))
        decision = self.inner.decide(sliced, engine)
        # remap the inner policy's column choices back into the full pool
        decision.choices = keep[np.asarray(decision.choices, int)]
        decision.info["drift_excluded"] = hit
        return decision
