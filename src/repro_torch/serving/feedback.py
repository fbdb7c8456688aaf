"""Outcome ledger + drift detection for self-healing serving.

The port of ``repro/serving/feedback.py`` (numpy only), unchanged.

SCOPE's estimates are conditioned on a model's *fingerprint* — a frozen
snapshot of its behavior on the anchor set.  When the deployed model
silently degrades, predictions keep flowing from the stale snapshot and
nothing in the serve stack notices.  This module closes that gap from
served traffic alone:

  ``Outcome``        — one served (query, model) pair: what the router
                       predicted vs. what the world returned, plus the
                       retrieval context (sims/idx) captured at decision
                       time so the observation can later be scattered back
                       onto anchors.
  ``ReplayBuffer``   — bounded FIFO ledger of outcomes (the oldest rows
                       fall off; capacity bounds both memory and how far
                       back a refresh looks).
  ``PageHinkley``    — sequential change detector over the calibration
                       residual ``predicted_p - observed_y``.  Under a
                       calibrated estimator the residual is ~zero-mean;
                       a drifted model pushes it persistently positive
                       (the router keeps predicting the old success rate).
  ``FeedbackMonitor``— per-model detectors + the buffer + the quarantine
                       set, and the refresh path: synthesize a new
                       ``Fingerprint`` from the buffer's observed outcomes
                       (similarity-weighted scatter onto the anchors,
                       blended with the old fingerprint where no
                       observations landed).

Everything here is deterministic: no RNG, no ambient clock (the row
timestamp comes from the injectable ``clock``), pure host arithmetic on
the serve hot path.

Page–Hinkley, per model, over residuals x_t = predicted_p - observed_y:

  mean_t = mean(x_1..x_t)                      (running)
  m_t    = m_{t-1} + x_t - mean_t - delta      (cumulative drift mass)
  M_t    = min(M_{t-1}, m_t)
  alarm  when  t >= min_obs  and  m_t - M_t > threshold

``delta`` absorbs benign calibration wobble; ``threshold`` is the total
residual mass a model must accumulate above its own running mean before
the alarm fires.  The residual is Bernoulli-noisy (y is 0/1, so single
rows swing ~±0.5 even under perfect calibration) and real traffic
arrives with run structure — a calibrated model's drift mass oscillates
but stays *bounded* by the length of its overconfident runs, while a
genuinely drifted model accumulates ~``p_hat`` per observation without
bound.  The default threshold of 5.0 rides above the bounded clean
oscillation and still fires within a dozen or so drifted observations;
deployments that want faster alarms on trusted-calibration pools can
lower it.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.fingerprint import Fingerprint


@dataclasses.dataclass(frozen=True)
class Outcome:
    """One served pair: prediction vs. observation + retrieval context."""
    query_id: int               # content-derived key (api.cache.query_key)
    model: str
    predicted_p: float          # p_hat of the chosen pair at decision time
    predicted_cost: float       # cost_hat ($) of the chosen pair
    observed_y: float           # realized correctness (post-fault)
    observed_cost: float        # realized $ (post-fault)
    observed_tokens: int        # realized completion tokens
    sims: np.ndarray            # (K,) retrieval similarities at decision
    idx: np.ndarray             # (K,) retrieved anchor ids
    t: float = 0.0              # monitor clock at observation
    well_formed: bool = True    # estimator row parsed (p_hat is a real
                                # prediction, not the 0.5 parse fallback)

    @property
    def residual(self) -> float:
        """Calibration residual: positive when the router was overconfident."""
        return float(self.predicted_p) - float(self.observed_y)


class ReplayBuffer:
    """Bounded FIFO of ``Outcome`` rows (oldest fall off at capacity)."""

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self.capacity = int(capacity)
        self._rows: Deque[Outcome] = deque(maxlen=self.capacity)

    def __len__(self) -> int:
        return len(self._rows)

    def append(self, row: Outcome) -> None:
        self._rows.append(row)

    def rows(self, model: Optional[str] = None) -> List[Outcome]:
        if model is None:
            return list(self._rows)
        return [r for r in self._rows if r.model == model]

    def residuals(self, model: Optional[str] = None) -> np.ndarray:
        return np.asarray([r.residual for r in self.rows(model)],
                          np.float64)


class PageHinkley:
    """One-sided Page–Hinkley test for an upward shift in residual mean."""

    def __init__(self, *, delta: float = 0.05, threshold: float = 5.0,
                 min_obs: int = 8):
        if threshold <= 0.0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        if min_obs < 1:
            raise ValueError(f"min_obs must be >= 1, got {min_obs}")
        self.delta = float(delta)
        self.threshold = float(threshold)
        self.min_obs = int(min_obs)
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.mean = 0.0
        self.m = 0.0            # cumulative drift mass
        self.m_min = 0.0

    @property
    def score(self) -> float:
        """Current drift mass above the historical minimum."""
        return self.m - self.m_min

    def update(self, x: float) -> bool:
        """Feed one residual; returns True when the alarm fires."""
        self.n += 1
        self.mean += (x - self.mean) / self.n
        self.m += x - self.mean - self.delta
        self.m_min = min(self.m_min, self.m)
        return self.n >= self.min_obs and self.score > self.threshold


class FeedbackMonitor:
    """Replay buffer + per-model drift detectors + quarantine set.

    ``observe`` is the single serve-path entry point: append the outcome,
    update the model's detector, and return the model's name iff this
    observation newly tripped its alarm (the engine demotes the model's
    cached predictions on that signal).  A drifted model keeps
    accumulating outcomes — they are exactly what ``refresh_fingerprint``
    heals from — but never re-alarms until ``clear`` resets it (after
    ``onboard(refresh=True)``).

    Collection is passive by construction: ``observe`` writes only monitor
    state, never predictions or the cache, so with no alarm the serve path
    is bit-identical to running without a monitor.
    """

    def __init__(self, *, capacity: int = 4096, delta: float = 0.05,
                 threshold: float = 5.0, min_obs: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        self.buffer = ReplayBuffer(capacity)
        self._mk = lambda: PageHinkley(delta=delta, threshold=threshold,
                                       min_obs=min_obs)
        self._detectors: Dict[str, PageHinkley] = {}
        self.drifted: Set[str] = set()
        self.alarms = 0                 # total alarm events (monotonic)
        self._clock = clock

    def detector(self, model: str) -> PageHinkley:
        det = self._detectors.get(model)
        if det is None:
            det = self._detectors[model] = self._mk()
        return det

    def observe(self, row: Outcome) -> Optional[str]:
        """Record one served outcome; returns the model name on a *new*
        alarm, else None.

        Malformed rows are buffered (their observed outcomes are real and
        feed the refresh) but never scored: the parse-fallback ``p_hat``
        of 0.5 is not a calibration claim, and its ±0.5 residual noise
        would false-alarm the detector on clean traffic.
        """
        if row.t == 0.0:
            row = dataclasses.replace(row, t=self._clock())
        self.buffer.append(row)
        if not row.well_formed:
            return None
        fired = self.detector(row.model).update(row.residual)
        if fired and row.model not in self.drifted:
            self.drifted.add(row.model)
            self.alarms += 1
            return row.model
        return None

    def clear(self, model: str) -> None:
        """Heal a model after re-fingerprinting: reset its detector (the
        old residuals were measured against the stale fingerprint) and
        lift its quarantine."""
        self.drifted.discard(model)
        det = self._detectors.get(model)
        if det is not None:
            det.reset()

    def residual_percentiles(self) -> Tuple[float, float]:
        """(p50, p95) of absolute calibration residuals over the buffer."""
        if not len(self.buffer):
            return 0.0, 0.0
        a = np.abs(self.buffer.residuals())
        return (float(np.percentile(a, 50)), float(np.percentile(a, 95)))

    # -- refresh path ---------------------------------------------------
    def can_refresh(self, model: str, *, min_rows: int = 1) -> bool:
        return len(self.buffer.rows(model)) >= min_rows

    def refresh_fingerprint(self, model: str, library,
                            *, prior_strength: float = 1.0) -> Fingerprint:
        """Synthesize a fingerprint for ``model`` from the buffer's
        observed outcomes — no offline dataset, no world pass.

        Each outcome row is scattered onto its retrieved anchors with its
        decision-time similarity weights; per anchor the observed
        y/tokens/cost are similarity-weighted means.  Where little or no
        observation mass landed, the old fingerprint's value carries
        through a mass-proportional blend ``w / (w + prior_strength)`` —
        served traffic rarely covers every anchor, and an anchor nobody
        queried near has learned nothing new.  The result has full anchor
        length, so ``FingerprintLibrary.add`` accepts it unchanged.
        """
        rows = self.buffer.rows(model)
        if not rows:
            raise ValueError(
                f"no replay-buffer outcomes for model {model!r}; serve "
                "traffic through it first or refresh offline")
        old = library.get(model)
        n = len(library.anchor_set)
        mass = np.zeros(n, np.float64)
        y_acc = np.zeros(n, np.float64)
        tok_acc = np.zeros(n, np.float64)
        cost_acc = np.zeros(n, np.float64)
        for r in rows:
            w = np.clip(np.asarray(r.sims, np.float64), 0.0, None)
            a = np.asarray(r.idx, int)
            np.add.at(mass, a, w)
            np.add.at(y_acc, a, w * float(r.observed_y))
            np.add.at(tok_acc, a, w * float(r.observed_tokens))
            np.add.at(cost_acc, a, w * float(r.observed_cost))
        seen = mass > 0.0
        obs_y = np.where(seen, y_acc / np.where(seen, mass, 1.0), 0.0)
        obs_tok = np.where(seen, tok_acc / np.where(seen, mass, 1.0), 0.0)
        obs_cost = np.where(seen, cost_acc / np.where(seen, mass, 1.0), 0.0)
        blend = mass / (mass + float(prior_strength))
        y = blend * obs_y + (1.0 - blend) * np.asarray(old.y, np.float64)
        tokens = blend * obs_tok + \
            (1.0 - blend) * np.asarray(old.tokens, np.float64)
        cost = blend * obs_cost + \
            (1.0 - blend) * np.asarray(old.cost, np.float64)
        return Fingerprint(model, y, np.round(tokens).astype(int),
                           cost.astype(np.float64))
