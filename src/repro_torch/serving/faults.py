"""Deterministic fault injection for the serve stack (chaos testing).

The port of ``repro/serving/faults.py`` (numpy only), unchanged.

A ``FaultPlan`` is an explicit list of ``FaultSpec``s, each naming a
*site* (which serve boundary) and an *event index* (the n-th time that
boundary is crossed).  A ``FaultInjector`` — one per stream — counts the
boundary crossings and fires the matching specs, so a plan replays
identically on identical traffic: no RNG is consulted at serve time.

Sites and their real boundaries:

  dispatch  — a whole-retire microbatch launch (``ServeRuntime``) raises
              ``InjectedFault`` instead of dispatching
  segment   — a slot-state segment launch (``SlotRuntime``) raises; the
              whole live state is torn down and its rows requeued
  parse     — a parse group returns garbage: every row is scrambled to a
              malformed generation (``well_formed=False``, ``p_conf=0.5``)
              and flows through the normal malformed-estimate machinery
  pool      — simulated ``KVPool`` exhaustion: the ``arg``-th live row of
              the current paged slot state takes a row-level failure at
              the segment boundary (pages released, row requeued)
  stall     — the injector's ``stall_offset`` clock jumps forward ``arg``
              seconds; only the engine's SLO-deadline check consults the
              offset, so queue-age statistics are unperturbed
  model_drift — the named ``model``'s observed outcomes are perturbed
              *persistently* from event index ``index`` on: once the spec
              fires, every later ``corrupt_outcome`` for that model forces
              the realized correctness to 0 and inflates the realized cost
              by ``1 + arg``.  Events are outcome observations (the
              engine's ``execute`` boundary), so "drifts at tick T" is
              "drifts at the K-th served query".  This is what the drift
              detector (``serving.feedback``) is tested against — a
              deployed model silently degrading mid-stream.

The **no-op default** (``FaultPlan.none()`` or no plan at all) must not
perturb the serve path: ``tick`` is a dict probe returning ``None`` and
``corrupt_parse`` returns the batch unchanged, so control flow, RNG
consumption, and every array shape are bit-identical to a build without
this module — the chaos smoke asserts exactly that.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

# model_drift is last: FaultPlan.seeded draws per site in tuple order, so
# appending keeps every older seeded plan's specs bit-identical
SITES = ("dispatch", "segment", "parse", "pool", "stall", "model_drift")


class InjectedFault(RuntimeError):
    """Raised at a serve boundary on behalf of a ``FaultSpec``."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned failure: the ``index``-th event at ``site`` fires.

    ``arg`` is site-specific: stall seconds for ``stall``, the live-row
    selector for ``pool``, the relative cost inflation for
    ``model_drift``, unused elsewhere.  ``model`` names the pool model a
    ``model_drift`` spec degrades (required there, unused elsewhere).
    """
    site: str
    index: int
    arg: float = 0.0
    model: str = ""

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(expected one of {SITES})")
        if self.index < 0:
            raise ValueError(f"fault index must be >= 0, got {self.index}")
        if self.site == "model_drift" and not self.model:
            raise ValueError("model_drift specs must name a model")


class FaultPlan:
    """An immutable set of ``FaultSpec``s, indexed by (site, event index).

    At most one spec per (site, index) — later duplicates are rejected so
    a plan reads back exactly as written.
    """

    def __init__(self, specs: Iterable[FaultSpec] = ()):
        self._by_site: Dict[str, Dict[int, FaultSpec]] = {}
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        for spec in self.specs:
            site = self._by_site.setdefault(spec.site, {})
            if spec.index in site:
                raise ValueError(
                    f"duplicate fault at ({spec.site!r}, {spec.index})")
            site[spec.index] = spec

    @classmethod
    def none(cls) -> "FaultPlan":
        """The asserted-no-op default: nothing ever fires."""
        return cls()

    @classmethod
    def seeded(cls, seed: int, *, n_events: int = 64,
               rates: Optional[Dict[str, float]] = None,
               stall_s: float = 0.0) -> "FaultPlan":
        """Bernoulli plan: each of the first ``n_events`` events at a site
        fires with that site's rate.  Deterministic in ``seed`` — the draw
        happens here, never at serve time."""
        if (rates or {}).get("model_drift"):
            raise ValueError(
                "model_drift cannot be rate-drawn (a spec must name the "
                "drifting model); add FaultSpec('model_drift', K, "
                "model=...) to the plan explicitly")
        # scopelint-torch: allow[serve-time-nondeterminism] -- build-time plan draw, deterministic in seed; serve time only replays it
        rng = np.random.default_rng(seed)
        specs = []
        for site in SITES:                      # fixed draw order
            rate = float((rates or {}).get(site, 0.0))
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"rate for {site!r} must be in [0, 1], "
                                 f"got {rate}")
            hits = rng.random(n_events) < rate
            for i in np.flatnonzero(hits):
                arg = stall_s if site == "stall" else float(i)
                specs.append(FaultSpec(site, int(i), arg))
        return cls(specs)

    def get(self, site: str, index: int) -> Optional[FaultSpec]:
        return self._by_site.get(site, {}).get(index)

    def __bool__(self) -> bool:
        return bool(self.specs)

    def __repr__(self) -> str:
        return f"FaultPlan({list(self.specs)!r})"


class FaultInjector:
    """Per-stream event counters over a ``FaultPlan``.

    ``tick(site)`` advances that site's event counter and returns the
    firing spec (or ``None``); ``raise_if(site)`` is the raising variant
    for the sites whose failure mode is an exception.  ``stall_offset``
    accumulates the seconds injected by fired ``stall`` specs — the
    engine's deadline clock adds it to the scheduler's real clock.
    """

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan if plan is not None else FaultPlan.none()
        self.counts: Dict[str, int] = {site: 0 for site in SITES}
        self.fired = 0
        self.stall_offset = 0.0
        # model -> cost inflation arg; set when a model_drift spec fires
        # and persistent from then on (the deployed model stays degraded
        # until the pool heals it out of band)
        self.drift_active: Dict[str, float] = {}

    def tick(self, site: str) -> Optional[FaultSpec]:
        i = self.counts[site]
        self.counts[site] = i + 1
        spec = self.plan.get(site, i)
        if spec is not None:
            self.fired += 1
            if site == "stall":
                self.stall_offset += float(spec.arg)
            elif site == "model_drift":
                self.drift_active[spec.model] = float(spec.arg)
        return spec

    def raise_if(self, site: str) -> None:
        spec = self.tick(site)
        if spec is not None:
            raise InjectedFault(f"injected {site} fault (event {spec.index})")

    def corrupt_outcome(self, model: str, y, tokens: int, cost: float
                        ) -> Tuple[float, int, float]:
        """One outcome-observation event: tick the ``model_drift`` counter
        (arming any spec whose index this event reaches) and, if drift is
        active for ``model``, degrade the observation — correctness forced
        to 0, cost inflated by ``1 + arg``.  With no plan this is a dict
        probe and an untouched return: bit-identical to no injector."""
        self.tick("model_drift")
        arg = self.drift_active.get(model)
        if arg is None:
            return y, tokens, cost
        return 0.0, tokens, float(cost) * (1.0 + arg)

    def corrupt_parse(self, batch):
        """One parse event: if the matching spec fires, scramble every row
        of the group to a malformed estimate.  The garbage flows through
        the normal malformed-prediction machinery (``well_formed=False``
        charges the pessimistic length fallback) — tokens were genuinely
        spent, so ``pred_tokens`` is kept."""
        spec = self.tick("parse")
        if spec is None or len(batch) == 0:
            return batch
        n = len(batch)
        return dataclasses.replace(
            batch,
            y_hat=np.zeros(n, int),
            len_hat=np.zeros(n, np.float64),
            well_formed=np.zeros(n, bool),
            p_conf=np.full(n, 0.5, np.float64),
            rationale_len=np.zeros(n, int))
