"""``ScopeEngine`` — the public entry point for SCOPE routing.

The engine owns the components the paper's pipeline needs at serve time
(reasoning estimator, anchor retriever, fingerprint library, model pool)
and exposes the routing surface as four verbs:

  predict  — cache-aware pool-wide pre-hoc estimation (Eq. 5, Eq. 24)
  route    — apply a ``RoutingPolicy`` to a request, report expected metrics
  serve    — route + execute against a ``ScopeData`` world, report realized
  onboard  — training-free pool growth (fingerprint pass, §3.1)

plus their streaming duals for continuous traffic:

  predict_stream — drain an iterator of requests through the bucketed
                   microbatch scheduler (``serving.scheduler``), whole-retire
                   (``ServeRuntime``) or segment-chunked with slot refill
                   (``SlotRuntime``, dense or block-paged KV)
  serve_stream   — predict_stream + per-tick policy decision + execution

``predict`` consults the ``PredictionCache`` keyed by
``(query_id, model, estimator_version)`` and runs the estimator only for the
missing (query, model) pairs.  This is ``repro/api/engine.py`` with the same
math step for step: fault tolerance (retry, quarantine, deadlines,
degradation to tier-0 answers and retrieval priors), two-tier routing (a
tier-0 head on the card answers confident pairs, the rest escalate to the
reasoning decode), and drift-aware self-healing (an outcome monitor that
alarms, quarantines and heals, and a live estimator hot-swap).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import (
    Any, Deque, Dict, Iterable, Iterator, List, Optional,
    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.api.cache import CachedPrediction, PredictionCache, query_key
from repro_torch.api.policy import PolicyDecision, RoutingPolicy
from repro_torch.api.registry import PoolRegistry
from repro_torch.api.types import (
    BatchReport, EngineConfig, RouteDecision, RouteRequest)
from repro_torch.core import calibration, serialization, utility
from repro_torch.core.estimator import FallbackEstimator, ParsedBatch
from repro_torch.core.fingerprint import Fingerprint
from repro_torch.core.router import PoolPredictions
from repro_torch.core.status import (
    STATUS_DEGRADED, STATUS_DRIFTED, STATUS_OK, status_name)
from repro_torch.data.datasets import ScopeData
from repro_torch.data.worldsim import PoolModel, World
from repro_torch.models.tier0 import pair_features
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.feedback import FeedbackMonitor, Outcome
from repro_torch.serving.kv_pool import KVPool, check_kv_kernel
from repro_torch.serving.runtime import ServeRuntime, SlotRuntime
from repro_torch.serving.scheduler import MicrobatchScheduler

FALLBACK_LEN_HAT = 512.0    # tokens charged when the estimate is malformed

_UNSET = object()           # hot_swap: "caller passed no tier-0 head"


@dataclasses.dataclass
class _PredictState:
    """Per-request prediction state between cache probe and assembly."""
    models: List[str]
    queries: List
    qkeys: List[int]
    sims: np.ndarray            # (Q, K)
    idx: np.ndarray             # (Q, K)
    hit: np.ndarray             # (Q, M) bool — cache probe result
    y_hat: np.ndarray
    len_hat: np.ndarray
    wf: np.ndarray
    p_conf: np.ndarray
    prompt_tok: np.ndarray
    missing: np.ndarray         # (n, 2) row-major (query, model) misses
    prompts: List[List[int]]    # serialized prompt per missing pair
    use_cache: bool
    status: Optional[np.ndarray] = None     # (Q, M) core.status codes
    # two-tier gate outcome: after ``_gate_tier0`` runs, ``missing`` /
    # ``prompts`` hold only the escalated pairs; answered pairs were
    # scattered into the prediction columns directly.  ``t0_rows`` keeps
    # the escalated pairs' tier-0 (p, len_hat, y_hat) so a quarantined or
    # expired escalation degrades to the head's answer, not the retrieval
    # prior.
    tier0_answered: int = 0
    escalated: int = 0
    t0_rows: Optional[Dict[int, Tuple[float, float, int]]] = None


class _StreamEntry:
    """One in-flight stream request: collects estimator rows as the
    scheduler's microbatches land, in ``missing``-pair order."""

    def __init__(self, state: _PredictState):
        self.state = state
        n = len(state.prompts)
        self.remaining = n
        self.y_hat = np.zeros(n, int)
        self.len_hat = np.zeros(n, np.float64)
        self.well_formed = np.zeros(n, bool)
        self.p_conf = np.zeros(n, np.float64)
        self.pred_tokens = np.zeros(n, int)
        self.rationale_len = np.zeros(n, int)
        self.status = np.full(n, STATUS_OK, np.int8)

    def fill(self, i: int, batch, row: int, *, shared: bool = False) -> None:
        """``shared=True`` marks a pair that rode an in-flight duplicate's
        generation: it copies the estimate but spends no new tokens."""
        self.y_hat[i] = batch.y_hat[row]
        self.len_hat[i] = batch.len_hat[row]
        self.well_formed[i] = batch.well_formed[row]
        self.p_conf[i] = batch.p_conf[row]
        self.pred_tokens[i] = 0 if shared else batch.pred_tokens[row]
        self.rationale_len[i] = batch.rationale_len[row]
        self.status[i] = batch.status[row]
        self.remaining -= 1

    def parsed(self) -> ParsedBatch:
        return ParsedBatch(self.y_hat, self.len_hat, self.well_formed,
                           self.p_conf, self.pred_tokens, self.rationale_len,
                           status=self.status)


def _mb_rows(mb) -> List[Tuple[Any, List[int]]]:
    """(tag, prompt) per real row of a failed microbatch, for requeue."""
    return [(mb.tags[r], mb.tokens[r, : mb.lengths[r]].tolist())
            for r in range(mb.n_real)]


class _StreamControl:
    """Per-stream fault tolerance: bounded retry/requeue, quarantine, SLO
    deadlines, and degraded answers from tier-0 rows or retrieval priors.

    One instance per ``predict_stream`` call.  It owns the stream's
    ``FaultInjector`` (a no-op without an ``EngineConfig.fault_plan``) and
    the per-prompt failure ledger: ``attempts`` counts failures per
    in-flight dedup key, ``unresolved`` is the ordered set of keys whose
    waiters have not been answered yet, ``t_submit``/``n_prompt`` back the
    deadline check and late cache writes.  Exactly-once delivery is the
    invariant everything here preserves: a key leaves ``unresolved`` the
    moment its waiters are filled — by a real parse (``note_resolved`` via
    ``_stream_fill``) or by ``degrade`` — and every later event on that
    key (a requeue race, a late parse of an expired row) only touches the
    cache, never the waiters.
    """

    def __init__(self, engine: "ScopeEngine", sched, inflight: Dict,
                 use_cache: bool):
        cfg = engine.config
        self.engine = engine
        self.sched = sched
        self.inflight = inflight
        self.use_cache = use_cache
        self.injector = FaultInjector(cfg.fault_plan)
        self.max_retries = int(cfg.max_retries)
        self.backoff_s = float(cfg.retry_backoff_s)
        self.deadline_s = (None if cfg.deadline_ms is None
                           else float(cfg.deadline_ms) / 1e3)
        self.fallback = FallbackEstimator(engine.library)
        self.attempts: Dict[Any, int] = {}
        self.t_submit: Dict[Any, float] = {}
        self.n_prompt: Dict[Any, int] = {}
        self.unresolved: Dict[Any, bool] = {}   # insertion-ordered set
        # escalated pairs' stashed tier-0 (p, len_hat, y_hat), keyed with
        # their submit-time estimator version: the degrade ladder prefers
        # the head's answer over the retrieval prior
        self.t0_rows: Dict[Any, Tuple[str, Tuple[float, float, int]]] = {}
        self.sleep = time.sleep                 # injectable in tests

    def now(self) -> float:
        """Deadline time base: the scheduler's (injectable) clock plus the
        seconds injected by fired ``stall`` faults."""
        return self.sched.now() + self.injector.stall_offset

    # -- ledger --------------------------------------------------------
    def note_submit(self, key, prompt) -> None:
        """A key was scheduled (fresh, or fresh again after an earlier
        resolution): reset its deadline epoch and failure budget."""
        self.t_submit[key] = self.now()
        self.n_prompt[key] = len(prompt)
        self.attempts.pop(key, None)
        self.unresolved[key] = True

    def note_resolved(self, key) -> None:
        self.unresolved.pop(key, None)

    def prompt_tokens(self, key) -> int:
        return self.n_prompt.get(key, 0)

    # -- injection hooks ------------------------------------------------
    def pre_dispatch(self) -> None:
        """Microbatch-launch boundary: one stall event, one dispatch event."""
        self.injector.tick("stall")
        self.injector.raise_if("dispatch")

    def corrupt(self, batch):
        return self.injector.corrupt_parse(batch)

    # -- bounded retry / quarantine --------------------------------------
    def on_failed(self, rows, exc: Optional[Exception] = None) -> None:
        """Route one failure event's rows (``[(key, prompt)]``) back into
        the scheduler, quarantining rows past their retry budget.  Keys no
        longer unresolved (already answered degraded — e.g. a deadline
        expiry racing the in-flight decode) are dropped: their requests
        were served exactly once already."""
        stats = self.sched.stats
        stats.retries += 1
        worst = 0
        for key, prompt in rows:
            if key not in self.unresolved:
                continue
            n = self.attempts.get(key, 0) + 1
            self.attempts[key] = n
            if n <= self.max_retries:
                worst = max(worst, n)
                self.sched.requeue(key, prompt)
            else:
                stats.quarantined += 1
                self.degrade(key)
        if worst and self.backoff_s > 0.0:
            self.sleep(self.backoff_s * (2 ** (worst - 1)))

    def on_failed_mb(self, mb, exc: Optional[Exception] = None) -> None:
        self.on_failed(_mb_rows(mb), exc)

    # -- SLO deadlines ----------------------------------------------------
    def expire(self) -> None:
        """Answer every unresolved key past its deadline in degraded mode.
        Queued rows are cancelled outright; in-flight rows keep decoding
        and their late parse heals the cache entry."""
        if self.deadline_s is None or not self.unresolved:
            return
        now = self.now()
        for key in list(self.unresolved):
            if now - self.t_submit[key] < self.deadline_s:
                continue
            self.sched.cancel(key)
            self.sched.stats.deadline_expired += 1
            self.degrade(key)

    # -- graceful degradation ---------------------------------------------
    def degrade(self, key) -> None:
        """Answer every waiter on ``key`` in degraded mode and resolve the
        key.  The fallback ladder: the pair's stashed tier-0 answer (an
        escalation that never completed its decode still has the head's
        calibrated estimate), then retrieval priors, then FAILED when
        ``EngineConfig.degrade`` is off.  All waiters share one fallback
        row — they are the same (query, model) content by construction of
        the dedup key."""
        waiters = self.inflight.pop(key, None)
        self.note_resolved(key)
        if not waiters:
            return
        cfg = self.engine.config
        stats = self.sched.stats
        owner, miss_i = waiters[0]
        st = owner.state
        qi, mi = st.missing[miss_i]
        tier = 1
        stash = self.t0_rows.get(key) if cfg.degrade else None
        if stash is not None and stash[0] != cfg.estimator_version:
            # stashed at submit time under a since-swapped estimator: the
            # old head's answer is miscalibrated for the new version — fall
            # through to the retrieval-prior rung (exactly-once unchanged)
            stash = None
        if stash is not None:
            p, lh, y = stash[1]
            batch = ParsedBatch(
                np.asarray([y]), np.asarray([lh]), np.ones(1, bool),
                np.asarray([p]), np.zeros(1, int), np.zeros(1, int),
                status=np.full(1, STATUS_DEGRADED, np.int8))
            stats.degraded += 1
            stats.tier0_fallbacks += 1
            tier = 0
        elif cfg.degrade:
            batch = self.fallback.predict_pairs(
                st.sims[qi:qi + 1], st.idx[qi:qi + 1], [st.models[mi]])
            stats.degraded += 1
        else:
            batch = self.fallback.failed_pairs(1)
            stats.failed_pairs += 1
        for j, (entry, i) in enumerate(waiters):
            entry.fill(i, batch, 0, shared=j > 0)
        if self.use_cache and cfg.degrade:
            self.engine.cache.put_many([key], [CachedPrediction(
                y_hat=int(batch.y_hat[0]), len_hat=float(batch.len_hat[0]),
                well_formed=bool(batch.well_formed[0]),
                p_conf=float(batch.p_conf[0]), pred_tokens=0,
                prompt_tokens=self.prompt_tokens(key),
                status=int(batch.status[0]), tier=tier)])


class ScopeEngine:
    def __init__(self, config: EngineConfig, registry: PoolRegistry,
                 cache: PredictionCache, *,
                 monitor: Optional[FeedbackMonitor] = None):
        self.config = config
        self.registry = registry
        self.cache = cache
        # drift-aware self-healing: the outcome monitor (None unless
        # EngineConfig.drift_detect), the engine-lifetime injector that
        # arms model_drift faults at outcome-observation events (streams
        # own separate injectors for the serve-boundary sites), and the
        # hot-swap ledger
        self.monitor = monitor
        self._outcome_injector = FaultInjector(config.fault_plan)
        self._hot_swaps = 0

    # -- construction --------------------------------------------------
    @classmethod
    def build(cls, config: EngineConfig) -> "ScopeEngine":
        """Validate an ``EngineConfig`` and wire the facade.  The engine
        runs where its estimator and retriever run (the card by default,
        ``device="cpu"`` when they were built for the CPU)."""
        for field in ("estimator", "retriever", "library"):
            if getattr(config, field) is None:
                raise ValueError(f"EngineConfig.{field} is required")
        if config.registry is not None and config.models_meta is not None:
            raise ValueError(
                "pass either EngineConfig.registry or .models_meta, not both")
        registry = config.registry
        if registry is None:
            registry = PoolRegistry(config.library, config.models_meta)
        elif registry.library is not config.library:
            raise ValueError("registry.library and config.library differ")
        monitor = None
        if config.drift_detect:
            monitor = FeedbackMonitor(
                capacity=config.feedback_capacity,
                delta=config.drift_delta,
                threshold=config.drift_threshold,
                min_obs=config.drift_min_obs)
        return cls(config, registry, PredictionCache(config.cache_capacity),
                   monitor=monitor)

    # -- owned components ----------------------------------------------
    @property
    def estimator(self):
        return self.config.estimator

    @property
    def retriever(self):
        return self.config.retriever

    @property
    def library(self):
        return self.config.library

    def set_estimator(self, estimator, version: str) -> None:
        """Swap estimator weights; the version bump keys a fresh cache space."""
        self.config.estimator = estimator
        self.config.estimator_version = version

    def hot_swap(self, estimator, version: str, *, tier0=_UNSET) -> None:
        """Swap the estimator under live traffic, exactly-once preserved.

        Safe mid-stream on the refill path: the live slot state keeps the
        old params (its rows finish on them — ``ReasoningEstimator.
        open_slots`` bound the params at state open), while the next state
        opened at a segment boundary binds the new estimator.  The
        required version bump invalidates the ``PredictionCache`` and the
        in-flight dedup keys for free — both are keyed on
        ``estimator_version`` — and stashed tier-0 fallback answers carry
        their submit-time version, so ``_StreamControl.degrade`` refuses
        any stash minted before the swap.

        ``tier0``: a head distilled/calibrated against the *new* estimator
        (stamped with ``version``); omitted, any configured head is
        dropped — its probabilities and temperature calibrate the old
        estimator, and serving miscalibrated tier-0 answers under a new
        version would poison the fresh cache space.  Pass ``tier0=None``
        explicitly for the same drop without the implicit-behavior read.

        A host-side pointer swap: nothing is copied or rebuilt.
        """
        cfg = self.config
        if version == cfg.estimator_version:
            raise ValueError(
                f"hot_swap requires a new estimator_version (got "
                f"{version!r}, already current); the version bump is what "
                "invalidates the cache and the tier-0 stashes")
        cfg.estimator = estimator
        cfg.estimator_version = version
        if tier0 is _UNSET:
            cfg.tier0 = None
        else:
            if tier0 is not None:
                tier0.version = version
            cfg.tier0 = tier0
        self._hot_swaps += 1

    # -- pool lifecycle ------------------------------------------------
    def onboard(self, world: World, name: str, *, seed: int = 0,
                meta: Optional[PoolModel] = None,
                refresh: bool = False) -> Fingerprint:
        """Training-free: register + one fingerprint pass, no weight update.

        ``refresh=True`` re-fingerprints an already-known model and drops
        its cached predictions (they were computed from the old
        fingerprint).  With a drift monitor attached and replay-buffer
        outcomes recorded for the model, the refresh is synthesized from
        *served traffic* (``FeedbackMonitor.refresh_fingerprint``) instead
        of a world pass — the self-healing path needs no offline dataset —
        and the model's quarantine and detector are cleared.
        """
        monitor = self.monitor
        if refresh and monitor is not None and monitor.can_refresh(name):
            self.registry.add_model(meta if meta is not None
                                    else world.models[name])
            fp = monitor.refresh_fingerprint(name, self.library)
            self.library.add(fp)
            self.cache.invalidate_model(name)
            monitor.clear(name)
            return fp
        fp = self.registry.onboard(world, name, seed=seed, meta=meta,
                                   refresh=refresh)
        if refresh:
            self.cache.invalidate_model(name)
            if monitor is not None:
                monitor.clear(name)
        return fp

    def remove_model(self, name: str) -> None:
        self.registry.remove_model(name)
        self.cache.invalidate_model(name)

    # -- prediction ----------------------------------------------------
    def _empty_pool(self, models: List[str], Q: int) -> PoolPredictions:
        M = len(models)
        k = self.config.k
        return PoolPredictions(
            models, np.zeros((Q, M)), np.zeros((Q, M), int),
            np.zeros((Q, M)), np.zeros((Q, M)), np.zeros((Q, M), bool),
            np.zeros((Q, M)), np.zeros((Q, k)), np.zeros((Q, k), int))

    def _prepare(self, request: RouteRequest, use_cache: bool
                 ) -> _PredictState:
        """Everything before the estimator: retrieval, cache probe, and the
        serialized prompts for the missing (query, model) pairs."""
        cfg = self.config
        models = (list(request.models) if request.models is not None
                  else self.registry.routable())
        queries = list(request.queries)
        Q, M = len(queries), len(models)
        if Q == 0 or M == 0:            # empty before validation, as predict
            return _PredictState(models, queries, [], np.zeros((Q, cfg.k)),
                                 np.zeros((Q, cfg.k), int),
                                 np.zeros((Q, M), bool), np.zeros((Q, M), int),
                                 np.zeros((Q, M)), np.zeros((Q, M), bool),
                                 np.zeros((Q, M)), np.zeros((Q, M)),
                                 np.zeros((0, 2), int), [], use_cache,
                                 status=np.zeros((Q, M), np.int8))
        for m in models:
            if m not in self.registry:
                raise KeyError(f"model {m!r} is not registered; "
                               "PoolRegistry.add_model/onboard it first")
            if m not in self.library:
                raise KeyError(f"model {m!r} has no fingerprint; "
                               "PoolRegistry.onboard it first")

        embs = request.query_embs
        if embs is None:
            embs = np.stack([q.embedding for q in queries])
        sims, idx = self.retriever.retrieve(embs, cfg.k)

        # -- batched cache probe: one pass per model column ------------
        version = cfg.estimator_version
        qkeys = [query_key(q) for q in queries]
        hit = np.zeros((Q, M), bool)
        y_hat = np.zeros((Q, M), int)
        len_hat = np.zeros((Q, M))
        wf = np.zeros((Q, M), bool)
        p_conf = np.zeros((Q, M))
        prompt_tok = np.zeros((Q, M))
        status = np.full((Q, M), STATUS_OK, np.int8)
        if use_cache:
            for mi, m in enumerate(models):
                col = self.cache.get_many(qkeys, m, version)
                hit[:, mi] = col.mask
                y_hat[:, mi] = col.y_hat
                len_hat[:, mi] = col.len_hat
                wf[:, mi] = col.well_formed
                p_conf[:, mi] = col.p_conf
                prompt_tok[:, mi] = col.prompt_tokens
                status[:, mi] = np.where(col.mask, col.status, STATUS_OK)

        missing = np.argwhere(~hit)                     # (n, 2) row-major
        prompts: List[List[int]] = []
        feats = [] if cfg.tier0 is not None and len(missing) else None
        for qi, mi in missing:
            m = models[mi]
            args = (self.registry.meta(m), self.registry.index(m),
                    self.library.anchor_set, self.library.get(m),
                    sims[qi], idx[qi], queries[qi])
            prompts.append(serialization.serialize_prompt(*args))
            if feats is not None:
                feats.append(pair_features(*args))
        st = _PredictState(models, queries, qkeys, sims, idx, hit, y_hat,
                           len_hat, wf, p_conf, prompt_tok, missing,
                           prompts, use_cache, status=status)
        if feats is not None:
            self._gate_tier0(st, feats)
        return st

    def _gate_tier0(self, st: _PredictState, feats: List) -> None:
        """Tier-0 gating stage: one head forward over the missing pairs;
        pairs whose calibrated confidence clears ``escalation_threshold``
        are answered in place (OK status, zero decode overhead, the
        serialized prompt length for Eq. 24 cost accounting) and removed
        from ``missing``/``prompts`` so they never reach the estimator, the
        scheduler, or the in-flight dedup map.  The rest escalate
        unchanged, with their tier-0 rows stashed for quarantine/deadline
        fallback."""
        cfg = self.config
        batch0 = cfg.tier0.predict_features(feats)
        answer = batch0.conf >= cfg.escalation_threshold
        st.tier0_answered = int(answer.sum())
        st.escalated = len(feats) - st.tier0_answered
        keep = np.flatnonzero(~answer)
        st.t0_rows = {int(new_i): (float(batch0.p[i]),
                                   float(batch0.len_hat[i]),
                                   int(batch0.y_hat[i]))
                      for new_i, i in enumerate(keep)}
        if st.tier0_answered == 0:
            return
        taken = np.flatnonzero(answer)
        aq, am = st.missing[taken, 0], st.missing[taken, 1]
        st.y_hat[aq, am] = batch0.y_hat[taken]
        st.len_hat[aq, am] = batch0.len_hat[taken]
        st.wf[aq, am] = True
        st.p_conf[aq, am] = batch0.p[taken]
        plens = np.fromiter((len(st.prompts[i]) for i in taken), int,
                            count=len(taken))
        st.prompt_tok[aq, am] = plens
        if st.use_cache:
            self.cache.put_many(
                [(st.qkeys[qi], st.models[mi], cfg.estimator_version)
                 for qi, mi in st.missing[taken]],
                [CachedPrediction(
                    y_hat=int(batch0.y_hat[i]),
                    len_hat=float(batch0.len_hat[i]),
                    well_formed=True, p_conf=float(batch0.p[i]),
                    pred_tokens=0, prompt_tokens=int(plens[j]),
                    status=STATUS_OK, tier=0)
                 for j, i in enumerate(taken)])
        st.missing = st.missing[keep]
        st.prompts = [st.prompts[i] for i in keep]

    def _fold_tier_stats(self, stats, st: _PredictState) -> None:
        """Accumulate the per-request gate outcome into the stream's
        ``SchedulerStats`` tier ledger."""
        if self.config.tier0 is None:
            return
        stats.tier0_answered += st.tier0_answered
        stats.escalated += st.escalated
        budget = int(getattr(self.estimator, "max_new_tokens", 0) or 0)
        stats.tier0_decode_tokens_saved += st.tier0_answered * budget

    def _fold_drift_stats(self, stats) -> None:
        """Snapshot the drift ledger into a stream's ``SchedulerStats``.

        Pure snapshot, no accumulation: the monitor owns the monotonic
        counters.  Without a monitor only ``hot_swaps`` is stamped (the
        counter exists monitor or not) and the rest stay at their zero
        defaults.
        """
        stats.hot_swaps = self._hot_swaps
        m = self.monitor
        if m is None:
            return
        stats.drift_alarms = m.alarms
        stats.models_quarantined = len(m.drifted)
        stats.replay_buffer_len = len(m.buffer)
        p50, p95 = m.residual_percentiles()
        stats.drift_residual_p50 = p50
        stats.drift_residual_p95 = p95

    def _finalize(self, st: _PredictState, batch: ParsedBatch, *,
                  put_cache: bool = True) -> PoolPredictions:
        """Scatter fresh estimator rows over the cache-probe columns and
        assemble the ``PoolPredictions`` (identical math for batch and
        stream paths).  ``put_cache=False`` when the caller already wrote
        the entries (the stream path puts per microbatch)."""
        cfg = self.config
        Q, M = len(st.queries), len(st.models)
        if Q == 0 or M == 0:
            return self._empty_pool(st.models, Q)
        if len(batch) != len(st.prompts):
            raise RuntimeError(
                f"estimator returned {len(batch)} predictions for "
                f"{len(st.prompts)} prompts")
        missing = st.missing
        y_hat, len_hat, wf = st.y_hat, st.len_hat, st.wf
        p_conf, prompt_tok = st.p_conf, st.prompt_tok
        overhead = np.zeros((Q, M))
        if len(missing):
            mq, mm = missing[:, 0], missing[:, 1]
            plens = np.fromiter((len(p) for p in st.prompts), int,
                                count=len(st.prompts))
            y_hat[mq, mm] = batch.y_hat
            len_hat[mq, mm] = batch.len_hat
            wf[mq, mm] = batch.well_formed
            p_conf[mq, mm] = batch.p_conf
            prompt_tok[mq, mm] = plens
            if st.status is not None:
                st.status[mq, mm] = batch.status
            # cached pairs spend no new estimator tokens on this call
            overhead[mq, mm] = batch.pred_tokens
            if st.use_cache and put_cache:
                entries = [CachedPrediction(
                    y_hat=int(batch.y_hat[i]),
                    len_hat=float(batch.len_hat[i]),
                    well_formed=bool(batch.well_formed[i]),
                    p_conf=float(batch.p_conf[i]),
                    pred_tokens=int(batch.pred_tokens[i]),
                    prompt_tokens=int(plens[i]),
                    status=int(batch.status[i]))
                    for i in range(len(missing))]
                self.cache.put_many(
                    [(st.qkeys[qi], st.models[mi], cfg.estimator_version)
                     for qi, mi in missing], entries)

        # quarantine stamping: a drifted model's *presented* status drops
        # OK pairs to DRIFTED so policies and reports see the quarantine,
        # while the stored cache entries stay truthful (demote_model
        # rewrote them once at alarm time; post-refresh OK writes heal
        # them).  An empty drifted set touches nothing — detector-on
        # serving stays identical to detector-off without a fault.
        if (self.monitor is not None and self.monitor.drifted
                and st.status is not None):
            for mi, m in enumerate(st.models):
                if m in self.monitor.drifted:
                    col = st.status[:, mi]
                    st.status[:, mi] = np.where(
                        col == STATUS_OK, STATUS_DRIFTED, col)

        lh = np.where(wf, len_hat, FALLBACK_LEN_HAT)
        price_in = np.asarray([self.registry.meta(m).price_in
                               for m in st.models])
        price_out = np.asarray([self.registry.meta(m).price_out
                                for m in st.models])
        # actual serialized prompt length, not a flat constant (Eq. 24)
        cost_hat = (prompt_tok * price_in[None] + lh * price_out[None]) / 1e6
        p_hat = p_conf if cfg.use_confidence else y_hat.astype(float)
        return PoolPredictions(st.models, p_hat, y_hat, lh, cost_hat, wf,
                               overhead, st.sims, st.idx,
                               cache_hits=int(st.hit.sum()),
                               cache_misses=len(missing),
                               status=st.status,
                               tier0_answered=st.tier0_answered,
                               escalated=st.escalated)

    def predict(self, request: RouteRequest, *,
                rng: Optional[torch.Generator] = None,
                use_cache: Optional[bool] = None) -> PoolPredictions:
        """Pool-wide pre-hoc estimates; estimator runs on cache misses only.

        The default pool is ``registry.routable()`` — a model staged with
        ``add_model`` but not yet fingerprinted is excluded rather than
        failing the whole batch; naming it in ``request.models`` raises.
        """
        if use_cache is None:
            use_cache = self.config.enable_cache
        st = self._prepare(request, use_cache)
        batch = self._run_estimator(st.prompts, rng)
        return self._finalize(st, batch)

    # -- streaming prediction ------------------------------------------
    def _dispatch_microbatch(self, mb, rng):
        """Launch one microbatch: non-blocking handle for estimators with
        ``dispatch_batch`` (overlapped execution); a finished
        ``ParsedBatch`` for duck-typed object-list estimators."""
        dispatch = getattr(self.estimator, "dispatch_batch", None)
        if dispatch is not None:
            return dispatch(mb.tokens, prompt_lens=mb.lengths, rng=rng)
        return self._run_estimator(mb.tokens, rng)

    def _stream_fill(self, inflight, use_cache, control=None):
        """Parse consumer shared by the stream paths: scatter one parse
        group's rows into every waiting request (duplicates ride the first
        waiter's generation at zero extra tokens) and write the cache per
        group — the moment generations parse, before the owning request
        drains.

        ``pop(key, None)``: a parsed key may have no waiters left — its
        request was already answered degraded (a deadline expiry or an
        abort racing the in-flight decode).  The late full result still
        reaches the cache, healing the provisional degraded entry, and the
        unconditional pop guarantees the dedup map never retains a key
        past its resolution, whichever path resolved it.
        """
        def fill(tags, batch):
            keys, entries = [], []
            for row, key in enumerate(tags):
                waiters = inflight.pop(key, None)
                if control is not None:
                    control.note_resolved(key)
                if waiters:
                    for j, (entry, miss_i) in enumerate(waiters):
                        entry.fill(miss_i, batch, row, shared=j > 0)
                if use_cache:
                    if waiters:                         # true token spend
                        owner, miss_i = waiters[0]
                        n_prompt = len(owner.state.prompts[miss_i])
                    else:                               # late heal
                        n_prompt = (control.prompt_tokens(key)
                                    if control is not None else 0)
                    keys.append(key)
                    entries.append(CachedPrediction(
                        y_hat=int(batch.y_hat[row]),
                        len_hat=float(batch.len_hat[row]),
                        well_formed=bool(batch.well_formed[row]),
                        p_conf=float(batch.p_conf[row]),
                        pred_tokens=int(batch.pred_tokens[row]),
                        prompt_tokens=n_prompt,
                        status=int(batch.status[row])))
            if keys:
                self.cache.put_many(keys, entries)
        return fill

    def _submit_misses(self, st, entry, sched, inflight, use_cache,
                       serial: int, control=None) -> int:
        """Queue a request's missing (query, model) prompts; a pair whose
        key duplicates one still in flight shares that generation instead
        of being scheduled again."""
        for miss_i, prompt in enumerate(st.prompts):
            qi, mi = st.missing[miss_i]
            key = (st.qkeys[qi], st.models[mi], self.config.estimator_version)
            if use_cache and key in inflight:
                inflight[key].append((entry, miss_i))
                continue
            if not use_cache:           # uncached: never share work
                key, serial = ("uncached", serial), serial + 1
            inflight[key] = [(entry, miss_i)]
            if control is not None:
                control.note_submit(key, prompt)
                if st.t0_rows is not None:
                    # versioned stash: a hot_swap mid-stream must not let
                    # degrade() serve a fallback the *old* head computed
                    control.t0_rows[key] = (self.config.estimator_version,
                                            st.t0_rows[miss_i])
            sched.submit(key, prompt)
        return serial

    def predict_stream(self, requests: Iterable[RouteRequest], *,
                       scheduler: Optional["MicrobatchScheduler"] = None,
                       rng: Optional[torch.Generator] = None,
                       use_cache: Optional[bool] = None,
                       overlap: bool = True,
                       refill: Optional[bool] = None,
                       segment_len: Optional[int] = None,
                       max_pending: Optional[int] = None
                       ) -> Iterator[PoolPredictions]:
        """Drain an iterator of requests through the continuous-batching
        serve runtime.

        Yields one ``PoolPredictions`` per request, in arrival order, with
        the exact semantics of ``predict``: per-request ``get_many`` cache
        probes, estimator work for the misses only, per-request
        ``put_many`` on completion.  The difference is *how* the estimator
        runs: miss prompts from all in-flight requests are assembled into
        fixed-shape bucket microbatches (see ``serving.scheduler``) — so
        ragged traffic reuses a handful of batch shapes and small
        ticks ride along with large ones — and each microbatch is
        **double-buffer dispatched** through a ``ServeRuntime``
        (``overlap=True``): batch N+1's host assembly (cache probe,
        serialization, packing) runs while N's device decode is in flight,
        and the host blocks only at parse time.  Parses stay in dispatch
        (FIFO) order, so overlap changes when the host blocks, never what
        it observes; ``overlap=False`` restores the fully synchronous
        loop.  Under greedy decoding the yielded predictions match
        ``predict`` on the same queries — token- and decision-identical,
        with confidences to f32 ulp (reduction order varies with batch
        shape).

        The scheduler's deadline/occupancy knobs (``max_queue_age`` /
        ``min_fill``) are honored on every request arrival via ``tick()``:
        a latency-sensitive prompt rides out in a partially-filled bucket
        instead of waiting for a full one.  A request is emitted once all
        its missing pairs are resolved; partially-filled buckets are
        flushed when the input iterator is exhausted, so every submitted
        request is always answered.  A pair whose (query, model)
        duplicates one still in flight (a hot query repeated across ticks,
        probed before the first tick's microbatch parsed into the cache)
        is not scheduled again: it shares the in-flight generation and,
        like a cache hit, spends no new estimator tokens.  Cache writes
        happen per microbatch — the moment a bucket's generations are
        parsed — so later requests hit entries from microbatches parsed
        before they arrived, even while the owning request is still
        FIFO-blocked from emitting.

        ``max_pending`` sets the pipelining depth of the runtime (how many
        dispatched microbatches may be in flight before the oldest is
        block-parsed): ``None`` defaults to ``EngineConfig.max_pending``,
        then to 1 when ``overlap`` else 0.  Depths > 1 interleave batch
        N+1's prefill with batch N's decode on the card's one stream —
        not measured yet.

        ``refill=True`` (default ``EngineConfig.refill``) switches to
        **segment-chunked continuous batching**: decode runs in
        ``segment_len``-step decode segments over a fixed slot batch, and
        between segments rows that drained at EOS (or exhausted their
        budget) are parsed from their own window of the decode buffer and
        their slot refilled with the oldest queued prompt
        (``scheduler.pop_one``) — a row that finishes early admits the
        next request instead of idling until the batch retires.  All
        cache/dedup semantics above are preserved; under greedy decoding
        refill-on and refill-off streams make identical routing decisions
        (token-derived fields bit-equal, confidences to f32 ulp).

        Refill-mode latency caveat: while a slot state is live, queued
        prompts are admitted at segment cadence via ``pop_one`` — usually
        *sooner* than a deadline flush — but the scheduler's
        ``max_queue_age``/``min_fill`` knobs and full-bucket emission are
        only consulted between states, so a prompt that cannot ride the
        live state (wider than its slots, or all slots busy) waits up to
        the remaining refill horizon before a new bucket opens.  With
        ``EngineConfig.kv_paged`` the horizon ceiling does not exist: the
        slot cache is block-paged (``serving.kv_pool``), admission gates
        on free pool pages, and a state serves requests indefinitely —
        the wait collapses to "until a slot drains and pages free up".
        """
        cfg = self.config
        if use_cache is None:
            use_cache = cfg.enable_cache
        if refill is None:
            refill = cfg.refill
        if cfg.kv_paged and not refill:
            raise ValueError(
                "kv_paged requires the refill serve path (the whole-retire "
                "runtime keeps dense per-microbatch caches) — set "
                "EngineConfig.refill=True or pass refill=True")
        sched = scheduler if scheduler is not None else MicrobatchScheduler()
        mesh = getattr(self.estimator, "mesh", None)
        if mesh is not None and mesh.size() > 1 and (
                sched.max_queue_age is not None
                or cfg.deadline_ms is not None):
            raise ValueError(
                "max_queue_age and deadline_ms act on each process's own "
                "clock, so the ranks of an estimator sharded over "
                f"{mesh.size()} devices would flush and expire different "
                "requests: stream without them (min_fill counts requests "
                "and is kept)")
        if refill:
            yield from self._predict_stream_refill(
                requests, sched, rng=rng, use_cache=use_cache,
                segment_len=(cfg.segment_len if segment_len is None
                             else int(segment_len)))
            return
        if max_pending is None:
            max_pending = cfg.max_pending
        if max_pending is None:
            max_pending = 1 if overlap else 0
        pending: Deque[_StreamEntry] = deque()
        # (query_key, model, version) -> waiters; the first waiter's prompt
        # is the one scheduled, later duplicates ride along
        inflight: Dict[Tuple, List[Tuple[_StreamEntry, int]]] = {}
        control = _StreamControl(self, sched, inflight, use_cache)
        fill = self._stream_fill(inflight, use_cache, control)
        serial = 0                          # unique keys for uncached pairs
        # decode-slot occupancy: whole-retire runs every bucket the full
        # budget; pad rows and post-EOS steps idle (duck-typed estimators
        # have no token budget — counters stay zero)
        budget = int(getattr(self.estimator, "max_new_tokens", 0) or 0)

        def on_parsed(mb, batch):
            batch = control.corrupt(batch)
            fill(mb.tags, batch)
            if budget:
                sched.stats.slot_steps_total += mb.tokens.shape[0] * budget
                sched.stats.slot_steps_active += int(
                    batch.pred_tokens[: mb.n_real].sum())

        def dispatch_fn(mb):
            control.pre_dispatch()
            return self._dispatch_microbatch(mb, rng)

        runtime = ServeRuntime(
            dispatch_fn, on_parsed=on_parsed, max_pending=max_pending,
            on_failed=control.on_failed_mb)

        def drain_completed():
            while pending and pending[0].remaining == 0:
                entry = pending.popleft()
                yield self._finalize(entry.state, entry.parsed(),
                                     put_cache=False)

        with runtime:
            for request in requests:
                st = self._prepare(request, use_cache)
                self._fold_tier_stats(sched.stats, st)
                entry = _StreamEntry(st)
                pending.append(entry)
                serial = self._submit_misses(st, entry, sched, inflight,
                                             use_cache, serial, control)
                runtime.dispatch(sched.tick())
                runtime.poll()              # free parses: device already done
                control.expire()
                yield from drain_completed()
            # shutdown drains until the retry machinery settles: a failed
            # microbatch requeues its rows mid-flush, so flush + parse
            # until both the queue and the pipeline are empty (bounded by
            # max_retries — every key ends parsed or quarantined)
            while len(sched) or len(runtime):
                runtime.dispatch(sched.flush())
                runtime.finish()
                control.expire()
            sched.stats.injected_faults = control.injector.fired
        yield from drain_completed()
        assert not pending, "stream ended with unresolved requests"

    def _predict_stream_refill(self, requests: Iterable[RouteRequest],
                               sched, *, rng, use_cache: bool,
                               segment_len: int
                               ) -> Iterator[PoolPredictions]:
        """Segment-chunked continuous batching (see ``predict_stream``).

        One decode state is live at a time (device work is serialized
        anyway); whole microbatches open a state, and between segments
        drained slots pull single requests off the scheduler queue.  One
        segment advances per request arrival, so admission interleaves
        with traffic; at stream end the loop drains until every slot
        retires.  A queued prompt wider than the live state's slots waits
        for that state to retire and then opens its own.
        """
        est = self.estimator
        open_slots = getattr(est, "open_slots", None)
        if open_slots is None:
            raise TypeError(
                "refill streaming requires an estimator with open_slots() "
                f"(ReasoningEstimator); {type(est).__name__} lacks it — "
                "stream with refill=False instead")
        cfg = self.config

        def open_base(tokens, **kw):
            # resolved per state-open, not per stream: a hot_swap between
            # segments binds the *new* estimator's params to the next
            # opened state, while the live state's slots finish on the old
            # params they opened with — the swap lands at a segment
            # boundary with exactly-once and FIFO untouched
            return self.estimator.open_slots(tokens, **kw)

        open_fn = open_base
        if cfg.kv_paged:
            if cfg.refill_horizon is not None:
                raise ValueError(
                    "kv_paged and refill_horizon are mutually exclusive: "
                    "paged admission is gated on free pool pages, not a "
                    "slot horizon")
            kernel = check_kv_kernel(cfg.kv_kernel)
            page = int(cfg.kv_page_size)
            shared = (None if cfg.kv_pool_pages is None
                      else KVPool(n_pages=int(cfg.kv_pool_pages),
                                  page_size=page))

            def open_fn(tokens, **kw):
                if shared is not None:
                    pool = shared
                else:
                    # auto-size: the opening bucket's dense worst case —
                    # paged still wins whenever rows finish early or the
                    # run outlives one horizon.  Budget read per open so a
                    # hot-swapped estimator sizes its own pools.
                    budget = int(getattr(self.estimator, "max_new_tokens",
                                         0) or 0)
                    budget_steps = -(-budget // segment_len) * segment_len
                    b, width = np.asarray(tokens).shape
                    pool = KVPool(
                        n_pages=b * (-(-(width + budget_steps) // page)),
                        page_size=page)
                return open_base(tokens, kv_pool=pool, kv_kernel=kernel,
                                 **kw)

        pending: Deque[_StreamEntry] = deque()
        inflight: Dict[Tuple, List[Tuple[_StreamEntry, int]]] = {}
        control = _StreamControl(self, sched, inflight, use_cache)
        fill = self._stream_fill(inflight, use_cache, control)

        def on_parsed(tags, batch):
            fill(tags, control.corrupt(batch))

        runtime = SlotRuntime(open_fn, sched, segment_len=segment_len,
                              on_parsed=on_parsed,
                              horizon=cfg.refill_horizon, rng=rng,
                              injector=control.injector,
                              on_failed=control.on_failed)
        serial = 0

        def drain_completed():
            while pending and pending[0].remaining == 0:
                entry = pending.popleft()
                yield self._finalize(entry.state, entry.parsed(),
                                     put_cache=False)

        for request in requests:
            st = self._prepare(request, use_cache)
            self._fold_tier_stats(sched.stats, st)
            entry = _StreamEntry(st)
            pending.append(entry)
            serial = self._submit_misses(st, entry, sched, inflight,
                                         use_cache, serial, control)
            runtime.pump(final=False)
            control.expire()
            yield from drain_completed()
        runtime.pump(final=True)
        control.expire()
        # deadline expiry between pumps may strand nothing, but a late
        # requeue can: drain until the queue and the slot state settle
        while len(sched) or len(runtime):
            runtime.pump(final=True)
            control.expire()
        sched.stats.injected_faults = control.injector.fired
        yield from drain_completed()
        assert not pending, "stream ended with unresolved requests"

    def serve_stream(self, data: ScopeData, qid_stream: Iterable[Sequence[int]],
                     policy: RoutingPolicy, *,
                     models: Optional[Sequence[str]] = None,
                     scheduler: Optional["MicrobatchScheduler"] = None,
                     rng: Optional[torch.Generator] = None,
                     use_cache: Optional[bool] = None,
                     overlap: bool = True,
                     refill: Optional[bool] = None,
                     segment_len: Optional[int] = None,
                     max_pending: Optional[int] = None
                     ) -> Iterator[BatchReport]:
        """Streaming ``serve``: one executed ``BatchReport`` per qid tick.

        ``qid_stream`` yields batches of query ids (one traffic tick each);
        prediction flows through ``predict_stream``'s bucketed scheduler
        (including its ``refill``/``segment_len``/``max_pending`` runtime
        knobs), then each tick is decided by ``policy`` and executed
        against the world exactly like ``serve``.
        """
        pool_models = (list(models) if models is not None
                       else self.registry.routable())
        ticks: Deque[List[int]] = deque()

        def as_requests():
            for qids in qid_stream:
                tick = [int(q) for q in qids]
                ticks.append(tick)
                yield RouteRequest([data.queries[q] for q in tick],
                                   models=pool_models)

        for pool in self.predict_stream(as_requests(), scheduler=scheduler,
                                        rng=rng, use_cache=use_cache,
                                        overlap=overlap, refill=refill,
                                        segment_len=segment_len,
                                        max_pending=max_pending):
            qids = ticks.popleft()
            if not qids:
                yield BatchReport.empty(policy.name, pool_models)
                continue
            decision = policy.decide(pool, self)
            report = self.execute(data, qids, pool, decision, policy.name)
            if scheduler is not None:
                # executed outcomes just landed — snapshot the drift
                # ledger so every yielded tick's stats are current
                self._fold_drift_stats(scheduler.stats)
            yield report

    def _run_estimator(self, prompts, rng: Optional[torch.Generator]
                       ) -> ParsedBatch:
        """Columnar estimator call on token lists; object-list estimators
        (duck-typed stand-ins) are adapted through
        ``ParsedBatch.from_predictions``."""
        if len(prompts) == 0:
            return ParsedBatch.empty()
        predict_batch = getattr(self.estimator, "predict_batch", None)
        if predict_batch is not None:
            return predict_batch(prompts, rng=rng)
        return ParsedBatch.from_predictions(
            self.estimator.predict(prompts, rng=rng))

    # -- decision math (Eq. 15, shared by policies) --------------------
    def utilities(self, pool: PoolPredictions, alpha: float, *,
                  with_calibration: bool = True) -> np.ndarray:
        """Final decision scores (Eq. 15) for each (query, model)."""
        cfg = self.config
        wc = (utility.w_cal(alpha, w_base=cfg.w_base)
              if with_calibration else 0.0)
        # per-query (row-wise) cost bounds, whole batch at once
        c_norm = utility.normalize_cost(pool.cost_hat, axis=1)
        u_pred = utility.predicted_utility(
            pool.p_hat, c_norm, alpha, gamma_base=cfg.gamma_base,
            beta=cfg.beta)
        if with_calibration and wc > 0.0:
            fps = {m: self.library.get(m) for m in pool.models}
            u_cal = calibration.calibration_utilities_batch(
                fps, pool.models, pool.idx, pool.sims, alpha,
                gamma_base=cfg.gamma_base, beta=cfg.beta)
        else:
            u_cal = np.zeros_like(u_pred)
        return (1.0 - wc) * u_pred + wc * u_cal

    def affine_scores(self, pool: PoolPredictions
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(p_hat, s_hat) for the affine Prop. D.1 search (Eq. 17)."""
        c_norm = utility.normalize_cost(pool.cost_hat, axis=1)
        s_hat = utility.cost_score(c_norm, 1.0,
                                   gamma_base=self.config.gamma_base,
                                   beta=0.0)
        return pool.p_hat, s_hat

    def decide(self, pool: PoolPredictions, policy: RoutingPolicy
               ) -> PolicyDecision:
        return policy.decide(pool, self)

    def _assemble(self, policy_name: str, decision: PolicyDecision,
                  pool: PoolPredictions, query_ids: Sequence[int], *,
                  accuracy: float, total_cost: float, exec_tokens: int,
                  executed: bool, extra_info: Optional[Dict] = None
                  ) -> BatchReport:
        """Shared per-query decision list + batch accounting."""
        choices = np.asarray(decision.choices, int)
        decisions = [
            RouteDecision(query_id=int(q), model=pool.models[int(c)],
                          alpha=decision.alpha,
                          p_hat=float(pool.p_hat[i, c]),
                          cost_hat=float(pool.cost_hat[i, c]),
                          status=("OK" if pool.status is None else
                                  status_name(int(pool.status[i, c]))))
            for i, (q, c) in enumerate(zip(query_ids, choices, strict=True))]
        share = {m: 0 for m in pool.models}
        for d in decisions:
            share[d.model] += 1
        info = dict(decision.info, **(extra_info or {}))
        if pool.status is not None and pool.degraded_fraction > 0.0:
            info["degraded_fraction"] = round(pool.degraded_fraction, 4)
        return BatchReport(
            policy=policy_name, alpha=decision.alpha, decisions=decisions,
            accuracy=accuracy, total_cost=total_cost,
            exec_tokens=exec_tokens,
            overhead_tokens=int(pool.pred_overhead.sum()),
            per_model_share={m: v / len(decisions) for m, v in share.items()},
            cache_hits=pool.cache_hits, cache_misses=pool.cache_misses,
            executed=executed, info=info)

    # -- routing verbs -------------------------------------------------
    def route(self, request: RouteRequest, policy: RoutingPolicy, *,
              rng: Optional[torch.Generator] = None,
              use_cache: Optional[bool] = None) -> BatchReport:
        """Decide without executing; accuracy/cost are *expected* values."""
        models = (list(request.models) if request.models is not None
                  else self.registry.routable())
        if len(request.queries) == 0:
            return BatchReport.empty(policy.name, models)
        pool = self.predict(request, rng=rng, use_cache=use_cache)
        decision = policy.decide(pool, self)
        choices = np.asarray(decision.choices, int)
        rows = np.arange(len(choices))
        return self._assemble(
            policy.name, decision, pool, [q.qid for q in request.queries],
            accuracy=float(np.mean(pool.p_hat[rows, choices])),
            total_cost=float(np.sum(pool.cost_hat[rows, choices])),
            exec_tokens=0, executed=False, extra_info={"expected": True})

    def serve(self, data: ScopeData, qids: Sequence[int],
              policy: RoutingPolicy, *, models: Optional[Sequence[str]] = None,
              rng: Optional[torch.Generator] = None,
              use_cache: Optional[bool] = None) -> BatchReport:
        """Route and execute against the world; realized accuracy/cost."""
        qids = [int(q) for q in qids]
        pool_models = (list(models) if models is not None
                       else self.registry.routable())
        if not qids:
            return BatchReport.empty(policy.name, pool_models)
        queries = [data.queries[q] for q in qids]
        pool = self.predict(RouteRequest(queries, models=pool_models),
                            rng=rng, use_cache=use_cache)
        decision = policy.decide(pool, self)
        return self.execute(data, qids, pool, decision, policy.name)

    def execute(self, data: ScopeData, qids: Sequence[int],
                pool: PoolPredictions, decision: PolicyDecision,
                policy_name: str = "policy") -> BatchReport:
        """Run the chosen models against the world and account the batch."""
        qids = [int(q) for q in qids]
        if not qids:
            return BatchReport.empty(policy_name, pool.models)
        choices = np.asarray(decision.choices, int)
        monitor = self.monitor
        accs, costs, tokens = [], [], 0
        for i, (q, c) in enumerate(zip(qids, choices, strict=True)):
            model = pool.models[int(c)]
            rec = data.record(q, model)
            # one outcome-observation event per served pair: an armed
            # model_drift fault degrades the *realized* outcome (the
            # deployed model genuinely got worse — accounting sees it too);
            # with no plan this is a dict probe, identical to before
            y, tok_i, cost = self._outcome_injector.corrupt_outcome(
                model, rec.y, rec.tokens, rec.cost)
            accs.append(y)
            costs.append(cost)
            tokens += tok_i
            if monitor is not None:
                newly = monitor.observe(Outcome(
                    query_id=query_key(data.queries[q]), model=model,
                    predicted_p=float(pool.p_hat[i, int(c)]),
                    predicted_cost=float(pool.cost_hat[i, int(c)]),
                    observed_y=float(y), observed_cost=float(cost),
                    observed_tokens=int(tok_i),
                    sims=pool.sims[i], idx=pool.idx[i],
                    well_formed=bool(pool.well_formed[i, int(c)])))
                if newly is not None:
                    # new alarm: demote the model's cached predictions so
                    # later probes surface DRIFTED until a refresh heals
                    self.cache.demote_model(newly)
        return self._assemble(
            policy_name, decision, pool, qids,
            accuracy=float(np.mean(accs)), total_cost=float(np.sum(costs)),
            exec_tokens=int(tokens), executed=True)
