"""``ScopeEngine`` — the public entry point for SCOPE routing (batch path).

The engine owns the components the paper's pipeline needs at serve time
(reasoning estimator, anchor retriever, fingerprint library, model pool)
and exposes the routing surface as four verbs:

  predict  — cache-aware pool-wide pre-hoc estimation (Eq. 5, Eq. 24)
  route    — apply a ``RoutingPolicy`` to a request, report expected metrics
  serve    — route + execute against a ``ScopeData`` world, report realized
  onboard  — training-free pool growth (fingerprint pass, §3.1)

``predict`` consults the ``PredictionCache`` keyed by
``(query_id, model, estimator_version)`` and runs the estimator only for the
missing (query, model) pairs.  This is the batch path of
``repro/api/engine.py`` with the same math step for step; its streaming,
tier-0, drift and fault-tolerance layers are ported in later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.cache import CachedPrediction, PredictionCache, query_key
from repro_torch.api.policy import PolicyDecision, RoutingPolicy
from repro_torch.api.registry import PoolRegistry
from repro_torch.api.types import (
    BatchReport, EngineConfig, RouteDecision, RouteRequest)
from repro_torch.core import calibration, serialization, utility
from repro_torch.core.estimator import ParsedBatch
from repro_torch.core.fingerprint import Fingerprint
from repro_torch.core.router import PoolPredictions
from repro_torch.core.status import STATUS_OK, status_name
from repro_torch.data.datasets import ScopeData
from repro_torch.data.worldsim import PoolModel, World

FALLBACK_LEN_HAT = 512.0    # tokens charged when the estimate is malformed


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


class ScopeEngine:
    def __init__(self, config: EngineConfig, registry: PoolRegistry,
                 cache: PredictionCache):
        self.config = config
        self.registry = registry
        self.cache = cache

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
        return cls(config, registry, PredictionCache(config.cache_capacity))

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

    # -- pool lifecycle ------------------------------------------------
    def onboard(self, world: World, name: str, *, seed: int = 0,
                meta: Optional[PoolModel] = None,
                refresh: bool = False) -> Fingerprint:
        """Training-free: register + one fingerprint pass, no weight update.

        ``refresh=True`` re-fingerprints an already-known model from the
        world and drops its cached predictions (they were computed from the
        old fingerprint).
        """
        fp = self.registry.onboard(world, name, seed=seed, meta=meta,
                                   refresh=refresh)
        if refresh:
            self.cache.invalidate_model(name)
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
        for qi, mi in missing:
            m = models[mi]
            prompts.append(serialization.serialize_prompt(
                self.registry.meta(m), self.registry.index(m),
                self.library.anchor_set, self.library.get(m),
                sims[qi], idx[qi], queries[qi]))
        return _PredictState(models, queries, qkeys, sims, idx, hit, y_hat,
                             len_hat, wf, p_conf, prompt_tok, missing,
                             prompts, use_cache, status=status)

    def _finalize(self, st: _PredictState, batch: ParsedBatch
                  ) -> PoolPredictions:
        """Scatter fresh estimator rows over the cache-probe columns, write
        them to the cache, and assemble the ``PoolPredictions``."""
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
            if st.use_cache:
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
                               status=st.status)

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
        accs, costs, tokens = [], [], 0
        for q, c in zip(qids, choices, strict=True):
            rec = data.record(q, pool.models[int(c)])
            accs.append(rec.y)
            costs.append(rec.cost)
            tokens += rec.tokens
        return self._assemble(
            policy_name, decision, pool, qids,
            accuracy=float(np.mean(accs)), total_cost=float(np.sum(costs)),
            exec_tokens=int(tokens), executed=True)
