"""Prediction cache for pre-hoc estimates.

Keyed by ``(query_id, model, estimator_version)`` so ``ScopeEngine.predict``
only runs the estimator for missing pairs.  Onboarding a new model onto an
already-served query set then costs O(Q) estimator calls instead of a full
O(Q x M) recompute (the Appendix F adaptation argument, applied to serving).

``query_id`` must identify query *content* — the engine derives it from the
query embedding, not the dataset-local ``qid``, so two datasets that reuse
integer ids never collide.
"""
from __future__ import annotations

import dataclasses
import zlib
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.status import STATUS_DRIFTED, STATUS_OK
from repro_torch.data.worldsim import Query


def query_key(query: Query) -> int:
    """Stable content-derived id: dataset qid mixed with an embedding CRC."""
    crc = zlib.crc32(np.ascontiguousarray(query.embedding,
                                          np.float32).tobytes())
    return (int(query.qid) << 32) ^ crc


@dataclasses.dataclass(frozen=True)
class CachedPrediction:
    """The estimator's raw parsed output for one (query, model) pair.

    ``status`` marks degraded-mode entries (``core.status``): a DEGRADED
    entry is a provisional answer from retrieval priors.  ``tier`` marks
    which estimator produced the entry: 0 for the pre-router head, 1 for
    the reasoning decode.  Both feed the same overwrite rule — see
    ``PredictionCache._downgrades``.
    """
    y_hat: int
    len_hat: float
    well_formed: bool
    p_conf: float
    pred_tokens: int            # overhead spent when this entry was computed
    prompt_tokens: int          # serialized prompt length (cost accounting)
    status: int = STATUS_OK
    tier: int = 1               # 0 = pre-router head, 1 = reasoning decode


@dataclasses.dataclass
class CachedBatch:
    """Columnar result of a batched cache probe (one model, Q queries).

    ``mask[i]`` says whether query i hit; field rows where ``mask`` is False
    are zero-filled and must be ignored by the caller.
    """
    mask: np.ndarray            # (Q,) bool
    y_hat: np.ndarray           # (Q,) int
    len_hat: np.ndarray         # (Q,) float
    well_formed: np.ndarray     # (Q,) bool
    p_conf: np.ndarray          # (Q,) float
    pred_tokens: np.ndarray     # (Q,) int
    prompt_tokens: np.ndarray   # (Q,) int
    status: np.ndarray          # (Q,) int8 (core.status codes)


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> "CacheStats":
        return CacheStats(self.hits, self.misses, self.evictions)

    def delta(self, since: "CacheStats") -> "CacheStats":
        return CacheStats(self.hits - since.hits, self.misses - since.misses,
                          self.evictions - since.evictions)


class PredictionCache:
    """LRU map ``(query_id, model, estimator_version) -> CachedPrediction``."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is not None and capacity <= 0:
            raise ValueError("capacity must be positive or None")
        self.capacity = capacity
        self.stats = CacheStats()
        self._store: "OrderedDict[Tuple[int, str, str], CachedPrediction]" = \
            OrderedDict()

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: Tuple[int, str, str]) -> bool:
        return key in self._store

    def get(self, query_id: int, model: str, version: str
            ) -> Optional[CachedPrediction]:
        entry = self._store.get((query_id, model, version))
        if entry is None:
            self.stats.misses += 1
            return None
        self._store.move_to_end((query_id, model, version))
        self.stats.hits += 1
        return entry

    @staticmethod
    def _health(status: int) -> int:
        """Three-level health: OK(2) > DRIFTED(1) > DEGRADED/FAILED(0).

        DRIFTED entries are real decodes conditioned on a stale
        fingerprint — more trustworthy than a retrieval prior, less than a
        fresh decode — so they sit on the middle rung: an OK write (e.g.
        the first probe after ``onboard(refresh=True)``) heals them, and a
        drifted write never clobbers an OK entry."""
        if status == STATUS_OK:
            return 2
        if status == STATUS_DRIFTED:
            return 1
        return 0

    @classmethod
    def _rank(cls, pred: CachedPrediction) -> Tuple[int, int]:
        """Overwrite rank: health first (OK beats DRIFTED beats
        DEGRADED/FAILED), then tier (reasoning decode beats pre-router
        head)."""
        return (cls._health(pred.status), pred.tier)

    def _downgrades(self, key: Tuple[int, str, str],
                    pred: CachedPrediction) -> bool:
        """Whether writing ``pred`` would replace a strictly better entry.

        An entry's rank is ``(health, tier)``: an OK escalated (tier-1)
        decode heals anything; an OK tier-0 answer heals drifted/degraded
        entries but never clobbers a real decode; non-OK entries never
        clobber an OK entry of either tier.  Equal-rank writes refresh in
        place (a newer answer of the same quality wins)."""
        old = self._store.get(key)
        return old is not None and self._rank(pred) < self._rank(old)

    def put(self, query_id: int, model: str, version: str,
            pred: CachedPrediction) -> None:
        key = (query_id, model, version)
        if self._downgrades(key, pred):
            return
        self._store[key] = pred
        self._store.move_to_end(key)
        if self.capacity is not None:
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)
                self.stats.evictions += 1

    # -- batched probes (the serve hot path) ---------------------------
    def get_many(self, query_ids: Sequence[int], model: str, version: str
                 ) -> CachedBatch:
        """Probe Q keys for one model in a single pass.

        Counts one hit/miss per key and refreshes LRU recency of hits, like
        Q ``get`` calls, but returns columnar arrays so the caller never
        touches per-entry objects.
        """
        n = len(query_ids)
        out = CachedBatch(
            mask=np.zeros(n, bool), y_hat=np.zeros(n, int),
            len_hat=np.zeros(n, np.float64), well_formed=np.zeros(n, bool),
            p_conf=np.zeros(n, np.float64), pred_tokens=np.zeros(n, int),
            prompt_tokens=np.zeros(n, int), status=np.zeros(n, np.int8))
        store = self._store
        hits = 0
        for i, qid in enumerate(query_ids):
            key = (qid, model, version)
            e = store.get(key)
            if e is None:
                continue
            store.move_to_end(key)
            hits += 1
            out.mask[i] = True
            out.y_hat[i] = e.y_hat
            out.len_hat[i] = e.len_hat
            out.well_formed[i] = e.well_formed
            out.p_conf[i] = e.p_conf
            out.pred_tokens[i] = e.pred_tokens
            out.prompt_tokens[i] = e.prompt_tokens
            out.status[i] = e.status
        self.stats.hits += hits
        self.stats.misses += n - hits
        return out

    def put_many(self, keys: Sequence[Tuple[int, str, str]],
                 preds: Sequence[CachedPrediction]) -> None:
        """Insert many entries in one pass; eviction runs once at the end."""
        if len(keys) != len(preds):
            raise ValueError(f"{len(keys)} keys for {len(preds)} entries")
        store = self._store
        for key, pred in zip(keys, preds, strict=True):
            if self._downgrades(key, pred):
                continue
            store[key] = pred
            store.move_to_end(key)
        if self.capacity is not None:
            while len(store) > self.capacity:
                store.popitem(last=False)
                self.stats.evictions += 1

    def demote_model(self, model: str,
                     status: int = STATUS_DRIFTED) -> int:
        """Demote every *healthier* entry for ``model`` to ``status`` in
        place (drift quarantine: the entries' numbers are genuine decodes,
        but the fingerprint they were conditioned on is stale).

        This is an administrative rewrite, not a ``put``: it bypasses
        ``_downgrades`` (which exists to stop *data* writes from clobbering
        better entries) and preserves LRU recency.  Entries already at or
        below the target health (degraded/failed provisional answers) are
        left alone.  Returns the number of entries demoted."""
        target = self._health(status)
        n = 0
        for key, e in self._store.items():
            if key[1] == model and self._health(e.status) > target:
                self._store[key] = dataclasses.replace(e, status=status)
                n += 1
        return n

    def invalidate_model(self, model: str) -> int:
        """Drop every entry for ``model`` (e.g. after re-fingerprinting)."""
        drop = [k for k in self._store if k[1] == model]
        for k in drop:
            del self._store[k]
        return len(drop)

    def clear(self) -> None:
        self._store.clear()
