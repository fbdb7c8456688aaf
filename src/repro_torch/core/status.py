"""Result status codes threaded through the serve stack.

Every answered (query, model) pair carries one of four statuses:

  OK        — the reasoning estimator decoded and parsed the pair
  DEGRADED  — the pair was answered from retrieval priors
              (``FallbackEstimator``): it was quarantined after repeated
              failures, expired past its SLO deadline, or degradation was
              requested directly
  FAILED    — the pair could not be answered at all (degradation disabled);
              its prediction fields are the malformed-estimate fallback
  DRIFTED   — the pair's estimate is a real decode, but its model's drift
              detector has alarmed (``serving.feedback``): the fingerprint
              it was conditioned on no longer matches the deployed model.
              Health-wise DRIFTED sits *between* OK and DEGRADED — the
              numbers are genuine yet stale, better than a retrieval prior
              but worse than a trusted decode — and an OK write after
              ``onboard(refresh=True)`` heals it (see
              ``PredictionCache._rank``).

The codes are small ints so they travel as numpy columns through
``ParsedBatch`` / ``PoolPredictions`` / ``CachedBatch``; ``status_name``
maps them back to the string surfaced on ``RouteDecision``.  DRIFTED is
appended as code 3 (the names tuple is ordinal-indexed), so existing
columns and checkpointed stats keep their values; its health *rank* is
what places it between OK and DEGRADED, not its numeric code.
"""
from __future__ import annotations

STATUS_OK = 0
STATUS_DEGRADED = 1
STATUS_FAILED = 2
STATUS_DRIFTED = 3

STATUS_NAMES = ("OK", "DEGRADED", "FAILED", "DRIFTED")


def status_name(code: int) -> str:
    return STATUS_NAMES[int(code)]
