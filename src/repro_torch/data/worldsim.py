"""Synthetic model-pool world simulator.

The repro band for this paper is 2/5: its data substrate is an 11-model
commercial API pool plus human benchmark corpora (SCOPE-60K).  We simulate
that gate with a generative world model that preserves every statistical
property the SCOPE algorithm depends on:

  * models have heterogeneous per-domain skills, verbosity profiles and
    $/token prices (mirroring Appendix Tab. 4's tiers, incl. the 4 held-out
    "unseen" models);
  * query correctness ~ Bernoulli(sigmoid(skill - difficulty));
  * completion tokens ~ verbosity * exp(difficulty) * lognormal noise, with
    reasoning models ~3-10x more verbose (Fig. 16/17 heterogeneity);
  * query embeddings cluster by domain, so dense retrieval over anchors is
    informative (Fig. 12 coverage).

Everything downstream (fingerprints, SFT/GRPO training, routing evaluation)
consumes only the *observable* interface: (query text features, model
metadata, sampled outcomes) — exactly what the paper's pipeline sees.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DOMAINS = ("math", "physics", "chemistry", "biology",
           "history", "politics", "chinese", "engineering")
NUM_DOMAINS = len(DOMAINS)
EMBED_DIM = 32

# Fig. 3 composition (approximate, renormalized)
DOMAIN_WEIGHTS = np.array([0.20, 0.13, 0.14, 0.06, 0.14, 0.13, 0.12, 0.08])


@dataclasses.dataclass(frozen=True)
class PoolModel:
    name: str
    skill: np.ndarray          # (NUM_DOMAINS,) in difficulty units
    base_skill: float
    verbosity: float           # base completion tokens
    reasoning: bool
    price_in: float            # $ / 1M tokens
    price_out: float
    seen: bool                 # in the training pool


def _mk(name, base, tilt, verb, reasoning, pin, pout, seen, rng):
    skill = base + tilt + rng.normal(0, 0.15, NUM_DOMAINS)
    return PoolModel(name, skill, base, verb, reasoning, pin, pout, seen)


def default_pool(seed: int = 0) -> List[PoolModel]:
    """11 models mirroring Appendix Tab. 4 (7 seen + 4 unseen)."""
    rng = np.random.default_rng(seed)
    t = lambda *v: np.array(v)  # noqa: E731  per-domain tilt
    stem = t(.3, .3, .25, .1, -.1, -.1, -.15, .2)
    hum = -stem
    return [
        # ---- seen (training pool) ----
        _mk("deepseek-r1t2-chimera", 1.05, stem * .8, 900, True, 0.30, 1.20, True, rng),
        _mk("qwen3-235b-a22b", 0.95, stem * .5, 700, True, 0.18, 0.54, True, rng),
        _mk("nova-2-lite-v1", 0.45, hum * .3, 500, False, 0.30, 2.50, True, rng),
        _mk("qwen3-14b", 0.40, stem * .3, 450, True, 0.05, 0.22, True, rng),
        _mk("gpt-oss-20b", 0.50, stem * .4, 600, True, 0.03, 0.14, True, rng),
        _mk("llama-3.3-70b", 0.65, t(0, 0, 0, 0, .2, .2, .1, 0), 380, False, 0.10, 0.32, True, rng),
        _mk("gemma-3-27b", 0.45, hum * .2, 350, False, 0.04, 0.15, True, rng),
        # ---- unseen (OOD pool) ----
        _mk("claude-sonnet-4.5", 1.45, t(.2, .2, .2, .2, .25, .25, .2, .2), 800, True, 3.00, 15.00, False, rng),
        _mk("deepseek-v3.2", 1.00, stem * .6, 850, True, 0.25, 0.38, False, rng),
        _mk("gpt-5-mini", 0.90, t(.1, .1, .1, .1, .1, .1, .1, .1), 550, False, 0.25, 2.00, False, rng),
        _mk("grok-4.1-fast", 0.80, stem * .3, 500, True, 0.20, 0.50, False, rng),
    ]


@dataclasses.dataclass
class Query:
    qid: int
    domain: int
    difficulty: float
    embedding: np.ndarray      # (EMBED_DIM,) — what the retriever sees


class World:
    """Holds domain geometry and samples interactions."""

    def __init__(self, seed: int = 0, pool: Optional[List[PoolModel]] = None):
        self.rng = np.random.default_rng(seed)
        self.pool = pool if pool is not None else default_pool(seed)
        self.models: Dict[str, PoolModel] = {m.name: m for m in self.pool}
        # domain cluster centres, well separated
        self.centers = self.rng.normal(0, 1.0, (NUM_DOMAINS, EMBED_DIM))
        self.centers /= np.linalg.norm(self.centers, axis=1, keepdims=True)
        self.diff_dir = self.rng.normal(0, 1.0, EMBED_DIM)
        self.diff_dir /= np.linalg.norm(self.diff_dir)

    # ------------------------------------------------------------------
    def sample_queries(self, n: int, *, difficulty_shift: float = 0.0,
                       seed: Optional[int] = None) -> List[Query]:
        rng = np.random.default_rng(seed) if seed is not None else self.rng
        domains = rng.choice(NUM_DOMAINS, size=n, p=DOMAIN_WEIGHTS / DOMAIN_WEIGHTS.sum())
        out = []
        for i in range(n):
            d = int(domains[i])
            diff = float(np.clip(rng.normal(0.8 + difficulty_shift, 0.55), -0.5, 3.5))
            emb = (self.centers[d] + 0.35 * diff * self.diff_dir
                   + rng.normal(0, 0.25, EMBED_DIM))
            out.append(Query(i, d, diff, emb.astype(np.float32)))
        return out

    # ------------------------------------------------------------------
    def correct_prob(self, m: PoolModel, q: Query) -> float:
        margin = m.skill[q.domain] - q.difficulty
        return float(1.0 / (1.0 + np.exp(-3.0 * margin)))

    def expected_tokens(self, m: PoolModel, q: Query) -> float:
        boost = 1.0 + (2.0 if m.reasoning else 0.6) * max(q.difficulty, 0.0)
        return float(min(m.verbosity * boost, 16384.0))

    def sample_interaction(self, m: PoolModel, q: Query,
                           rng: Optional[np.random.Generator] = None
                           ) -> Tuple[int, int, float]:
        """Returns (y, completion_tokens, cost_dollars)."""
        rng = rng or self.rng
        y = int(rng.random() < self.correct_prob(m, q))
        mu = np.log(self.expected_tokens(m, q))
        tokens = int(np.clip(np.exp(rng.normal(mu, 0.35)), 5, 16384))
        prompt = int(rng.integers(80, 320))
        cost = (prompt * m.price_in + tokens * m.price_out) / 1e6
        return y, tokens, cost

    def embed(self, q: Query, rng: Optional[np.random.Generator] = None
              ) -> np.ndarray:
        """The retrieval embedder's view (Qwen3-Embedding stand-in)."""
        rng = rng or self.rng
        return (q.embedding + rng.normal(0, 0.02, EMBED_DIM)).astype(np.float32)
