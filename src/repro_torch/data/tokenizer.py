"""Structured field tokenizer for serialized SCOPE prompts.

The paper serializes retrieved fingerprint slices + the target query into a
text prompt (Eq. 4, Appendix H).  Our estimator LM consumes the same
structure through a compact field vocabulary: special markers, model
metadata tokens, per-domain tokens, similarity / length / count buckets and
quantized query-embedding feature tokens.  VOCAB_SIZE = 512 matches
``configs.scope_estimator.TINY``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.data.worldsim import EMBED_DIM, NUM_DOMAINS

VOCAB_SIZE = 512

# ---------------------------------------------------------------------------
# Token map
# ---------------------------------------------------------------------------
PAD, BOS, EOS, SEP = 0, 1, 2, 3
ANCHOR, QUERY, PRED, THINK, THINK_END = 4, 5, 6, 7, 8
YES, NO = 9, 10
REASONING, STANDARD = 11, 12
UNK_MODEL = 13

_NEXT = 16
MODEL_BASE = _NEXT                      # 20 slots for seen-model name tokens
NUM_MODEL_TOKENS = 20
DOMAIN_BASE = MODEL_BASE + NUM_MODEL_TOKENS          # 36
SIM_BASE = DOMAIN_BASE + NUM_DOMAINS                 # 44
NUM_SIM_BUCKETS = 16
LEN_BASE = SIM_BASE + NUM_SIM_BUCKETS                # 60
NUM_LEN_BUCKETS = 32
PRICE_BASE = LEN_BASE + NUM_LEN_BUCKETS              # 92
NUM_PRICE_BUCKETS = 12
CNT_BASE = PRICE_BASE + NUM_PRICE_BUCKETS            # 104
NUM_CNT_TOKENS = 8                                   # counts 0..7
FEAT_BASE = CNT_BASE + NUM_CNT_TOKENS                # 112
NUM_FEAT_DIMS = 16
NUM_FEAT_BUCKETS = 16                                # 256 tokens -> ends 368

assert FEAT_BASE + NUM_FEAT_DIMS * NUM_FEAT_BUCKETS < VOCAB_SIZE

# length buckets: geometric from 8 to 16384
_LEN_EDGES = np.geomspace(8, 16384, NUM_LEN_BUCKETS + 1)
LEN_CENTERS = np.sqrt(_LEN_EDGES[:-1] * _LEN_EDGES[1:]).astype(np.float64)

_PRICE_EDGES = np.geomspace(0.01, 20.0, NUM_PRICE_BUCKETS + 1)


def len_bucket(tokens: float) -> int:
    return int(np.clip(np.searchsorted(_LEN_EDGES, tokens) - 1,
                       0, NUM_LEN_BUCKETS - 1))


def len_from_bucket(b: int) -> float:
    return float(LEN_CENTERS[int(np.clip(b, 0, NUM_LEN_BUCKETS - 1))])


def sim_bucket(sim: float) -> int:
    return int(np.clip((sim + 1.0) / 2.0 * NUM_SIM_BUCKETS, 0,
                       NUM_SIM_BUCKETS - 1))


def price_bucket(price_out: float) -> int:
    return int(np.clip(np.searchsorted(_PRICE_EDGES, price_out) - 1,
                       0, NUM_PRICE_BUCKETS - 1))


def feat_tokens(embedding: np.ndarray) -> List[int]:
    """Quantize the first NUM_FEAT_DIMS embedding dims into bucket tokens."""
    vals = np.clip(embedding[:NUM_FEAT_DIMS], -2.0, 2.0)
    buckets = ((vals + 2.0) / 4.0 * NUM_FEAT_BUCKETS).astype(int)
    buckets = np.clip(buckets, 0, NUM_FEAT_BUCKETS - 1)
    return [FEAT_BASE + i * NUM_FEAT_BUCKETS + int(b)
            for i, b in enumerate(buckets)]


def domain_token(d: int) -> int:
    return DOMAIN_BASE + int(d)


def model_token(model_index: int, seen: bool) -> int:
    if not seen:
        return UNK_MODEL
    return MODEL_BASE + int(model_index) % NUM_MODEL_TOKENS


def yesno(y: int) -> int:
    return YES if y else NO


def cnt_token(c: int) -> int:
    return CNT_BASE + int(np.clip(c, 0, NUM_CNT_TOKENS - 1))


# ---------------------------------------------------------------------------
# Decoding of predictions
# ---------------------------------------------------------------------------
def parse_prediction(tokens: Sequence[int]) -> Dict:
    """Parse a generated suffix into {y_hat, len_hat, well_formed}.

    Expected CoT format: THINK ... THINK_END (YES|NO) LEN_b EOS
    NoCoT format:        (YES|NO) LEN_b EOS
    The *format gate* G(o) of Eq. 6 is ``well_formed``.
    """
    toks = list(tokens)
    if THINK in toks:
        if THINK_END not in toks:
            return {"y_hat": 0, "len_hat": 0.0, "well_formed": False}
        toks = toks[toks.index(THINK_END) + 1:]
    # strip trailing pad/eos
    body = [t for t in toks if t not in (PAD,)]
    ok = (len(body) >= 3 and body[0] in (YES, NO)
          and LEN_BASE <= body[1] < LEN_BASE + NUM_LEN_BUCKETS
          and body[2] == EOS)
    if not ok:
        return {"y_hat": 0, "len_hat": 0.0, "well_formed": False}
    return {"y_hat": 1 if body[0] == YES else 0,
            "len_hat": len_from_bucket(body[1] - LEN_BASE),
            "well_formed": True}
