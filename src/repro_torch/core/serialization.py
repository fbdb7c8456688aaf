"""Prompt / target serialization (SCOPE Eq. 4, Appendix H).

P(x, M) = I || Ser(phi_K(x, M)) || x  becomes a structured token sequence:

  [BOS] <model-or-UNK> <reasoning|standard> <price-bucket> [SEP]
  { [ANCHOR] <domain> <sim-bucket> <yes|no> <len-bucket> } * K
  [QUERY] <domain> <feat tokens...> [PRED]

Targets (what the estimator must generate after [PRED]):
  CoT:    [THINK] <cnt-correct> <mean-len-bucket> <domain> [THINK_END]
          <yes|no> <len-bucket> [EOS]
  NoCoT:  <yes|no> <len-bucket> [EOS]

The CoT rationale mirrors hindsight distillation: a teacher conditioned on
realized outcomes emits a concise, grounded analysis (here: the sufficient
statistics of the retrieved fingerprint slice).  Token budget ~6 vs the
untrained model's free-form rambling — the source of the paper's 90%
predictor-overhead reduction (Appendix E).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.fingerprint import AnchorSet, Fingerprint
from repro_torch.data import tokenizer as tok
from repro_torch.data.worldsim import PoolModel, Query

MAX_PROMPT_LEN = 64          # 5 anchors x 5 + query block + header < 64
MAX_TARGET_LEN = 12
SEQ_LEN = 80                 # prompt + target padded length


def serialize_prompt(model: PoolModel, model_index: int,
                     anchor_set: AnchorSet, fp: Fingerprint,
                     sims: np.ndarray, idx: np.ndarray,
                     query: Query) -> List[int]:
    """Build the estimator prompt for (query, model) with retrieved anchors."""
    toks = [tok.BOS,
            tok.model_token(model_index, model.seen),
            tok.REASONING if model.reasoning else tok.STANDARD,
            tok.PRICE_BASE + tok.price_bucket(model.price_out),
            tok.SEP]
    for s, i in zip(sims, idx, strict=True):
        aq = anchor_set.queries[int(i)]
        toks += [tok.ANCHOR,
                 tok.domain_token(aq.domain),
                 tok.SIM_BASE + tok.sim_bucket(float(s)),
                 # round, not truncate: a buffer-refreshed fingerprint
                 # (serving.feedback) carries expected correctness in
                 # [0, 1]; binary fingerprints round to themselves
                 tok.yesno(int(round(float(fp.y[int(i)])))),
                 tok.LEN_BASE + tok.len_bucket(float(fp.tokens[int(i)]))]
    toks += [tok.QUERY, tok.domain_token(query.domain)]
    toks += tok.feat_tokens(query.embedding)
    toks += [tok.PRED]
    return toks


def teacher_target(fp_slice_y: Sequence[int], fp_slice_tokens: Sequence[float],
                   y_gt: int, len_gt: float, query: Query,
                   *, cot: bool = True) -> List[int]:
    """Hindsight-distillation target: concise grounded rationale + prediction."""
    out: List[int] = []
    if cot:
        cnt = int(np.sum(fp_slice_y))
        mean_len = float(np.mean(fp_slice_tokens)) if len(fp_slice_tokens) else 64.0
        out += [tok.THINK,
                tok.cnt_token(cnt),
                tok.LEN_BASE + tok.len_bucket(mean_len),
                tok.domain_token(query.domain),
                tok.THINK_END]
    out += [tok.yesno(int(y_gt)),
            tok.LEN_BASE + tok.len_bucket(float(len_gt)),
            tok.EOS]
    return out


def build_sft_example(model: PoolModel, model_index: int,
                      anchor_set: AnchorSet, fp: Fingerprint,
                      sims: np.ndarray, idx: np.ndarray, query: Query,
                      y_gt: int, len_gt: float, *, cot: bool = True
                      ) -> Tuple[List[int], List[int]]:
    prompt = serialize_prompt(model, model_index, anchor_set, fp, sims, idx,
                              query)
    target = teacher_target(fp.y[idx], fp.tokens[idx], y_gt, len_gt, query,
                            cot=cot)
    return prompt, target
