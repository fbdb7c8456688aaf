"""Routing evaluation metrics: Average Accuracy, total Cost, PGR (Table 1).

PGR (Performance Gap Recovered, after RouteLLM as used by the paper):
    PGR = (A_router - A_cheapest) / (A_oracle - A_cheapest)
where the oracle picks the cheapest correct model per query (the paper's
"optimal choice") and A_cheapest is the always-cheapest-model policy.

A copy of ``repro/core/evaluation.py``: numpy over the world's records.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from repro_torch.core.baselines import oracle_choice
from repro_torch.data.datasets import ScopeData


@dataclasses.dataclass
class RoutingEval:
    avg_acc: float
    total_cost: float
    pgr: float
    per_model_share: Dict[str, float]
    exec_tokens: int


def evaluate_choices(data: ScopeData, qids: Sequence[int],
                     models: Sequence[str], choices: np.ndarray
                     ) -> RoutingEval:
    accs, costs, tokens = [], [], 0
    share = {m: 0 for m in models}
    for q, c in zip(qids, choices, strict=True):
        r = data.record(int(q), models[int(c)])
        accs.append(r.y)
        costs.append(r.cost)
        tokens += r.tokens
        share[models[int(c)]] += 1
    n = len(qids)
    avg_acc = float(np.mean(accs))

    # reference policies for PGR
    cheap_idx = int(np.argmin(
        [data.world.models[m].price_out for m in models]))
    a_cheap = float(np.mean(
        [data.record(int(q), models[cheap_idx]).y for q in qids]))
    a_oracle = float(np.mean(
        [data.record(int(q), models[oracle_choice(data, int(q), models)]).y
         for q in qids]))
    denom = a_oracle - a_cheap
    pgr = float((avg_acc - a_cheap) / denom) if abs(denom) > 1e-9 else 1.0
    return RoutingEval(avg_acc=avg_acc, total_cost=float(np.sum(costs)),
                       pgr=pgr,
                       per_model_share={m: v / n for m, v in share.items()},
                       exec_tokens=tokens)


def predictive_metrics(y_hat: np.ndarray, y_gt: np.ndarray,
                       len_hat: np.ndarray, len_gt: np.ndarray,
                       domains: np.ndarray = None) -> Dict:
    """Table 2: ACC for correctness, MAE for token length (per category)."""
    acc = float(np.mean(np.asarray(y_hat) == np.asarray(y_gt)))
    mae = float(np.mean(np.abs(np.asarray(len_hat) - np.asarray(len_gt))))
    out = {"acc": acc, "mae": mae}
    if domains is not None:
        for d in np.unique(domains):
            sel = domains == d
            out[f"acc_d{d}"] = float(np.mean(y_hat[sel] == y_gt[sel]))
            out[f"mae_d{d}"] = float(np.mean(np.abs(len_hat[sel] - len_gt[sel])))
    return out
