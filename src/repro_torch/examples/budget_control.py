"""Budget-aware control (Fig. 8 / Appendix D): hand SCOPE a set-level
dollar budget via ``SetBudgetPolicy``; it solves for alpha* with the
Prop. D.1 finite breakpoint search and routes within the budget.  Every
budget in the sweep reuses the same cached pool predictions — one estimator
pass for the whole figure (the twin of ``examples/budget_control.py``).

  PYTHONPATH=src python -m repro_torch.examples.budget_control --device cpu
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.api import (EngineConfig, RouteRequest, ScopeEngine,
                             SetBudgetPolicy)
from repro_torch.configs.scope_estimator import TINY
from repro_torch.core.estimator import ReasoningEstimator
from repro_torch.examples import parser
from repro_torch.launch.train import build_world
from repro_torch.models import model as M
from repro_torch.training.sft import build_sft_dataset, train_sft


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    world, data, lib, retr = build_world(400, 150, seed=0,
                                         device=args.device)
    params = M.init_params(TINY, seed=0, device=args.device)
    ds = build_sft_dataset(data, lib, retr, max_examples=2500)
    params, _ = train_sft(params, TINY, ds, steps=200, batch_size=32)

    engine = ScopeEngine.build(EngineConfig(
        estimator=ReasoningEstimator(TINY, params), retriever=retr,
        library=lib, models_meta={m: world.models[m] for m in data.models}))
    qids = data.test_qids[:24]
    queries = [data.queries[int(q)] for q in qids]
    pool = engine.predict(RouteRequest(queries))

    lo = float(pool.cost_hat.min(1).sum())
    hi = float(pool.cost_hat.max(1).sum())
    print(f"feasible cost range for {len(qids)} queries: "
          f"${lo:.4f} .. ${hi:.4f}")
    for budget in np.geomspace(lo * 1.1, hi, 5):
        rep = engine.serve(data, qids, SetBudgetPolicy(float(budget)))
        print(f"budget=${budget:.4f} -> alpha*={rep.alpha:.3f} "
              f"predicted=${rep.info['expected_cost']:.4f} "
              f"realized=${rep.total_cost:.4f} acc={rep.accuracy:.2f} "
              f"cache={rep.cache_hits}h/{rep.cache_misses}m")


if __name__ == "__main__":
    main(sys.argv[1:])
