"""Serve a batch of requests through the ``repro_torch.api`` surface,
including training-free onboarding of unseen (OOD) models — the paper's
headline generalization mechanism — and cached re-serving (the twin of
``examples/serve_router.py``).

The flow demonstrates the two claims the API is built around:
  1. scalable pool growth: after an initial serve, onboarding a new model
     and re-serving the same batch reuses every cached (query, model)
     estimate — the estimator runs only for the new model's pairs;
  2. controllable trade-offs: the same batch is served under several
     distinct ``RoutingPolicy`` implementations, no router internals touched.

  PYTHONPATH=src python -m repro_torch.examples.serve_router --device cpu
"""
from __future__ import annotations

import sys

from repro_torch.api import (AccuracyFloorPolicy, CostCeilingPolicy,
                             EngineConfig, FixedAlphaPolicy, ScopeEngine,
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

    # ---- initial serve over the seen pool (cold cache) ----
    qids = data.test_qids[:16]
    rep = engine.serve(data, qids, FixedAlphaPolicy(0.7))
    print(f"[seen pool]   acc={rep.accuracy:.2f} cost=${rep.total_cost:.4f} "
          f"overhead={rep.overhead_tokens}tok "
          f"cache={rep.cache_hits}h/{rep.cache_misses}m")

    # ---- onboard the unseen models mid-session: fingerprints only, ----
    # ---- no retraining; re-serving reuses every cached estimate     ----
    unseen = [m.name for m in world.pool if not m.seen]
    for m in unseen:
        engine.onboard(world, m, seed=99)
    data.extend_models(unseen, seed=99)
    rep2 = engine.serve(data, qids, FixedAlphaPolicy(0.7))
    assert rep2.cache_misses == len(qids) * len(unseen), \
        "estimator must run only for the onboarded models' pairs"
    share = {k: round(v, 2) for k, v in rep2.per_model_share.items() if v > 0}
    print(f"[+{len(unseen)} unseen] acc={rep2.accuracy:.2f} "
          f"cost=${rep2.total_cost:.4f} overhead={rep2.overhead_tokens}tok "
          f"cache={rep2.cache_hits}h/{rep2.cache_misses}m "
          f"portfolio={share}")

    # ---- same batch, distinct control policies (now fully cached) ----
    budget = rep2.total_cost * 0.5
    ceiling = float(max(d.cost_hat for d in rep2.decisions))
    for policy in (FixedAlphaPolicy(0.3),
                   SetBudgetPolicy(budget),
                   AccuracyFloorPolicy(0.6),
                   CostCeilingPolicy(ceiling * 0.25, alpha=0.7)):
        r = engine.serve(data, qids, policy)
        assert r.cache_misses == 0, "policy sweep must be estimator-free"
        extra = {k: v for k, v in r.info.items()
                 if k in ("feasible", "fallback_queries")}
        alpha = r.alpha if r.alpha is None else round(r.alpha, 3)
        print(f"[{policy.name:>14}] alpha={alpha} acc={r.accuracy:.2f} "
              f"cost=${r.total_cost:.4f} {extra}")


if __name__ == "__main__":
    main(sys.argv[1:])
