"""Quickstart: build a world, fingerprint a model pool, train a tiny SCOPE
estimator with hindsight-distillation SFT, and route a few queries through
the ``repro_torch.api`` surface (the twin of ``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.api import EngineConfig, FixedAlphaPolicy, ScopeEngine
from repro_torch.configs.scope_estimator import TINY
from repro_torch.core.estimator import ReasoningEstimator
from repro_torch.core.fingerprint import FingerprintLibrary, build_anchor_set
from repro_torch.core.retrieval import AnchorRetriever
from repro_torch.data.datasets import build_scope_data, stratified_anchors
from repro_torch.data.worldsim import World
from repro_torch.device import resolve_device
from repro_torch.examples import parser
from repro_torch.models import model as M
from repro_torch.training.sft import build_sft_dataset, train_sft


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    # 1. the model pool world and the SCOPE-60K-style interaction corpus
    world = World(seed=0)
    data = build_scope_data(world, n_queries=400, seed=0)
    print(f"pool: {data.models}")

    # 2. SCOPE-250-style anchors + behavioral fingerprints (Eq. 1)
    anchors = build_anchor_set(world, stratified_anchors(world, n=150))
    library = FingerprintLibrary(anchors)
    for m in data.models:
        library.onboard(world, m)
    retriever = AnchorRetriever(anchors, device=dev)

    # 3. Stage-1 training: SFT via hindsight distillation (§4.3)
    ds = build_sft_dataset(data, library, retriever, max_examples=2500)
    params = M.init_params(TINY, seed=0, device=dev)
    params, losses = train_sft(params, TINY, ds, steps=200, batch_size=32)
    print(f"SFT loss {np.mean(losses[:10]):.2f} -> {np.mean(losses[-10:]):.2f}")

    # 4. assemble the engine and serve held-out queries at two trade-offs
    engine = ScopeEngine.build(EngineConfig(
        estimator=ReasoningEstimator(TINY, params), retriever=retriever,
        library=library,
        models_meta={m: world.models[m] for m in data.models}))
    qids = data.test_qids[:8]
    for alpha in (0.0, 1.0):
        rep = engine.serve(data, qids, FixedAlphaPolicy(alpha))
        picked = [d.model for d in rep.decisions[:4]]
        print(f"alpha={alpha:.1f}: acc={rep.accuracy:.2f} "
              f"cost=${rep.total_cost:.4f} picked={picked}")


if __name__ == "__main__":
    main(sys.argv[1:])
