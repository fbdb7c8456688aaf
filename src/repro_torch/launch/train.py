"""End-to-end SCOPE estimator training CLI: the port of
``repro/launch/train.py``.

Runs the paper's full three-stage pipeline on the world simulator:
  1. fingerprint the seen pool on the anchor set,
  2. SFT via hindsight distillation,
  3. GRPO with the gated composite reward,
then evaluates predictive accuracy on the held-out split and saves a
checkpoint (the reference's ``.npz`` format).  Runs on the card unless
``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --size tiny \\
      --sft-steps 300 --grpo-steps 50 --out checkpoints/scope_tiny
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.scope_estimator import TINY
from repro_torch.core import serialization
from repro_torch.core.estimator import ReasoningEstimator
from repro_torch.core.evaluation import predictive_metrics
from repro_torch.core.fingerprint import FingerprintLibrary, build_anchor_set
from repro_torch.core.retrieval import AnchorRetriever
from repro_torch.data.datasets import build_scope_data, stratified_anchors
from repro_torch.data.worldsim import World
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.training import checkpoint
from repro_torch.training.grpo import GRPOConfig, GRPOTrainer
from repro_torch.training.sft import build_sft_dataset, train_sft


def estimator_config(size: str):
    if size == "tiny":
        return TINY
    if size == "100m":
        return dataclasses.replace(
            TINY, name="scope-100m", num_layers=12, d_model=768, num_heads=12,
            num_kv_heads=4, head_dim=64, d_ff=2304)
    if size == "qwen3-4b":
        return get_config("scope-qwen3-4b")
    raise ValueError(size)


def build_world(n_queries: int, n_anchors: int, seed: int,
                device: DeviceLike = None):
    """World, data, fingerprint library and a retriever on ``device``."""
    world = World(seed=seed)
    seen = [m.name for m in world.pool if m.seen]
    data = build_scope_data(world, n_queries=n_queries, seed=seed)
    aset = build_anchor_set(world, stratified_anchors(world, n=n_anchors,
                                                      seed=seed + 7))
    lib = FingerprintLibrary(aset)
    for m in seen:
        lib.onboard(world, m, seed=seed + 13)
    retr = AnchorRetriever(aset, device=device)
    return world, data, lib, retr


def evaluate(cfg, params, data, lib, retr, *, k=5, n_eval=64, cot=True):
    world = data.world
    est = ReasoningEstimator(cfg, params, cot=cot)
    qids = data.test_qids[:n_eval]
    queries = [data.queries[q] for q in qids]
    embs = np.stack([world.embed(q) for q in queries])
    sims, idx = retr.retrieve(embs, k)
    mi = {m: i for i, m in enumerate(data.models)}
    prompts, gts, doms = [], [], []
    for qi, q in enumerate(queries):
        for m in data.models:
            prompts.append(serialization.serialize_prompt(
                world.models[m], mi[m], lib.anchor_set, lib.get(m),
                sims[qi], idx[qi], q))
            r = data.record(q.qid, m)
            gts.append((r.y, r.tokens))
            doms.append(q.domain)
    preds = est.predict(prompts)
    y_hat = np.array([p.y_hat for p in preds])
    len_hat = np.array([p.len_hat for p in preds])
    y_gt = np.array([g[0] for g in gts])
    len_gt = np.array([g[1] for g in gts])
    m = predictive_metrics(y_hat, y_gt, len_hat, len_gt, np.array(doms))
    m["well_formed"] = float(np.mean([p.well_formed for p in preds]))
    m["mean_pred_tokens"] = float(np.mean([p.pred_tokens for p in preds]))
    return m


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="tiny",
                    choices=["tiny", "100m", "qwen3-4b"])
    ap.add_argument("--queries", type=int, default=800)
    ap.add_argument("--anchors", type=int, default=250)
    ap.add_argument("--sft-steps", type=int, default=300)
    ap.add_argument("--sft-examples", type=int, default=4000)
    ap.add_argument("--grpo-steps", type=int, default=40)
    ap.add_argument("--no-cot", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card, "
                         "cuda:0; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    t0 = time.time()
    dev = resolve_device(args.device)
    cfg = estimator_config(args.size)
    cot = not args.no_cot
    world, data, lib, retr = build_world(args.queries, args.anchors,
                                         args.seed, dev)
    print(f"[{time.time()-t0:6.1f}s] world ready: "
          f"{len(data.queries)} queries x {len(data.models)} models")

    ds = build_sft_dataset(data, lib, retr, cot=cot,
                           max_examples=args.sft_examples, seed=args.seed)
    print(f"[{time.time()-t0:6.1f}s] SFT dataset {ds['tokens'].shape}")
    params = M.init_params(cfg, seed=args.seed, device=dev)
    params, losses = train_sft(params, cfg, ds, steps=args.sft_steps,
                               batch_size=64, verbose=True)
    print(f"[{time.time()-t0:6.1f}s] SFT done: loss "
          f"{np.mean(losses[:10]):.3f} -> {np.mean(losses[-10:]):.3f}")

    if args.grpo_steps > 0:
        trainer = GRPOTrainer(
            cfg, params, data, lib, retr, gcfg=GRPOConfig(), cot=cot,
            seed=args.seed,
            generator=torch.Generator(device=dev).manual_seed(args.seed))
        trainer.train(args.grpo_steps, verbose=True)
        params = trainer.params
        hist = trainer.reward_history
        del trainer                    # its reference params and moments
        print(f"[{time.time()-t0:6.1f}s] GRPO done: reward "
              f"{np.mean(hist[:5]):.3f} -> {np.mean(hist[-5:]):.3f}")

    metrics = evaluate(cfg, params, data, lib, retr, cot=cot)
    print(f"[{time.time()-t0:6.1f}s] eval: "
          + json.dumps({k: round(v, 4) for k, v in metrics.items()
                        if not k.startswith(("acc_d", "mae_d"))}))
    if args.out:
        checkpoint.save(args.out, params)
        print(f"checkpoint -> {args.out}.npz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
