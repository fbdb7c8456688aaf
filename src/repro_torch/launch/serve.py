"""SCOPE routing service CLI on the ``repro_torch.api`` surface: the port
of ``repro/launch/serve.py``, with the same flags and output plus
``--device`` (default: the card; ``cpu`` runs the kernels' plain
versions).  ``--mesh`` shards the estimator over every process of the
``torchrun`` world, one a device (NCCL on the card, gloo with ``--device
cpu``); every rank serves the same stream, and rank 0 prints the report
once every rank's report agrees with its own.

Loads (or quickly trains) an estimator, assembles a ``ScopeEngine``,
fingerprints the pool — including the unseen OOD models, which need NO
retraining — and serves a batch of queries under a chosen routing policy.

  PYTHONPATH=src python -m repro_torch.launch.serve --alpha 0.6
  PYTHONPATH=src python -m repro_torch.launch.serve --budget 0.5 --ood
  PYTHONPATH=src python -m repro_torch.launch.serve --accuracy-floor 0.7
  PYTHONPATH=src python -m repro_torch.launch.serve --cost-ceiling 0.002
  PYTHONPATH=src python -m repro_torch.launch.serve --stream-ticks 12 \
      --max-queue-ms 5 --min-fill 0.5
  PYTHONPATH=src python -m repro_torch.launch.serve --stream-ticks 12 \
      --refill --segment-len 4
  PYTHONPATH=src python -m repro_torch.launch.serve --stream-ticks 12 \
      --refill --kv-paged --kv-page-size 16
  PYTHONPATH=src python -m repro_torch.launch.serve --stream-ticks 12 \
      --max-pending 2
  PYTHONPATH=src python -m repro_torch.launch.serve --stream-ticks 12 \
      --chaos 0 --max-retries 2 --deadline-ms 500
  PYTHONPATH=src python -m repro_torch.launch.serve --stream-ticks 12 \
      --tier0 --escalation-threshold 0.9
  PYTHONPATH=src python -m repro_torch.launch.serve --stream-ticks 12 \
      --drift-detect --drift-threshold 5.0
  PYTHONPATH=src python -m repro_torch.launch.serve --stream-ticks 12 \
      --refill --hot-swap
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --device cpu --checkpoint ck --mesh
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.api import (
    AccuracyFloorPolicy, CostCeilingPolicy, EngineConfig, FixedAlphaPolicy,
    ScopeEngine, SetBudgetPolicy)
from repro_torch.core.estimator import ReasoningEstimator
from repro_torch.data.datasets import build_scope_data
from repro_torch.device import resolve_device
from repro_torch.launch.train import build_world, estimator_config
from repro_torch.models import model as M
from repro_torch.training import checkpoint
from repro_torch.training.sft import build_sft_dataset, train_sft


def pick_policy(args):
    if args.budget is not None:
        return SetBudgetPolicy(args.budget)
    if args.accuracy_floor is not None:
        return AccuracyFloorPolicy(args.accuracy_floor)
    if args.cost_ceiling is not None:
        return CostCeilingPolicy(
            args.cost_ceiling,
            alpha=args.alpha if args.alpha is not None else 0.6)
    return FixedAlphaPolicy(args.alpha if args.alpha is not None else 0.6)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="tiny")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--budget", type=float, default=None,
                    help="set-level $ budget (SetBudgetPolicy)")
    ap.add_argument("--accuracy-floor", type=float, default=None,
                    help="expected-accuracy floor (AccuracyFloorPolicy)")
    ap.add_argument("--cost-ceiling", type=float, default=None,
                    help="per-query $ cap (CostCeilingPolicy)")
    ap.add_argument("--ood", action="store_true",
                    help="route over the unseen (OOD) model pool")
    ap.add_argument("--queries", type=int, default=48)
    ap.add_argument("--stream-ticks", type=int, default=0,
                    help="serve as N streaming traffic ticks through the "
                         "bucketed microbatch scheduler (0 = one batch)")
    ap.add_argument("--max-queue-ms", type=float, default=None,
                    help="deadline flush: emit a partially-filled bucket "
                         "rather than queue a prompt longer than this")
    ap.add_argument("--min-fill", type=float, default=0.0,
                    help="occupancy flush: emit once a length queue covers "
                         "this fraction of the largest batch bucket")
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable double-buffered dispatch (synchronous "
                         "microbatch execution)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="pipelining depth: microbatches in flight before "
                         "the oldest is block-parsed (default 1 with "
                         "overlap, 0 without; 2 interleaves prefill of "
                         "N+1 with decode of N on real accelerators)")
    ap.add_argument("--refill", action="store_true",
                    help="segment-chunked continuous batching: refill "
                         "drained-at-EOS decode slots from the queue "
                         "between scan segments instead of retiring "
                         "microbatches whole")
    ap.add_argument("--segment-len", type=int, default=None,
                    help="decode steps per scan segment in --refill mode "
                         "(default 4; drained slots admit new prompts at "
                         "segment boundaries)")
    ap.add_argument("--kv-paged", action="store_true",
                    help="block-paged decode KV cache (--refill only): "
                         "pool-backed pages instead of a dense per-slot "
                         "horizon — KV memory scales with live tokens and "
                         "admission gates on free pages")
    ap.add_argument("--kv-page-size", type=int, default=16,
                    help="token positions per KV page in --kv-paged mode "
                         "(default 16; smaller pages = less last-page "
                         "waste, bigger page tables)")
    ap.add_argument("--kv-pool-pages", type=int, default=None,
                    help="KV pool size in pages in --kv-paged mode "
                         "(default: auto-size each slot state to its "
                         "bucket's dense worst case)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard the estimator over the torchrun world "
                         "(make_serve_mesh: data-parallel, FSDP params)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="failed microbatch/segment rows are requeued and "
                         "retried up to this many times before quarantine")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request SLO: a prompt older than this "
                         "(queued + in flight) is answered immediately in "
                         "degraded mode from retrieval priors")
    ap.add_argument("--no-degrade", action="store_true",
                    help="mark quarantined/expired pairs FAILED instead of "
                         "answering them from retrieval priors")
    ap.add_argument("--chaos", type=int, default=None,
                    help="inject a deterministic fault plan seeded with "
                         "this value (FaultPlan.seeded: dispatch/segment/"
                         "parse/pool failures at ~10%% rates) into the "
                         "stream — requires --stream-ticks")
    ap.add_argument("--tier0", action="store_true",
                    help="two-tier routing: distill a tier-0 pre-router "
                         "head from the estimator and answer high-"
                         "confidence (query, model) pairs in one batched "
                         "forward; only the rest pay the reasoning decode")
    ap.add_argument("--escalation-threshold", type=float, default=0.9,
                    help="tier-0 confidence max(p, 1-p) below which a pair "
                         "escalates to the reasoning decode (<= 0.5 "
                         "escalates nothing, > 1.0 escalates everything)")
    ap.add_argument("--tier0-steps", type=int, default=300,
                    help="distillation steps for the --tier0 head")
    ap.add_argument("--drift-detect", action="store_true",
                    help="self-healing serving: record every executed "
                         "(predicted, observed) outcome in a replay buffer, "
                         "run a per-model Page-Hinkley drift detector over "
                         "the calibration residuals, quarantine alarmed "
                         "models (DriftAwarePolicy routes around them) "
                         "until onboard(refresh=True) heals them")
    ap.add_argument("--drift-threshold", type=float, default=5.0,
                    help="Page-Hinkley alarm mass for --drift-detect "
                         "(residual mass a model must accumulate above its "
                         "running mean before the alarm fires; default 5.0)")
    ap.add_argument("--hot-swap", action="store_true",
                    help="demo a live estimator hot-swap halfway through "
                         "the stream: donate the params under a bumped "
                         "estimator_version at a tick boundary — in-flight "
                         "rows finish on the old params, queued rows "
                         "dispatch on the new, the prediction cache and "
                         "stale tier-0 stashes invalidate for free — "
                         "requires --stream-ticks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card, "
                         "cuda:0; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    if not args.mesh:
        return serve(ap, args, resolve_device(args.device), print)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    dev = init_distributed(args.device)
    rank0 = dist.get_rank() == 0
    try:
        return serve(ap, args, dev,
                     print if rank0 else lambda *a, **k: None)
    finally:
        dist.destroy_process_group()


def check_agreed(report: dict) -> None:
    """Raise unless every rank of the process group holds this report.
    Queue ages are each rank's own clock readings and are left out of the
    comparison."""
    import copy

    import torch.distributed as dist
    mine = copy.deepcopy(report)
    if "scheduler" in mine:
        mine["scheduler"].pop("queue_age_ms", None)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    bad = [r for r, other in enumerate(every) if other != mine]
    if bad:
        raise RuntimeError(f"ranks {bad} served another report than rank "
                           f"{dist.get_rank()}")


def report_out(args, report: dict, say) -> None:
    """Print the JSON report; under ``--mesh`` once every rank agrees."""
    if args.mesh:
        check_agreed(report)
    say(json.dumps(report, indent=2))


def serve(ap, args, dev, say) -> int:
    """The serve on ``dev``; ``say`` prints (rank 0's ``print`` under a
    mesh, nothing on the other ranks)."""
    cfg = estimator_config(args.size)
    world, data, lib, retr = build_world(600, 250, args.seed, dev)
    params = M.init_params(cfg, seed=args.seed, device=dev)
    if args.checkpoint:
        params = checkpoint.load(args.checkpoint, params)
    else:
        say("no checkpoint given - quick SFT bootstrap...")
        ds = build_sft_dataset(data, lib, retr, max_examples=3000,
                               seed=args.seed)
        params, _ = train_sft(params, cfg, ds, steps=250, batch_size=64)

    if args.kv_paged and not args.refill:
        ap.error("--kv-paged requires --refill (the whole-retire runtime "
                 "keeps dense per-microbatch caches)")
    if args.kv_page_size < 1:
        ap.error(f"--kv-page-size must be >= 1, got {args.kv_page_size}")

    if args.hot_swap and args.stream_ticks <= 0:
        ap.error("--hot-swap requires --stream-ticks (the swap lands at a "
                 "live tick boundary)")

    fault_plan = None
    if args.chaos is not None:
        if args.stream_ticks <= 0:
            ap.error("--chaos requires --stream-ticks (faults are injected "
                     "at the streaming serve boundaries)")
        from repro_torch.serving.faults import FaultPlan
        fault_plan = FaultPlan.seeded(
            args.chaos, rates={"dispatch": 0.1, "segment": 0.1,
                               "parse": 0.1, "pool": 0.1})

    estimator = ReasoningEstimator(cfg, params)
    tier0_head = None
    if args.tier0:
        from repro_torch.training.tier0 import distill_tier0
        say("distilling tier-0 pre-router from the estimator...")
        tier0_head = distill_tier0(data, lib, retr, estimator,
                                   max_pairs=3000, steps=args.tier0_steps,
                                   seed=args.seed, device=dev)
        say(f"# tier-0 calibration temperature "
            f"{tier0_head.temperature:.3f}")

    engine = ScopeEngine.build(EngineConfig(
        estimator=estimator, retriever=retr,
        library=lib, models_meta={m: world.models[m] for m in data.models},
        kv_paged=args.kv_paged, kv_page_size=args.kv_page_size,
        kv_pool_pages=args.kv_pool_pages,
        max_retries=args.max_retries, deadline_ms=args.deadline_ms,
        degrade=not args.no_degrade, fault_plan=fault_plan,
        tier0=tier0_head,
        escalation_threshold=args.escalation_threshold,
        drift_detect=args.drift_detect,
        drift_threshold=args.drift_threshold))

    if args.kv_paged and args.kv_pool_pages is not None:
        # a request admitted at a boundary may decode its whole budget:
        # a pool that cannot page even a minimal such row can never admit
        seg = args.segment_len or 4
        budget = int(engine.estimator.max_new_tokens)
        budget_steps = -(-budget // seg) * seg
        min_pages = -(-(1 + budget_steps) // args.kv_page_size)
        if args.kv_pool_pages < min_pages:
            raise ValueError(
                f"--kv-pool-pages {args.kv_pool_pages} is too small to "
                f"admit a single full-budget row: a 1-token prompt "
                f"decoding {budget_steps} budget steps needs "
                f"{min_pages} pages of {args.kv_page_size} tokens")

    if args.ood:
        pool = [m.name for m in world.pool if not m.seen]
        # training-free onboarding: fingerprints only, no weight updates
        for m in pool:
            engine.onboard(world, m, seed=args.seed + 99)
        data = build_scope_data(world, n_queries=300, models=pool,
                                seed=args.seed + 1, difficulty_shift=0.9)
    else:
        pool = data.models

    if args.mesh:
        from repro_torch.launch.mesh import make_serve_mesh
        mesh = make_serve_mesh()
        engine.estimator.shard(mesh)
        say(f"# estimator sharded over "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))}")

    policy = pick_policy(args)
    if args.drift_detect:
        from repro_torch.api import DriftAwarePolicy
        policy = DriftAwarePolicy(policy)
    qids = [int(q) for q in data.test_qids[: args.queries]]

    if args.stream_ticks > 0:
        from repro_torch.serving.scheduler import MicrobatchScheduler
        sched = MicrobatchScheduler(
            max_queue_age=(None if args.max_queue_ms is None
                           else args.max_queue_ms / 1e3),
            min_fill=args.min_fill)
        chunks = [[int(q) for q in c]
                  for c in np.array_split(qids, args.stream_ticks)]
        swap_at = len(chunks) // 2 if args.hot_swap else None
        reports = []
        for i, r in enumerate(engine.serve_stream(
                data, chunks, policy, models=pool, scheduler=sched,
                overlap=not args.no_overlap, refill=args.refill,
                segment_len=args.segment_len,
                max_pending=args.max_pending)):
            reports.append(r)
            if swap_at is not None and i + 1 == swap_at:
                # live swap between ticks: same params pytree donated
                # under a bumped version — the point is the serve-path
                # machinery (cache space, dedup keys, tier-0 stashes all
                # roll over), not new weights.  A tier-0 head rides along
                # re-tempered on the replay buffer's observed outcomes.
                t0 = engine.config.tier0
                if (t0 is not None and engine.monitor is not None
                        and len(engine.monitor.buffer)):
                    from repro_torch.training.tier0 import recalibrate_tier0
                    rows = engine.monitor.buffer.rows()
                    t0 = recalibrate_tier0(
                        t0,
                        np.asarray([o.predicted_p for o in rows]),
                        np.asarray([o.observed_y for o in rows]))
                version = engine.config.estimator_version + "+swap"
                engine.hot_swap(engine.estimator, version, tier0=t0)
                swap_at = None
                say(f"# hot-swapped estimator to {version!r} "
                    f"after tick {i + 1}")
        n = sum(r.n_queries for r in reports)
        report_out(args, {
            "policy": policy.name,
            "ticks": [{"queries": r.n_queries,
                       "accuracy": round(r.accuracy, 3),
                       "cost_usd": round(r.total_cost, 4)}
                      for r in reports],
            "accuracy": sum(r.accuracy * r.n_queries
                            for r in reports) / max(n, 1),
            "total_cost_usd": round(sum(r.total_cost for r in reports), 4),
            "scheduler": sched.stats.as_dict(),
        }, say)
        return 0

    report = engine.serve(data, qids, policy, models=pool)
    report_out(args, {
        "policy": report.policy,
        "alpha": report.alpha,
        "accuracy": report.accuracy,
        "total_cost_usd": round(report.total_cost, 4),
        "exec_tokens": report.exec_tokens,
        "prediction_overhead_tokens": report.overhead_tokens,
        "cache": {"hits": report.cache_hits, "misses": report.cache_misses},
        "portfolio": {k: round(v, 3) for k, v in
                      report.per_model_share.items() if v > 0},
    }, say)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
