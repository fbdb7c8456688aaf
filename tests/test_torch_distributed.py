"""Serving over a device mesh on the CPU: ``ReasoningEstimator.shard`` over
gloo ranks spawned as processes (one thread each), against one process of
the port and the reference's one-device run on the bridged weights of the
SFT-trained tiny estimator.

Every rank runs ``serve_cases`` once at world 2 and once at world 4 and
writes its results; the tests read them: batch ``predict`` (28 pairs, split
over the ranks), a batch of 21 pairs that divides over neither world (every
rank computes it whole), the twin of the reference's sharded stream script
(whole-retire, buckets (4, 8)), dense and paged refill, a MoE estimator
(computed whole on every rank), and, at world 4 over a (2, 2) mesh, each
rank's block of a tensor under the sharding specs.  Tokens, parsed fields,
decisions and cache counts must equal one process's, and the reference's
one-device run's; ``p_hat`` within 2e-5 of both (not bitwise: a rank's
products have fewer rows than one process's, and p_hat parts at ~1e-7);
and every rank must return the same results, bit for bit.

Run as a script, this file is one rank's worker:

  RANK=0 WORLD_SIZE=2 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
      python tests/test_torch_distributed.py OUT_DIR PARAMS.npz
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
NEW_TOKENS = 6
F32_TOL = 2e-5
POOL_EXACT = ("models", "y_hat", "well_formed", "pred_overhead", "status",
              "len_hat", "cost_hat", "cache", "choices")
STAT_FIELDS = ("submitted", "emitted", "microbatches", "slots_refilled",
               "slot_steps_total", "slot_steps_active", "refill_steps_saved",
               "pages_peak", "kv_peak_tokens", "admissions_deferred_on_pages",
               "admissions_deferred_on_horizon")
# (shape, spec) of the block checks on the (2, 2) mesh
BLOCKS = [((8, 6), ("data", "model")), ((8, 6), ("model", None)),
          ((4, 8), (None, ("data", "model"))), ((2, 4, 8), (None, "data",
                                                            "model")),
          ((6, 4), (None, None))]


# ---------------------------------------------------------------------------
# the worker (one rank) and the single-process run share serve_cases
# ---------------------------------------------------------------------------
def _pool(pool, eng, policy_cls):
    return {"models": list(pool.models),
            "y_hat": pool.y_hat.tolist(),
            "well_formed": pool.well_formed.tolist(),
            "pred_overhead": pool.pred_overhead.tolist(),
            "status": pool.status.tolist(),
            "p_hat": pool.p_hat.tolist(),
            "len_hat": pool.len_hat.tolist(),
            "cost_hat": pool.cost_hat.tolist(),
            "cache": [pool.cache_hits, pool.cache_misses],
            "choices": policy_cls(0.6).decide(pool, eng).choices.tolist()}


def serve_cases(params_path, mesh=None):
    """The port's results of every case, sharded over ``mesh`` (a serve
    mesh of the process group) or in one process (``mesh=None``)."""

    from repro_torch import api, io
    from repro_torch.configs import get_config
    from repro_torch.configs.scope_estimator import TINY
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.core.fingerprint import (FingerprintLibrary,
                                              build_anchor_set)
    from repro_torch.core.retrieval import AnchorRetriever
    from repro_torch.data.datasets import build_scope_data, stratified_anchors
    from repro_torch.data.worldsim import World
    from repro_torch.models import model as M
    from repro_torch.serving import sampler
    from repro_torch.serving.scheduler import BucketConfig, MicrobatchScheduler
    from repro_torch.distributed import collectives as coll
    from repro_torch.training.grpo import GRPOConfig, GRPOTrainer
    from repro_torch.training.tier0 import distill_tier0

    params = io.load_checkpoint(str(params_path), TINY, device="cpu")
    world = World(seed=0)
    data = build_scope_data(world, n_queries=200, seed=0)
    anchors = build_anchor_set(world, stratified_anchors(world, n=80, seed=7))
    retr = AnchorRetriever(anchors, device="cpu")
    queries = [data.queries[int(q)] for q in data.test_qids[:7]]

    def library():
        lib = FingerprintLibrary(anchors)
        for m in world.pool:
            if m.seen:
                lib.onboard(world, m.name, seed=3)
        return lib

    def estimator():
        est = ReasoningEstimator(TINY, params, max_new_tokens=NEW_TOKENS)
        return est if mesh is None else est.shard(mesh)

    def mk(**kw):
        return api.ScopeEngine.build(api.EngineConfig(
            estimator=estimator(), retriever=retr, library=library(),
            models_meta={m: world.models[m] for m in data.models}, **kw))

    def pool(p, eng):
        return _pool(p, eng, api.FixedAlphaPolicy)

    def stream(eng, ticks, buckets):
        sched = MicrobatchScheduler(BucketConfig(batch_sizes=buckets))
        pools = list(eng.predict_stream(
            (api.RouteRequest(t) for t in ticks), scheduler=sched))
        return {"pools": [pool(p, eng) for p in pools],
                "stats": {f: getattr(sched.stats, f) for f in STAT_FIELDS}}

    def span(rows):
        return None if rows is None else [rows.start, rows.stop]

    out = {}
    eng = mk()
    out["predict"] = dict(
        pool(eng.predict(api.RouteRequest(queries[:4])), eng),
        rows=span(eng.estimator.local_rows(28)))
    out["replicated"] = dict(
        pool(eng.predict(api.RouteRequest(queries[4:7])), eng),
        rows=span(eng.estimator.local_rows(21)))
    out["stream"] = stream(mk(), [queries[:1], queries[1:4]], (4, 8))
    ticks = [queries[:2], queries[2:3], queries[3:6]]
    out["refill_dense"] = stream(mk(refill=True), ticks, (1, 2, 4, 8))
    out["refill_paged"] = stream(mk(refill=True, kv_paged=True,
                                    kv_page_size=8), ticks, (1, 2, 4, 8))
    # a hot swap between the first two ticks, to a second sharded estimator
    eng = mk(refill=True)
    pools = []
    for p in eng.predict_stream((api.RouteRequest(t) for t in ticks),
                                scheduler=MicrobatchScheduler(BucketConfig(
                                    batch_sizes=(1, 2, 4, 8)))):
        pools.append(pool(p, eng))
        if len(pools) == 1:
            eng.hot_swap(estimator(), "swapped")
    out["hot_swap"] = {"pools": pools}
    # tier-0 distilled from a sharded estimator's labels
    head = distill_tier0(data, library(), retr, estimator(), max_pairs=64,
                         steps=5, seed=0, device="cpu")
    out["tier0"] = {"temperature": head.temperature,
                    "sums": {k: float(v.double().sum())
                             for k, v in sorted(head.params.items())}}
    # a greedy GRPO step of the estimator's params (sharded on a mesh)
    trainer = GRPOTrainer(TINY, estimator().params, data, library(), retr,
                          gcfg=GRPOConfig(group_size=2, tasks_per_step=2,
                                          max_new_tokens=4, temperature=0.0))
    info = trainer.rollout_step()
    out["grpo"] = {"loss": info["loss"], "reward": info["reward"],
                   "kl": info["kl"], "step": trainer.opt_state.step,
                   "sharded": sorted({coll.is_sharded(t) for t in
                                      io.flatten(trainer.params).values()})}

    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    est = ReasoningEstimator(cfg, M.init_params(cfg, seed=0, device="cpu"),
                             max_new_tokens=4)
    prompts = np.random.default_rng(0).integers(
        3, cfg.vocab_size, (8, 12)).tolist()
    if mesh is not None:
        est.shard(mesh)
    gen, dec = sampler.to_host(*est.dispatch_batch(prompts).chunks[0])
    out["moe"] = {"tokens": gen.tolist(), "logits": dec.tolist(),
                  "rows": span(est.local_rows(8))}
    return out


def block_cases():
    """Each (shape, spec) of ``BLOCKS`` distributed over a (2, 2) mesh:
    this rank's coordinate and block (the arange values it holds)."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_serve_mesh
    mesh = make_serve_mesh(n_data=2, n_model=2)
    out = []
    for shape, spec in BLOCKS:
        x = torch.arange(int(np.prod(shape))).reshape(shape)
        local = distribute_tensor(x, mesh, shd.placements(mesh, spec))
        out.append(local.to_local().tolist())
    batch = shard_batch({"tokens": np.arange(24, dtype=np.int32).reshape(
        8, 3)}, mesh, ("data", None))["tokens"]
    return {"coord": list(mesh.get_coordinate()), "blocks": out,
            "batch": [str(batch.dtype), batch.to_local().tolist()]}


def worker(out_dir: str, params_path: str) -> None:
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_serve_mesh
    init_distributed("cpu")
    try:
        out = serve_cases(params_path, make_serve_mesh())
        if dist.get_world_size() == 4:
            out["blocks"] = block_cases()
        with open(Path(out_dir) / f"rank{dist.get_rank()}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# spawning the ranks
# ---------------------------------------------------------------------------
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(world: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def start(world: int, out_dir: Path, params_path: Path):
    """The ``world`` ranks of a gloo world, started."""
    env = rank_env(world)
    return [subprocess.Popen(
        [sys.executable, __file__, str(out_dir), str(params_path)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def collect(procs, out_dir: Path):
    """Each rank's results, once every rank exited 0."""
    errs = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            errs.append(f"rank {r} exit {p.returncode}: {err[-3000:]}")
    assert not errs, "\n".join(errs)
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def params_path(tiny_trained, tmp_path_factory):
    import jax

    from repro_torch import io
    from repro_torch.configs.scope_estimator import TINY
    from repro_torch.training import checkpoint
    _, params, _ = tiny_trained
    path = tmp_path_factory.mktemp("mesh") / "tiny.npz"
    checkpoint.save(str(path), io.params_from_numpy(
        jax.tree.map(np.asarray, params), TINY, device="cpu"))
    return path


@pytest.fixture(scope="module")
def runs(params_path, tmp_path_factory):
    """{world: [rank results]} at worlds 2 and 4, both worlds started at
    once, and the one-process results (run meanwhile) under key 1."""
    dirs = {w: tmp_path_factory.mktemp(f"world{w}") for w in (2, 4)}
    started = {w: start(w, dirs[w], params_path) for w in (2, 4)}
    out = {1: [json.loads(json.dumps(serve_cases(params_path)))]}
    for w, procs in started.items():
        out[w] = collect(procs, dirs[w])
    return out


@pytest.fixture(scope="module")
def reference(tiny_trained, scope_data, anchor_set, retriever):
    """The reference's one-device results of the cases, on the same world
    and weights (``repro.api``)."""
    from repro import api as japi
    from repro.core.estimator import ReasoningEstimator as JEstimator
    from repro.core.fingerprint import FingerprintLibrary as JLibrary
    from repro.serving.scheduler import BucketConfig, MicrobatchScheduler
    cfg, params, _ = tiny_trained
    queries = [scope_data.queries[int(q)] for q in scope_data.test_qids[:7]]

    def mk(**kw):
        lib = JLibrary(anchor_set)
        for m in scope_data.world.pool:
            if m.seen:
                lib.onboard(scope_data.world, m.name, seed=3)
        return japi.ScopeEngine.build(japi.EngineConfig(
            estimator=JEstimator(cfg, params, max_new_tokens=NEW_TOKENS),
            retriever=retriever, library=lib,
            models_meta={m: scope_data.world.models[m]
                         for m in scope_data.models}, **kw))

    def pool(p, eng):
        return _pool(p, eng, japi.FixedAlphaPolicy)

    def stream(eng, ticks, buckets):
        sched = MicrobatchScheduler(BucketConfig(batch_sizes=buckets))
        pools = list(eng.predict_stream(
            (japi.RouteRequest(t) for t in ticks), scheduler=sched))
        return {"pools": [pool(p, eng) for p in pools],
                "stats": {f: getattr(sched.stats, f) for f in STAT_FIELDS}}

    eng = mk()
    out = {"predict": pool(eng.predict(japi.RouteRequest(queries[:4])), eng),
           "replicated": pool(eng.predict(japi.RouteRequest(queries[4:7])),
                              eng),
           "stream": stream(mk(), [queries[:1], queries[1:4]], (4, 8))}
    ticks = [queries[:2], queries[2:3], queries[3:6]]
    out["refill_dense"] = stream(mk(refill=True), ticks, (1, 2, 4, 8))
    out["refill_paged"] = stream(mk(refill=True, kv_paged=True,
                                    kv_page_size=8), ticks, (1, 2, 4, 8))
    eng = mk(refill=True)
    pools = []
    for p in eng.predict_stream((japi.RouteRequest(t) for t in ticks),
                                scheduler=MicrobatchScheduler(BucketConfig(
                                    batch_sizes=(1, 2, 4, 8)))):
        pools.append(pool(p, eng))
        if len(pools) == 1:
            eng.hot_swap(JEstimator(cfg, params, max_new_tokens=NEW_TOKENS),
                         "swapped")
    out["hot_swap"] = {"pools": pools}
    out["n_models"] = len(scope_data.models)
    return out


def _pools(case):
    return case["pools"] if "pools" in case else [case]


def _same_pools(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        for f in POOL_EXACT:
            if f == "len_hat" or f == "cost_hat":
                ok = np.asarray(w["status"]) == 0
                np.testing.assert_array_equal(np.asarray(g[f])[ok],
                                              np.asarray(w[f])[ok], f)
                np.testing.assert_allclose(g[f], w[f], rtol=1e-5)
            else:
                assert g[f] == w[f], f
        np.testing.assert_allclose(g["p_hat"], w["p_hat"], atol=F32_TOL)


CASES = ("predict", "replicated", "stream", "refill_dense", "refill_paged",
         "hot_swap")


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_sharded_equals_one_process(runs, ranks, case):
    """Every rank's results equal one process's, p_hat within 2e-5."""
    one = runs[1][0][case]
    for got in runs[ranks]:
        _same_pools(_pools(got[case]), _pools(one))
        if "stats" in one:
            assert got[case]["stats"] == one["stats"]


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_sharded_equals_reference_one_device(runs, reference, ranks, case):
    got = runs[ranks][0][case]
    _same_pools(_pools(got), _pools(reference[case]))
    if "stats" in got:
        assert got["stats"] == reference[case]["stats"]


@pytest.mark.parametrize("ranks", [2, 4])
def test_every_rank_returns_the_same_results(runs, ranks):
    """Rank for rank, all but the rows each computed and its blocks."""
    def common(out):
        out = {k: v for k, v in out.items() if k != "blocks"}
        out["predict"] = {k: v for k, v in out["predict"].items()
                          if k != "rows"}
        return out
    first = common(runs[ranks][0])
    for other in runs[ranks][1:]:
        assert common(other) == first


@pytest.mark.parametrize("ranks", [2, 4])
def test_tier0_distills_from_a_sharded_estimator(runs, ranks):
    """The tier-0 head distilled from a sharded estimator's labels is the
    one-process head (5 steps on 64 pairs)."""
    one = runs[1][0]["tier0"]
    for got in runs[ranks]:
        np.testing.assert_allclose(got["tier0"]["temperature"],
                                   one["temperature"], rtol=1e-5)
        assert got["tier0"]["sums"].keys() == one["sums"].keys()
        np.testing.assert_allclose(list(got["tier0"]["sums"].values()),
                                   list(one["sums"].values()), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("ranks", [2, 4])
def test_grpo_trainer_takes_sharded_params_and_steps(runs, ranks):
    """GRPOTrainer takes the sharded estimator's DTensor params and steps on
    them (4 greedy rollouts split over the ranks): its params stay sharded,
    and its loss, kl and reward are one process's
    (test_torch_distributed_training.py holds the step leaf by leaf)."""
    one = runs[1][0]["grpo"]
    assert one["sharded"] == [False] and one["step"] == 1
    for got in runs[ranks]:
        assert got["grpo"]["sharded"] == [True] and got["grpo"]["step"] == 1
        assert got["grpo"]["reward"] == one["reward"]
        for k in ("loss", "kl"):
            assert abs(got["grpo"][k] - one[k]) <= F32_TOL, k


@pytest.mark.parametrize("ranks", [2, 4])
def test_stream_script_twin_cache_counts(runs, reference, ranks):
    """The twin of the reference's sharded stream script: ticks [q[:1],
    q[1:4]] over buckets (4, 8) give the pools of one process, hits and
    misses [[0, M], [0, 3M]] and at least one microbatch."""
    M = reference["n_models"]
    for got in runs[ranks]:
        assert [p["cache"] for p in got["stream"]["pools"]] == [[0, M],
                                                                [0, 3 * M]]
        assert got["stream"]["stats"]["microbatches"] > 0


@pytest.mark.parametrize("ranks", [2, 4])
def test_rows_split_over_the_ranks(runs, ranks):
    """28 pairs split into equal blocks, rank r the r-th; 21 pairs divide
    over neither world, so every rank computes them all."""
    assert runs[1][0]["predict"]["rows"] is None
    assert runs[1][0]["replicated"]["rows"] is None
    n = 28 // ranks
    for r, got in enumerate(runs[ranks]):
        assert got["predict"]["rows"] == [r * n, (r + 1) * n]
        assert got["replicated"]["rows"] == [0, 21]


@pytest.mark.parametrize("ranks", [2, 4])
def test_moe_rows_are_computed_whole_on_every_rank(runs, ranks):
    """A MoE estimator's batch is not split: its capacity groups span the
    batch, so each rank routes all 8 rows and matches one process bit for
    bit (tokens and decision logits)."""
    one = runs[1][0]["moe"]
    for got in runs[ranks]:
        assert got["moe"]["rows"] == [0, 8]
        assert {k: v for k, v in got["moe"].items() if k != "rows"} == {
            k: v for k, v in one.items() if k != "rows"}


def _reference_blocks():
    """``NamedSharding(mesh, spec).devices_indices_map(shape)`` on a (2, 2)
    ("data", "model") mesh of 4 host devices, device i at rank i's
    coordinate, computed in a process of its own."""
    code = (
        "import os\n"
        "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'\n"
        "import json, jax, numpy as np\n"
        "from jax.sharding import Mesh, NamedSharding, PartitionSpec as P\n"
        "devs = np.array(jax.devices()[:4]).reshape(2, 2)\n"
        "mesh = Mesh(devs, ('data', 'model'))\n"
        f"cases = {BLOCKS!r}\n"
        "out = []\n"
        "for shape, spec in cases:\n"
        "    m = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)\n"
        "    x = np.arange(int(np.prod(shape))).reshape(shape)\n"
        "    out.append({str(d.id): x[idx].tolist() for d, idx in m.items()})\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_local_blocks_match_named_sharding(runs):
    """At (2, 2), each rank's DTensor block equals the block JAX's
    NamedSharding gives the device at the same mesh coordinate, and both
    equal ``sharding.local_block``; ``pipeline.shard_batch`` places a
    column's rows over data."""
    import torch

    from repro_torch.distributed import sharding as shd
    want = _reference_blocks()
    mesh = shd.MeshSpec(("data", "model"), (2, 2))
    for rank, got in enumerate(runs[4]):
        coord = got["blocks"]["coord"]
        assert coord == [rank // 2, rank % 2]
        for (shape, spec), block, ref in zip(
                BLOCKS, got["blocks"]["blocks"], want, strict=True):
            assert block == ref[str(rank)], (shape, spec, rank)
            x = torch.arange(int(np.prod(shape))).reshape(shape)
            assert x[shd.local_block(mesh, spec, shape, coord)].tolist() \
                == block
        # pipeline.shard_batch: a column of int32 rows over data
        tokens = np.arange(24, dtype=np.int32).reshape(8, 3)
        assert got["blocks"]["batch"] == [
            "torch.int32", tokens[4 * coord[0]: 4 * coord[0] + 4].tolist()]


# ---------------------------------------------------------------------------
# launch.serve --mesh under torchrun
# ---------------------------------------------------------------------------
def test_serve_mesh_prints_the_unsharded_report(params_path, capsys):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh``
    prints (rank 0 only) the report of the same serve without a mesh,
    and the mesh line."""
    from repro_torch.launch import serve as tserve
    args = ["--device", "cpu", "--checkpoint", str(params_path),
            "--queries", "4"]
    assert tserve.main(args) == 0
    want = capsys.readouterr().out
    env = rank_env(2)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(free_port()), "-m",
         "repro_torch.launch.serve", *args, "--mesh"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert "# estimator sharded over {'data': 2, 'model': 1}" in lines
    got = "\n".join(line for line in lines if not line.startswith(
        "# estimator sharded")) + "\n"
    assert got == want


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])
