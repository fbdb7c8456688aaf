"""Training and tensor-parallel serving across devices on the CPU: params
placed by ``ReasoningEstimator.shard`` over gloo ranks spawned as
processes (one thread each), against one process of the port and the
reference's one-device run on the same weights.

Every rank runs ``mesh_cases`` on each of its world's meshes — world 2 over
(2, 1) and (1, 2), world 4 over (2, 2) and (1, 4) — and rank 0 writes the
results.  The cases:

  * the loss, its metrics (the MoE load-balance ``aux`` too) and every
    gradient leaf (gathered whole) of one batch whose rows hold different
    counts of labelled tokens, on the SFT-trained scope-tiny (4 heads on 2,
    d_ff 384, vocab 512), on the config of the reference's own mesh test
    (``internlm2-1.8b`` ``.reduced(d_model=256, num_heads=4)``) and on the
    small MoE config (qwen3-moe ``.reduced()``) at two batches: 8 x 20
    tokens (``moe``: one routing group, so every rank computes every row)
    and 8 x 64 (``moe_split``: two groups of 256, split over ``data`` = 2);
    each rank's param bytes, and every parameter all-gather the step made
    (a recorder on ``collectives._all_gather``);
  * one ``sft_step`` and ten ``train_sft`` steps of scope-tiny, and each
    rank's blocks of params, ``mu`` and ``nu`` after the step;
  * ``global_norm`` of the sharded gradients;
  * ``make_train_step`` over two microbatches;
  * ``checkpoint.save`` of the sharded tree;
  * GRPO on scope-tiny: a greedy ``rollout_step`` (8 rollouts: the tokens
    each rank scored, the loss, ``pg``, ``kl`` and the params after it), a
    sampled one (the tokens each rank scored), and on the reference
    trainer's own batch (``test_torch_grpo.py``'s ``reference_batch``,
    saved beside the weights) ``grpo_loss``'s gradient and one
    ``grpo_step``;
  * on (1, 2) and (2, 2): a batch predict and a dense and a paged refill
    stream of scope-tiny, and the kv-heads a rank's decode cache holds.

Tolerances, all float32: the loss (and ``aux``, ``pg``, ``kl``) within
2e-5; each gradient leaf within 1e-4 of that leaf's largest magnitude; one
step's loss and params within 2e-5; ten steps' losses within 1e-4
(``test_torch_training.py``'s); greedy rollouts and serves equal in tokens,
parsed fields, decisions and cache counts, ``p_hat`` within 2e-5.

Run as a script, this file is one rank's worker:

  RANK=0 WORLD_SIZE=2 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
      python tests/test_torch_distributed_training.py OUT_DIR PARAMS_DIR
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import test_torch_distributed as tdist

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2), (1, 4))}
SERVE_MESHES = ((1, 2), (2, 2))
CONFIGS = ("tiny", "internlm2", "moe", "moe_split")
# the batch's length by config (20 tokens unless named): moe_split's 8 x 64
# tokens route in two groups of 256
SEQ = {"moe_split": 64}
F32_TOL, GRAD_TOL, STEP10_TOL = 2e-5, 1e-4, 1e-4
# GRPO on scope-tiny: 4 tasks x 2 rollouts of 8 new tokens (test_torch_grpo's)
GRPO_CFG = dict(group_size=2, tasks_per_step=4, max_new_tokens=8)
GRPO_OPT = dict(lr=2e-4, warmup_steps=10, total_steps=1000)


def port_config(name):
    """``name``'s config; "grpo" is scope-tiny's (the reference batch's
    weights)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.scope_estimator import TINY
    if name in ("tiny", "grpo"):
        return TINY
    if name == "internlm2":
        return get_config("internlm2-1.8b").reduced(d_model=256, num_heads=4)
    return get_config("qwen3-moe-235b-a22b").reduced()


def reference_config(name):
    from repro.configs import get_config
    from repro.configs.scope_estimator import TINY
    if name == "tiny":
        return TINY
    if name == "internlm2":
        return get_config("internlm2-1.8b").reduced(d_model=256, num_heads=4)
    return get_config("qwen3-moe-235b-a22b").reduced()


def lm_batch(vocab: int, seq: int = 20):
    """8 rows of ``seq`` tokens; row i has seq - 1 - 2 i labelled tokens, so
    ranks hold different counts."""
    r = np.random.default_rng(5)
    tokens = r.integers(3, vocab, size=(8, seq)).astype(np.int32)
    labels = r.integers(3, vocab, size=(8, seq)).astype(np.int32)
    for i in range(8):
        labels[i, : 1 + 2 * i] = -100
    return {"tokens": tokens, "labels": labels}


def config_batch(name, vocab: int):
    return lm_batch(vocab, SEQ.get(name, 20))


def scope_world():
    """(data, library, retriever) of the seeded world (built afresh:
    ``World.embed`` draws from the world's generator)."""
    from repro_torch.core.fingerprint import (FingerprintLibrary,
                                              build_anchor_set)
    from repro_torch.core.retrieval import AnchorRetriever
    from repro_torch.data.datasets import build_scope_data, stratified_anchors
    from repro_torch.data.worldsim import World
    world = World(seed=0)
    data = build_scope_data(world, n_queries=200, seed=0)
    anchors = build_anchor_set(world, stratified_anchors(world, n=80, seed=7))
    lib = FingerprintLibrary(anchors)
    for m in world.pool:
        if m.seen:
            lib.onboard(world, m.name, seed=3)
    return data, lib, AnchorRetriever(anchors, device="cpu")


def sft_dataset():
    from repro_torch.training.sft import build_sft_dataset
    data, lib, retr = scope_world()
    return build_sft_dataset(data, lib, retr, max_examples=96, seed=0)


# ---------------------------------------------------------------------------
# the cases: every rank of a mesh, or one process (mesh=None)
# ---------------------------------------------------------------------------
def _whole(t):
    from repro_torch.distributed import collectives as coll
    return (t.full_tensor() if coll.is_sharded(t) else t).detach().numpy()


def _allowed_gathers(params, n_model: int):
    """The shapes a parameter all-gather may return: one layer of a stacked
    leaf or an unstacked leaf, each also with one dim kept split over
    ``model``."""
    from repro_torch.io import flatten
    out = set()
    for key, leaf in flatten(params).items():
        shape = tuple(leaf.shape[1:] if "k:segments" in key else leaf.shape)
        out.add(shape)
        for d, n in enumerate(shape):
            if n % n_model == 0:
                out.add(shape[:d] + (n // n_model,) + shape[d + 1:])
    return out


def mesh_cases(params_dir, mesh=None, out_dir=None):
    """(results, arrays) of every case on ``mesh`` (None: one process)."""
    import torch

    from repro_torch import io
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.io import flatten
    from repro_torch.launch.specs import make_train_step
    from repro_torch.models import model as M
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                global_norm, value_and_grad)
    from repro_torch.training.sft import sft_step, train_sft

    def load(name):
        return io.load_checkpoint(str(Path(params_dir) / f"{name}.npz"),
                                  port_config(name), device="cpu")

    def placed(name):
        est = ReasoningEstimator(port_config(name), load(name))
        return est.params if mesh is None else est.shard(mesh).params

    n_model = 1 if mesh is None else shd.axis_sizes(mesh)["model"]
    res, arrays = {}, {}
    seen = []
    gather = coll._all_gather

    def record(x, dim, group):
        out = gather(x, dim, group)
        seen.append(tuple(out.shape))
        return out

    for name in CONFIGS:
        cfg = port_config(name)
        plain = load(name)
        params = placed(name)
        batch = to_tensors(config_batch(name, cfg.vocab_size), "cpu")
        seq = batch["tokens"].shape[1]
        seen.clear()
        coll._all_gather = record
        try:
            loss, metrics, grads = value_and_grad(
                lambda p, cfg=cfg, batch=batch: M.loss_fn(p, cfg, batch),
                params)
        finally:
            coll._all_gather = gather
        arrays[f"{name}/loss"] = loss.numpy()
        arrays[f"{name}/ce"] = metrics["ce"].numpy()
        arrays[f"{name}/acc"] = metrics["acc"].numpy()
        arrays[f"{name}/aux"] = metrics["aux"].numpy()
        for key, g in flatten(grads).items():
            arrays[f"{name}/grad/{key}"] = _whole(g)
        arrays[f"{name}/norm"] = global_norm(grads).numpy()
        # and the logits: each rank's rows, the vocabulary gathered
        allowed = _allowed_gathers(plain, n_model) | {
            (r, seq, cfg.vocab_size) for r in (2, 4, 8)}
        rows = None
        if mesh is not None:
            rows = coll.train_rows(mesh, cfg, 8, seq)
        res[name] = {
            "split": (None if mesh is None
                      else list(coll.model_split(cfg, mesh))),
            "rows": None if rows is None else [rows.start, rows.stop],
            "gathers": len(seen),
            "bad_gathers": sorted({s for s in seen if s not in allowed}),
            "local_bytes": sum(coll.local(t).numel() * t.element_size()
                               for t in flatten(params).values()),
            "want_bytes": (None if mesh is None else shd.local_bytes(
                mesh, plain, shd.param_specs(mesh, plain)))}

    # one SFT step, the blocks each rank holds after it
    from repro_torch.configs.scope_estimator import TINY
    # test_torch_training.py's one-step config
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=100)
    params = placed("tiny")
    state = adamw_init(params)
    batch = to_tensors(lm_batch(TINY.vocab_size), "cpu")
    params, state, loss, _ = sft_step(params, TINY, state, batch, opt_cfg)
    arrays["sft1/loss"] = loss.numpy()
    for key, t in flatten(params).items():
        arrays[f"sft1/params/{key}"] = _whole(t)
    if mesh is not None:
        plain = load("tiny")
        specs = shd.param_specs(mesh, plain)
        coord = mesh.get_coordinate()
        bad = []
        for what, tree in (("params", params), ("mu", state.mu),
                           ("nu", state.nu)):
            for key, t in flatten(tree).items():
                whole = tuple(flatten(plain)[key].shape)
                want = tuple(s.stop - s.start for s in shd.local_block(
                    mesh, specs[key], whole, coord))
                if not coll.is_sharded(t) or tuple(
                        coll.local(t).shape) != want:
                    bad.append(f"{what} {key}")
        res["blocks_bad"] = bad

    # two microbatches through make_train_step
    params = placed("tiny")
    step = make_train_step(TINY, opt_cfg, microbatches=2)
    params, _, value = step(params, adamw_init(params), batch)
    arrays["micro/loss"] = np.asarray(float(value), np.float32)
    for key, t in flatten(params).items():
        arrays[f"micro/params/{key}"] = _whole(t)

    # ten train_sft steps
    params, losses = train_sft(placed("tiny"), TINY, sft_dataset(), steps=10,
                               batch_size=32)
    arrays["sft10/losses"] = np.asarray(losses, np.float32)
    for key, t in flatten(params).items():
        arrays[f"sft10/params/{key}"] = _whole(t)

    # the checkpoint of the sharded (untrained) tree
    if out_dir is not None:
        checkpoint.save(str(Path(out_dir) / "tiny_saved.npz"), placed("tiny"))

    res["grpo"] = grpo_cases(params_dir, placed, arrays)
    if mesh is None or tuple(mesh.shape) in SERVE_MESHES:
        res["serve"] = serve_cases(load("tiny"), mesh)
    return res, arrays


def grpo_cases(params_dir, placed, arrays):
    """GRPO on scope-tiny placed by ``placed``: a greedy and a sampled
    ``rollout_step`` (each rank's scored tokens in the result; the greedy
    step's loss, metrics and params in ``arrays``), and on the reference
    trainer's batch ``grpo_loss``'s gradient and one ``grpo_step``."""
    import torch

    from repro_torch.configs.scope_estimator import TINY
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.distributed import collectives as coll
    from repro_torch.io import flatten
    from repro_torch.training import grpo as G
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                value_and_grad)
    out = {}
    step = G.grpo_step
    for mode, temperature in (("greedy", 0.0), ("sampled", 1.0)):
        data, lib, retr = scope_world()
        trainer = G.GRPOTrainer(
            TINY, placed("tiny"), data, lib, retr,
            gcfg=G.GRPOConfig(temperature=temperature, **GRPO_CFG), seed=0,
            generator=torch.Generator().manual_seed(0))
        seen = []

        def record(params, cfg, opt_state, batch, *args):
            got = step(params, cfg, opt_state, batch, *args)
            seen.append((batch, got))
            return got

        G.grpo_step = record
        try:
            info = trainer.rollout_step()
        finally:
            G.grpo_step = step
        (batch, (_, _, loss, metrics)), = seen
        out[mode] = {"tokens": batch["tokens"].tolist(),
                     "reward": info["reward"]}
        if mode == "greedy":
            for k in ("adv", "old_logp", "ref_logp"):
                arrays[f"grpo/{k}"] = batch[k].numpy()
            arrays["grpo/loss"] = loss.numpy()
            for k, v in metrics.items():
                arrays[f"grpo/{k}"] = v.numpy()
            for key, t in flatten(trainer.params).items():
                arrays[f"grpo/params/{key}"] = _whole(t)
            out["sharded"] = [coll.is_sharded(t) for t in
                              flatten(trainer.params).values()]

    # the reference trainer's batch (test_torch_grpo's reference_batch)
    with np.load(Path(params_dir) / "grpo_batch.npz") as z:
        batch = to_tensors(dict(z), "cpu")
    params = placed("grpo")
    loss, metrics, grads = value_and_grad(
        lambda p: G.grpo_loss(p, TINY, batch, 0.2, 0.02), params)
    arrays["grpo_ref/loss"] = loss.numpy()
    for k, v in metrics.items():
        arrays[f"grpo_ref/{k}"] = v.numpy()
    for key, g in flatten(grads).items():
        arrays[f"grpo_ref/grad/{key}"] = _whole(g)
    params, _, loss, _ = G.grpo_step(params, TINY, adamw_init(params), batch,
                                     AdamWConfig(**GRPO_OPT), 0.2, 0.02)
    arrays["grpo_ref/step_loss"] = loss.numpy()
    for key, t in flatten(params).items():
        arrays[f"grpo_ref/params/{key}"] = _whole(t)
    return out


def serve_cases(params, mesh):
    """A batch predict and a dense and a paged refill stream of scope-tiny
    (``test_torch_distributed``'s engine), and the kv-heads of a rank's
    decode cache."""
    from repro_torch import api
    from repro_torch.configs.scope_estimator import TINY
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.core.fingerprint import (FingerprintLibrary,
                                              build_anchor_set)
    from repro_torch.core.retrieval import AnchorRetriever
    from repro_torch.data.datasets import build_scope_data, stratified_anchors
    from repro_torch.data.worldsim import World
    from repro_torch.serving.scheduler import BucketConfig, MicrobatchScheduler

    world = World(seed=0)
    data = build_scope_data(world, n_queries=200, seed=0)
    anchors = build_anchor_set(world, stratified_anchors(world, n=80, seed=7))
    retr = AnchorRetriever(anchors, device="cpu")
    queries = [data.queries[int(q)] for q in data.test_qids[:6]]

    def estimator():
        est = ReasoningEstimator(TINY, params, max_new_tokens=tdist.NEW_TOKENS)
        return est if mesh is None else est.shard(mesh)

    def mk(**kw):
        lib = FingerprintLibrary(anchors)
        for m in world.pool:
            if m.seen:
                lib.onboard(world, m.name, seed=3)
        return api.ScopeEngine.build(api.EngineConfig(
            estimator=estimator(), retriever=retr, library=lib,
            models_meta={m: world.models[m] for m in data.models}, **kw))

    def stream(eng):
        sched = MicrobatchScheduler(BucketConfig(batch_sizes=(1, 2, 4, 8)))
        pools = list(eng.predict_stream(
            (api.RouteRequest(t) for t in ticks), scheduler=sched))
        return {"pools": [tdist._pool(p, eng, api.FixedAlphaPolicy)
                          for p in pools],
                "stats": {f: getattr(sched.stats, f)
                          for f in tdist.STAT_FIELDS}}

    ticks = [queries[:2], queries[2:3], queries[3:6]]
    eng = mk()
    out = {"predict": tdist._pool(eng.predict(api.RouteRequest(queries[:4])),
                                  eng, api.FixedAlphaPolicy),
           "refill_dense": stream(mk(refill=True)),
           "refill_paged": stream(mk(refill=True, kv_paged=True,
                                     kv_page_size=8))}
    run = estimator().open_slots(np.full((4, 16), 5, np.int32))
    out["kv_heads"] = int(run.state.caches[0]["0"]["k"].shape[2])
    return out


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------
def worker(out_dir: str, params_dir: str) -> None:
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_serve_mesh
    init_distributed("cpu")
    try:
        for nd, nm in MESHES[dist.get_world_size()]:
            mesh = make_serve_mesh(n_data=nd, n_model=nm)
            sub = Path(out_dir) / f"{nd}x{nm}"
            sub.mkdir(exist_ok=True)
            res, arrays = mesh_cases(params_dir, mesh, sub)
            res["coord"] = list(mesh.get_coordinate())
            (sub / f"rank{dist.get_rank()}.json").write_text(json.dumps(res))
            if dist.get_rank() == 0:
                np.savez(sub / "arrays.npz", **arrays)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_params(tiny_trained):
    """{name: the reference's params}: the SFT-trained tiny and seeded
    inits of the other two configs."""
    import jax

    from repro.models import model as JM
    return {"tiny": tiny_trained[1],
            **{name: JM.init_params(jax.random.PRNGKey(0),
                                    reference_config(name))
               for name in CONFIGS[1:]}}


@pytest.fixture(scope="module")
def grpo_reference(reference_params):
    """The reference trainer's second sampled rollout on the SFT-trained
    tiny (``test_torch_grpo.py``'s ``reference_batch``): the params it was
    taken at and its batch, and on them the reference's one-device
    ``grpo_loss`` (value, ``pg``, ``kl``, gradient in the port's layout)
    and ``grpo_step`` (loss, params)."""
    import jax
    import jax.numpy as jnp
    import torch

    import test_torch_grpo as tgrpo
    from repro.training import grpo as JG
    from repro.training import optimizer as JOpt
    from repro_torch.io import flatten
    trained = reference_params["tiny"]
    jt, _ = tgrpo._trainers(trained, tgrpo._bridge(trained), temperature=1.0,
                            generator=torch.Generator().manual_seed(0))
    mp = pytest.MonkeyPatch()
    try:
        cap = tgrpo._Capture(mp, JG)
        jt.rollout_step()
        jt.rollout_step()
    finally:
        mp.undo()
    call = cap.calls[1]
    params = call["params"]
    batch = {k: np.asarray(v) for k, v in call["batch"].items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: JG.grpo_loss(p, reference_config("tiny"), jb, 0.2, 0.02),
        has_aux=True)(params)
    stepped, _, step_loss, _ = JG.grpo_step(
        params, reference_config("tiny"), JOpt.adamw_init(params), jb,
        JOpt.AdamWConfig(**GRPO_OPT), 0.2, 0.02)

    def port(tree):
        return flatten(_port_tree(jax.tree.map(np.asarray, tree), "tiny"))
    return {"params": jax.tree.map(np.asarray, params), "batch": batch,
            "loss": float(loss), "pg": float(metrics["pg"]),
            "kl": float(metrics["kl"]), "grads": port(grads),
            "step_loss": float(step_loss), "stepped": port(stepped)}


@pytest.fixture(scope="module")
def params_dir(reference_params, grpo_reference, tmp_path_factory):
    """The configs' weights, bridged and saved as the port's checkpoints,
    and the reference GRPO batch with its weights (``grpo``)."""
    import jax

    from repro_torch import io
    from repro_torch.training import checkpoint
    out = tmp_path_factory.mktemp("train_params")
    for name, params in (*reference_params.items(),
                         ("grpo", grpo_reference["params"])):
        checkpoint.save(str(out / f"{name}.npz"), io.params_from_numpy(
            jax.tree.map(np.asarray, params), port_config(name),
            device="cpu"))
    np.savez(out / "grpo_batch.npz", **grpo_reference["batch"])
    return out


@pytest.fixture(scope="module")
def runs(params_dir, tmp_path_factory):
    """{(nd, nm): (rank results, rank 0's arrays, its directory)} and the
    one-process results under (1, 1); both worlds start at once and the
    one-process cases run meanwhile."""
    dirs = {w: tmp_path_factory.mktemp(f"train_world{w}") for w in MESHES}
    started = {}
    for w in MESHES:
        env = tdist.rank_env(w)
        started[w] = [subprocess.Popen(
            [sys.executable, __file__, str(dirs[w]), str(params_dir)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(w)]
    one = tmp_path_factory.mktemp("train_one")
    res, arrays = mesh_cases(params_dir, None, one)
    out = {(1, 1): ([json.loads(json.dumps(res))], arrays, one)}
    for w, procs in started.items():
        errs = []
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            if p.returncode != 0:
                errs.append(f"rank {r} exit {p.returncode}: {err[-3000:]}")
        assert not errs, "\n".join(errs)
        for nd, nm in MESHES[w]:
            sub = dirs[w] / f"{nd}x{nm}"
            with np.load(sub / "arrays.npz") as z:
                arrays = dict(z)
            out[(nd, nm)] = ([json.loads((sub / f"rank{r}.json").read_text())
                              for r in range(w)], arrays, sub)
    return out


@pytest.fixture(scope="module")
def reference_grads(reference_params):
    """{name: (loss, ce, {key: gradient}, aux)} of the reference's
    one-device ``jax.value_and_grad(M.loss_fn)`` on ``config_batch``."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro_torch.io import flatten
    out = {}
    for name, params in reference_params.items():
        cfg = reference_config(name)
        batch = {k: jnp.asarray(v)
                 for k, v in config_batch(name, cfg.vocab_size).items()}
        (loss, metrics), grads = jax.value_and_grad(
            lambda p, cfg=cfg, batch=batch: JM.loss_fn(p, cfg, batch),
            has_aux=True)(params)
        out[name] = (float(loss), float(metrics["ce"]),
                     {k: np.asarray(v, np.float32) for k, v in flatten(
                         _port_tree(jax.tree.map(np.asarray, grads),
                                    name)).items()},
                     float(metrics["aux"]))
    return out


def _port_tree(tree, name):
    """A reference tree of numpy arrays in the port's layout."""
    import torch

    from repro_torch import io
    t = io.params_from_numpy(tree, port_config(name), device="cpu")
    return io.tree_map(lambda x: x.to(torch.float32).numpy(), t)


@pytest.fixture(scope="module")
def reference_serve(tiny_trained, scope_data, anchor_set, retriever):
    """The reference's one-device predict and refill streams (``repro.api``)
    of ``serve_cases``."""
    from repro import api as japi
    from repro.core.estimator import ReasoningEstimator as JEstimator
    from repro.core.fingerprint import FingerprintLibrary as JLibrary
    from repro.serving.scheduler import BucketConfig, MicrobatchScheduler
    cfg, params, _ = tiny_trained
    queries = [scope_data.queries[int(q)] for q in scope_data.test_qids[:6]]
    ticks = [queries[:2], queries[2:3], queries[3:6]]

    def mk(**kw):
        lib = JLibrary(anchor_set)
        for m in scope_data.world.pool:
            if m.seen:
                lib.onboard(scope_data.world, m.name, seed=3)
        return japi.ScopeEngine.build(japi.EngineConfig(
            estimator=JEstimator(cfg, params,
                                 max_new_tokens=tdist.NEW_TOKENS),
            retriever=retriever, library=lib,
            models_meta={m: scope_data.world.models[m]
                         for m in scope_data.models}, **kw))

    def stream(eng):
        sched = MicrobatchScheduler(BucketConfig(batch_sizes=(1, 2, 4, 8)))
        pools = list(eng.predict_stream(
            (japi.RouteRequest(t) for t in ticks), scheduler=sched))
        return {"pools": [tdist._pool(p, eng, japi.FixedAlphaPolicy)
                          for p in pools],
                "stats": {f: getattr(sched.stats, f)
                          for f in tdist.STAT_FIELDS}}

    eng = mk()
    return {"predict": tdist._pool(eng.predict(japi.RouteRequest(
                queries[:4])), eng, japi.FixedAlphaPolicy),
            "refill_dense": stream(mk(refill=True)),
            "refill_paged": stream(mk(refill=True, kv_paged=True,
                                      kv_page_size=8))}


MESH_IDS = [f"{nd}x{nm}" for w in MESHES for nd, nm in MESHES[w]]
ALL_MESHES = [m for w in MESHES for m in MESHES[w]]


def _grad_keys(arrays, name):
    pre = f"{name}/grad/"
    return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}


def _close_grads(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(got[key] - w).max()) / scale
        assert err <= GRAD_TOL, (key, err)


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_loss_and_gradients_equal_one_process(runs, mesh, name):
    _, arrays, _ = runs[mesh]
    _, one, _ = runs[(1, 1)]
    for k in ("loss", "ce", "acc", "aux"):
        assert abs(float(arrays[f"{name}/{k}"]) - float(one[f"{name}/{k}"])
                   ) <= F32_TOL, k
    _close_grads(_grad_keys(arrays, name), _grad_keys(one, name))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_loss_and_gradients_equal_reference_one_device(runs, reference_grads,
                                                       mesh, name):
    _, arrays, _ = runs[mesh]
    loss, ce, grads, aux = reference_grads[name]
    assert abs(float(arrays[f"{name}/loss"]) - loss) <= F32_TOL
    assert abs(float(arrays[f"{name}/ce"]) - ce) <= F32_TOL
    assert abs(float(arrays[f"{name}/aux"]) - aux) <= F32_TOL
    _close_grads(_grad_keys(arrays, name), grads)


def test_one_process_matches_reference_one_device(runs, reference_grads):
    """The yardstick itself: one process of the port on the same batch."""
    _, one, _ = runs[(1, 1)]
    for name in CONFIGS:
        loss, _, grads, _ = reference_grads[name]
        assert abs(float(one[f"{name}/loss"]) - loss) <= F32_TOL
        _close_grads(_grad_keys(one, name), grads)


SPLIT_ROWS = [m for m in ALL_MESHES if m[0] > 1]


@pytest.mark.parametrize("mesh", SPLIT_ROWS,
                         ids=[f"{nd}x{nm}" for nd, nm in SPLIT_ROWS])
def test_rows_split_with_unequal_label_counts(runs, mesh):
    """Where rows split over ``data``, rank r computes the r-th block of
    rows (ranks along ``model`` the same), and the blocks hold different
    counts of labelled tokens (row i has 19 - 2 i): a mean of per-rank
    means would not be the loss the other tests find."""
    nd, _ = mesh
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.scope_estimator import TINY
    batch = lm_batch(TINY.vocab_size)
    counts = (batch["labels"] >= 0).reshape(nd, -1).sum(axis=1)
    assert len(set(counts.tolist())) == nd
    results, _, _ = runs[mesh]
    assert [r["tiny"]["rows"] for r in results] == [
        [8 // nd * (rk[0]), 8 // nd * (rk[0] + 1)]
        for rk in (r["coord"] for r in results)]


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_global_norm_of_sharded_gradients(runs, mesh):
    _, arrays, _ = runs[mesh]
    _, one, _ = runs[(1, 1)]
    for name in CONFIGS:
        np.testing.assert_allclose(arrays[f"{name}/norm"], one[f"{name}/norm"],
                                   rtol=1e-5)


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_moe_rows_whole_on_every_rank(runs, mesh):
    """A MoE batch whose routing groups do not divide over ``data`` is not
    split (8 x 20 tokens: one group of 160): every rank computes all its
    rows (on (1, n) the one block of ``data`` = 1 is all of them); the
    dense ones split wherever 8 rows divide over ``data``."""
    results, _, _ = runs[mesh]
    for r in results:
        if mesh[0] > 1:
            assert r["moe"]["rows"] is None
            assert r["tiny"]["rows"] is not None
        else:
            assert r["moe"]["rows"] == r["tiny"]["rows"] == [0, 8]


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_moe_rows_split_where_groups_divide(runs, mesh):
    """8 x 64 tokens route in two groups of 256: over ``data`` = 2 rank r
    computes rows 4 r to 4 r + 4 (ranks along ``model`` the same), over
    ``data`` = 1 every row."""
    nd, _ = mesh
    for r in runs[mesh][0]:
        c = r["coord"][0]
        assert r["moe_split"]["rows"] == [8 // nd * c, 8 // nd * (c + 1)]


def test_train_rows_splits_a_moe_batch_by_whole_routing_groups():
    """``train_rows`` on meshes with no devices behind them: a MoE batch
    splits where its routing groups divide over ``data``, and each rank's
    rows regroup to the whole batch's group size; a dense batch splits
    wherever its rows divide."""
    import dataclasses

    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import train_rows
    from repro_torch.distributed.sharding import MeshSpec
    from repro_torch.models.moe import _group_size

    @dataclasses.dataclass(frozen=True)
    class Rank(MeshSpec):
        coord: tuple = (0, 0)

        def get_coordinate(self):
            return list(self.coord)

    moe = get_config("qwen3-moe-235b-a22b")
    dense = get_config("internlm2-1.8b")
    cases = [  # (b, s, n_data, groups, split)
        (8, 20, 2, 1, False),       # 160 tokens: one group
        (8, 64, 2, 2, True),        # 512: two groups of 256
        (8, 64, 4, 2, False),
        (64, 57, 2, 16, True),      # the card's SFT batch: 16 groups of 228
        (64, 57, 4, 16, True),
        (6, 50, 2, 2, True),        # 300: two groups of 150
        (6, 50, 3, 2, False)]
    for b, s, nd, groups, split in cases:
        total = b * s
        assert total // _group_size(total) == groups, (b, s)
        for c in range(nd):
            mesh = Rank(("data", "model"), (nd, 1), (c, 0))
            rows = train_rows(mesh, moe, b, s)
            assert train_rows(mesh, dense, b, s) == slice(
                b // nd * c, b // nd * (c + 1))
            if not split:
                assert rows is None, (b, s, nd)
                continue
            assert rows == slice(b // nd * c, b // nd * (c + 1)), (b, s, nd)
            local = (rows.stop - rows.start) * s
            assert _group_size(local) == _group_size(total)
    # rows that do not divide stay whole for every backbone
    mesh = Rank(("data", "model"), (4, 1), (1, 0))
    assert train_rows(mesh, dense, 6, 20) is None
    assert train_rows(mesh, moe, 6, 20) is None


# ---------------------------------------------------------------------------
# SFT steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_one_sft_step_equals_one_process(runs, mesh):
    _, arrays, _ = runs[mesh]
    _, one, _ = runs[(1, 1)]
    assert abs(float(arrays["sft1/loss"]) - float(one["sft1/loss"])) \
        <= F32_TOL
    keys = [k for k in one if k.startswith("sft1/params/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(arrays[k], one[k], rtol=0, atol=F32_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_ten_train_sft_steps_equal_one_process(runs, mesh):
    _, arrays, _ = runs[mesh]
    _, one, _ = runs[(1, 1)]
    assert arrays["sft10/losses"].shape == (10,)
    np.testing.assert_allclose(arrays["sft10/losses"], one["sft10/losses"],
                               rtol=0, atol=STEP10_TOL)


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_microbatched_train_step_equals_one_process(runs, mesh):
    """``make_train_step`` with two microbatches on the shards."""
    _, arrays, _ = runs[mesh]
    _, one, _ = runs[(1, 1)]
    assert abs(float(arrays["micro/loss"]) - float(one["micro/loss"])) \
        <= F32_TOL
    for k in (k for k in one if k.startswith("micro/params/")):
        np.testing.assert_allclose(arrays[k], one[k], rtol=0, atol=F32_TOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# storage stays sharded
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_ranks_hold_only_their_blocks(runs, mesh):
    """After the step every rank's params, ``mu`` and ``nu`` are DTensors
    whose local blocks have ``local_block``'s shapes, and each rank's
    param bytes are ``local_bytes``."""
    results, _, _ = runs[mesh]
    for r in results:
        assert r["blocks_bad"] == []
        for name in CONFIGS:
            assert r[name]["local_bytes"] == r[name]["want_bytes"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_no_gather_returns_more_than_one_layer(runs, mesh, name):
    """Every parameter all-gather of the step returned one layer of a
    stacked leaf, or an unstacked leaf (each maybe split over ``model``),
    and the step gathered at all where the mesh cuts over ``data``."""
    results, _, _ = runs[mesh]
    for r in results:
        assert r[name]["bad_gathers"] == []
        if mesh[0] > 1:
            assert r[name]["gathers"] > 0


# ---------------------------------------------------------------------------
# GRPO
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_grpo_greedy_step_equals_one_process(runs, mesh):
    """A greedy ``rollout_step`` on sharded params: every rank scored one
    process's rollouts, the advantages and log-probs agree, the loss,
    ``pg`` and ``kl`` within 2e-5 and the params after the step within
    2e-5; the params stay sharded."""
    results, arrays, _ = runs[mesh]
    one_res, one, _ = runs[(1, 1)]
    for r in results:
        assert r["grpo"]["greedy"]["tokens"] == \
            one_res[0]["grpo"]["greedy"]["tokens"]
        assert r["grpo"]["greedy"]["reward"] == \
            one_res[0]["grpo"]["greedy"]["reward"]
        assert all(r["grpo"]["sharded"])
    assert not any(one_res[0]["grpo"]["sharded"])
    np.testing.assert_array_equal(arrays["grpo/adv"], one["grpo/adv"])
    for k in ("old_logp", "ref_logp"):
        np.testing.assert_allclose(arrays[f"grpo/{k}"], one[f"grpo/{k}"],
                                   rtol=0, atol=F32_TOL, err_msg=k)
    for k in ("loss", "pg", "kl"):
        assert abs(float(arrays[f"grpo/{k}"]) - float(one[f"grpo/{k}"])) \
            <= F32_TOL, k
    keys = [k for k in one if k.startswith("grpo/params/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(arrays[k], one[k], rtol=0, atol=F32_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_grpo_equals_reference_one_device(runs, grpo_reference, mesh):
    """On the reference trainer's batch: ``grpo_loss`` and its metrics
    within 2e-5 of the reference's one-device values, every gradient leaf
    within 1e-4 of its largest magnitude, and one ``grpo_step``'s loss and
    params within 2e-5 of the reference's step."""
    _, arrays, _ = runs[mesh]
    for k in ("loss", "pg", "kl", "step_loss"):
        assert abs(float(arrays[f"grpo_ref/{k}"]) - grpo_reference[k]) \
            <= F32_TOL, k
    pre = "grpo_ref/grad/"
    _close_grads({k[len(pre):]: v for k, v in arrays.items()
                  if k.startswith(pre)}, grpo_reference["grads"])
    for key, want in grpo_reference["stepped"].items():
        np.testing.assert_allclose(arrays[f"grpo_ref/params/{key}"], want,
                                   rtol=0, atol=F32_TOL, err_msg=key)


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_grpo_sampled_rollouts_equal_on_every_rank(runs, mesh):
    """At temperature 1 each rank samples its own rows and every rank
    scores the same gathered rollouts."""
    results, _, _ = runs[mesh]
    first = results[0]["grpo"]["sampled"]
    assert len(first["tokens"]) == GRPO_CFG["group_size"] * \
        GRPO_CFG["tasks_per_step"]
    for r in results[1:]:
        assert r["grpo"]["sampled"] == first


# ---------------------------------------------------------------------------
# which blocks split over model
# ---------------------------------------------------------------------------
def test_model_split_on_scope_tiny(runs):
    """(1, 2): attention (4 heads on 2) and the MLP (d_ff 384) split, as
    does the vocabulary; (1, 4): 2 kv heads do not divide, so attention
    computes whole on every rank while the MLP still splits."""
    assert runs[(1, 2)][0][0]["tiny"]["split"] == [True, True, True, False]
    assert runs[(2, 2)][0][0]["tiny"]["split"] == [True, True, True, False]
    assert runs[(1, 4)][0][0]["tiny"]["split"] == [False, True, True, False]
    assert runs[(2, 1)][0][0]["tiny"]["split"] == [False, False, False,
                                                    False]


def test_model_split_rules():
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import model_split
    from repro_torch.distributed.sharding import MeshSpec
    starcoder = get_config("starcoder2-3b")
    mesh = MeshSpec(("data", "model"), (1, 4))
    # 24 heads on 2: the spec cuts wk mid-head, and attention stays whole
    assert starcoder.num_kv_heads == 2
    assert model_split(starcoder, mesh).attn is False
    from repro_torch.configs.scope_estimator import CONFIG as qwen
    for n in (2, 4):
        assert model_split(qwen, MeshSpec(("data", "model"), (1, n))) == (
            True, True, True, False)
    assert model_split(qwen, MeshSpec(("data", "model"), (4, 1))) == (
        False, False, False, False)
    # Mamba's SSD heads: mamba2-1.3b's 64 at model 2 and 4 (no attention),
    # zamba2-7b's 112 at 4 and 8 (its shared block's 32 on 32 heads and
    # d_ff 14336 split too); 112 heads on 32 do not divide, so the layer
    # computes whole, as does every layer at model 1
    mamba = get_config("mamba2-1.3b")
    zamba = get_config("zamba2-7b")
    assert mamba.resolved_ssm_heads == 64
    assert zamba.resolved_ssm_heads == 112
    for n in (2, 4):
        split = model_split(mamba, MeshSpec(("data", "model"), (1, n)))
        assert split.ssm is True and split.attn is False
    for n in (4, 8):
        assert model_split(zamba, MeshSpec(("data", "model"), (2, n))) == (
            True, True, True, True)
    assert model_split(zamba, MeshSpec(("data", "model"), (1, 32))).ssm \
        is False
    assert model_split(mamba, MeshSpec(("data", "model"), (4, 1))).ssm \
        is False


# ---------------------------------------------------------------------------
# serving under TP
# ---------------------------------------------------------------------------
SERVE_IDS = [f"{nd}x{nm}" for nd, nm in SERVE_MESHES]
SERVE_CASES = ("predict", "refill_dense", "refill_paged")


@pytest.mark.parametrize("case", SERVE_CASES)
@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=SERVE_IDS)
def test_tp_serve_equals_one_process(runs, mesh, case):
    one = runs[(1, 1)][0][0]["serve"][case]
    for r in runs[mesh][0]:
        got = r["serve"][case]
        tdist._same_pools(tdist._pools(got), tdist._pools(one))
        if "stats" in one:
            assert got["stats"] == one["stats"]


@pytest.mark.parametrize("case", SERVE_CASES)
@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=SERVE_IDS)
def test_tp_serve_equals_reference_one_device(runs, reference_serve, mesh,
                                              case):
    got = runs[mesh][0][0]["serve"][case]
    want = reference_serve[case]
    tdist._same_pools(tdist._pools(got), tdist._pools(want))
    if "stats" in want:
        assert got["stats"] == want["stats"]


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=SERVE_IDS)
def test_tp_decode_cache_holds_local_kv_heads(runs, mesh):
    """scope-tiny's 2 kv heads: one a rank at ``model`` = 2."""
    assert runs[(1, 1)][0][0]["serve"]["kv_heads"] == 2
    for r in runs[mesh][0]:
        assert r["serve"]["kv_heads"] == 2 // mesh[1]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_sharded_checkpoint_is_the_one_process_file(runs, mesh):
    """rank 0 writes the bytes one process writes for the same params; no
    other rank writes (each mesh has a directory of its own)."""
    _, _, sub = runs[mesh]
    _, _, one = runs[(1, 1)]
    assert (sub / "tiny_saved.npz").read_bytes() == \
        (one / "tiny_saved.npz").read_bytes()


def test_reference_loader_reads_the_sharded_checkpoint(runs,
                                                       reference_params):
    import jax

    from repro.training import checkpoint as jckpt
    _, _, sub = runs[(2, 2)]
    want = reference_params["tiny"]
    got = jckpt.load(str(sub / "tiny_saved.npz"), want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])
