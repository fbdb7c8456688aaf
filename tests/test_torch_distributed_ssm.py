"""Mamba's SSD heads split over ``model``, and the SSM backbones over a
device mesh on the CPU: params placed by ``ReasoningEstimator.shard`` over
gloo ranks spawned as processes (one thread each), against one process of
the port and the reference's one-device run on the same weights.

Two configs, float32, weights bridged from the reference's
``init_params``: the small pure-SSM config (``mamba2-1.3b`` ``.reduced()``
with its shared block off: 16 heads of 32, state 16, ``in_proj`` 1072
columns) and the small zamba2 hybrid (``zamba2-7b`` ``.reduced(num_layers=5,
d_model=448)``: 28 heads, ``in_proj`` 1852 columns, the tied attention
block's 4 heads split too).  Every rank runs ``mesh_cases`` on each of its
world's meshes — world 2 over (2, 1) and (1, 2), world 4 over (2, 2) and
(1, 4) — and rank 0 writes the results:

  * the loss and every gradient leaf (gathered whole) of one batch, the
    heads of every ``ops.ssd`` call, the columns of every ``in_proj``
    product, every parameter all-gather, each rank's param bytes;
  * one ``sft_step`` (its loss and params);
  * where ``model`` > 1, the gated norm over a row split over ``model``
    (``ssm._gated_norm`` on ``collectives.shared_sum``): each rank's share
    of the output and of the gradients of a drawn loss;
  * on (1, 2) and (2, 2): a batch predict and a dense refill stream of a
    ``ScopeEngine`` on each config, greedy tokens of ``sampler.generate``,
    the heads of every SSD scan and decode step, and the shapes of a rank's
    decode caches.

Tolerances, float32: the loss within 2e-5, each gradient leaf within 1e-4
of its largest magnitude, one step's loss and params within 2e-5; tokens,
parsed fields and decisions equal, ``p_hat`` within 2e-5.

Run as a script, this file is one rank's worker:

  RANK=0 WORLD_SIZE=2 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
      python tests/test_torch_distributed_ssm.py OUT_DIR PARAMS_DIR
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import test_torch_distributed as tdist
import test_torch_distributed_training as ttrain

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
MESHES = ttrain.MESHES
SERVE_MESHES = ttrain.SERVE_MESHES
CONFIGS = ("mamba", "zamba")
F32_TOL, GRAD_TOL = 2e-5, 1e-4
# heads, d_inner and state of the small configs
SHAPES = {"mamba": (16, 512, 16), "zamba": (28, 896, 16)}


def port_config(name):
    from repro_torch.configs import get_config
    if name == "mamba":
        return dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                                   shared_attn_every=0)
    return get_config("zamba2-7b").reduced(num_layers=5, d_model=448)


def reference_config(name):
    from repro.configs import get_config
    if name == "mamba":
        return dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                                   shared_attn_every=0)
    return get_config("zamba2-7b").reduced(num_layers=5, d_model=448)


# ---------------------------------------------------------------------------
# the cases: every rank of a mesh, or one process (mesh=None)
# ---------------------------------------------------------------------------
class Probe:
    """While installed: the heads of every ``ops.ssd`` and
    ``ops.ssd_decode_step`` call and the columns of every ``in_proj``
    product (``ssm._split_proj``'s input)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import ssm
        self.seen = {"ssd": set(), "ssd_decode_step": set(), "in_proj": set()}
        self._saved = (ops.ssd, ops.ssd_decode_step, ssm._split_proj)

        def scan(x, *a, **kw):
            self.seen["ssd"].add(x.shape[2])
            return self._saved[0](x, *a, **kw)

        def step(state, x, *a, **kw):
            self.seen["ssd_decode_step"].add(x.shape[1])
            return self._saved[1](state, x, *a, **kw)

        def proj(dims, zxbcdt):
            self.seen["in_proj"].add(zxbcdt.shape[-1])
            return self._saved[2](dims, zxbcdt)

        ops.ssd, ops.ssd_decode_step, ssm._split_proj = scan, step, proj
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        from repro_torch.models import ssm
        ops.ssd, ops.ssd_decode_step, ssm._split_proj = self._saved
        return False

    def result(self):
        return {k: sorted(v) for k, v in self.seen.items()}


def mesh_cases(params_dir, mesh=None):
    """(results, arrays) of every case on ``mesh`` (None: one process)."""
    from repro_torch import io
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.io import flatten
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                value_and_grad)
    from repro_torch.training.sft import sft_step

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

    # test_torch_training.py's one-step config
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=100)
    for name in CONFIGS:
        cfg = port_config(name)
        plain = load(name)
        params = placed(name)
        batch = to_tensors(ttrain.lm_batch(cfg.vocab_size), "cpu")
        seq = batch["tokens"].shape[1]
        seen.clear()
        coll._all_gather = record
        try:
            with Probe() as probe:
                loss, metrics, grads = value_and_grad(
                    lambda p, cfg=cfg, batch=batch: M.loss_fn(p, cfg, batch),
                    params)
        finally:
            coll._all_gather = gather
        arrays[f"{name}/loss"] = loss.numpy()
        arrays[f"{name}/ce"] = metrics["ce"].numpy()
        for key, g in flatten(grads).items():
            arrays[f"{name}/grad/{key}"] = ttrain._whole(g)
        allowed = ttrain._allowed_gathers(plain, n_model) | {
            (r, seq, cfg.vocab_size) for r in (2, 4, 8)}
        res[name] = {
            "split": (None if mesh is None
                      else list(coll.model_split(cfg, mesh))),
            "probe": probe.result(),
            "gathers": len(seen),
            "bad_gathers": sorted({s for s in seen if s not in allowed}),
            "local_bytes": sum(coll.local(t).numel() * t.element_size()
                               for t in flatten(params).values()),
            "want_bytes": (None if mesh is None else shd.local_bytes(
                mesh, plain, shd.param_specs(mesh, plain)))}
        params = placed(name)
        params, _, loss, _ = sft_step(params, cfg, adamw_init(params), batch,
                                      opt_cfg)
        arrays[f"{name}/sft1/loss"] = loss.numpy()
        for key, t in flatten(params).items():
            arrays[f"{name}/sft1/params/{key}"] = ttrain._whole(t)
    if mesh is not None and n_model > 1:
        res["norm"] = norm_case(mesh, arrays)
    if mesh is None or tuple(mesh.shape) in SERVE_MESHES:
        res["serve"] = {name: serve_cases(name, load(name), mesh)
                        for name in CONFIGS}
    return res, arrays


def norm_inputs(din: int):
    """y, z, the norm scale and the loss's weights over whole rows."""
    import torch
    r = np.random.default_rng(3)
    y, z, w = (torch.from_numpy(r.standard_normal((3, 5, din))
                                .astype(np.float32)) for _ in range(3))
    scale = torch.from_numpy(r.uniform(0.5, 1.5, din).astype(np.float32))
    return y, z, scale, w


def whole_norm(din: int):
    """The whole-row gated norm, its output and gradients (y, z, scale) of
    sum(out * w): the yardstick of ``norm_case``."""
    import torch

    from repro_torch.models import ssm
    cfg = port_config("mamba")
    y, z, scale, w = norm_inputs(din)
    for t in (y, z, scale):
        t.requires_grad_(True)
    out = ssm._gated_norm({"norm": {"scale": scale}}, cfg, y, z, None)
    grads = torch.autograd.grad((out * w).sum(), (y, z, scale))
    return [out.detach().numpy(), *(g.numpy() for g in grads)]


def norm_case(mesh, arrays):
    """The gated norm over rows split over ``model``: this rank's slice of
    y, z and the scale, the sum of squares shared (``shared_sum``), the
    gradient of its share of sum(out * w).  Rank 0's pieces go in
    ``arrays``; every rank reports its largest differences from the whole
    row's."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives as coll
    from repro_torch.models import ssm
    cfg = port_config("mamba")
    din = cfg.d_inner
    group = mesh.get_group("model")
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    tp = coll.TP(group, rank, n, None, False)
    y, z, scale, w = norm_inputs(din)
    part = slice(rank * din // n, (rank + 1) * din // n)
    mine = [t[..., part].clone().requires_grad_(True) for t in (y, z, scale)]
    out = ssm._gated_norm({"norm": {"scale": mine[2]}}, cfg, mine[0],
                          mine[1], tp)
    grads = torch.autograd.grad((out * w[..., part]).sum(), mine)
    want = whole_norm(din)
    got = [out.detach().numpy(), *(g.numpy() for g in grads)]
    return [float(np.abs(g - wt[..., part]).max() /
                  max(float(np.abs(wt).max()), 1e-30))
            for g, wt in zip(got, want, strict=True)]


def serve_cases(name, params, mesh):
    """A batch predict and a dense refill stream of a ``ScopeEngine`` on
    ``name``'s config, greedy tokens of ``sampler.generate``, the heads its
    SSD calls see, and a rank's decode caches."""
    from repro_torch import api
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.core.fingerprint import (FingerprintLibrary,
                                              build_anchor_set)
    from repro_torch.core.retrieval import AnchorRetriever
    from repro_torch.data.datasets import build_scope_data, stratified_anchors
    from repro_torch.data.worldsim import World
    from repro_torch.serving import sampler as S
    from repro_torch.serving.scheduler import BucketConfig, MicrobatchScheduler

    cfg = port_config(name)
    world = World(seed=0)
    data = build_scope_data(world, n_queries=200, seed=0)
    anchors = build_anchor_set(world, stratified_anchors(world, n=80, seed=7))
    retr = AnchorRetriever(anchors, device="cpu")
    queries = [data.queries[int(q)] for q in data.test_qids[:6]]

    def estimator():
        est = ReasoningEstimator(cfg, params, max_new_tokens=tdist.NEW_TOKENS)
        return est if mesh is None else est.shard(mesh)

    def mk(**kw):
        lib = FingerprintLibrary(anchors)
        for m in world.pool:
            if m.seen:
                lib.onboard(world, m.name, seed=3)
        return api.ScopeEngine.build(api.EngineConfig(
            estimator=estimator(), retriever=retr, library=lib,
            models_meta={m: world.models[m] for m in data.models}, **kw))

    ticks = [queries[:2], queries[2:3], queries[3:6]]
    with Probe() as probe:
        eng = mk()
        out = {"predict": tdist._pool(eng.predict(
            api.RouteRequest(queries[:4])), eng, api.FixedAlphaPolicy)}
        eng = mk(refill=True)
        sched = MicrobatchScheduler(BucketConfig(batch_sizes=(1, 2, 4, 8)))
        pools = list(eng.predict_stream(
            (api.RouteRequest(t) for t in ticks), scheduler=sched))
        out["refill_dense"] = {
            "pools": [tdist._pool(p, eng, api.FixedAlphaPolicy)
                      for p in pools],
            "stats": {f: getattr(sched.stats, f) for f in tdist.STAT_FIELDS}}
        prompts = np.random.default_rng(4).integers(
            3, cfg.vocab_size, size=(4, 12)).astype(np.int32)
        gen, _ = S.generate(estimator().params, cfg, prompts,
                            max_new_tokens=5)
        out["tokens"] = np.asarray(gen).tolist()
        run = estimator().open_slots(np.full((4, 16), 5, np.int32))
    out["heads"] = probe.result()
    out["caches"] = {f"{i}/{j}/{k}": list(t.shape) for i, seg in
                     enumerate(run.state.caches) for j, unit in seg.items()
                     for k, t in unit.items()}
    return out


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------
def worker(out_dir: str, params_dir: str, cases=None) -> None:
    """One rank: ``cases`` (this file's ``mesh_cases`` by default) on each
    of its world's meshes, its results and rank 0's arrays written under
    ``out_dir``."""
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_serve_mesh
    cases = cases or mesh_cases
    init_distributed("cpu")
    try:
        for nd, nm in MESHES[dist.get_world_size()]:
            mesh = make_serve_mesh(n_data=nd, n_model=nm)
            sub = Path(out_dir) / f"{nd}x{nm}"
            sub.mkdir(exist_ok=True)
            res, arrays = cases(params_dir, mesh)
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
def reference_params():
    import jax

    from repro.models import model as JM
    return {name: JM.init_params(jax.random.PRNGKey(0),
                                 reference_config(name))
            for name in CONFIGS}


@pytest.fixture(scope="module")
def params_dir(reference_params, tmp_path_factory):
    import jax

    from repro_torch import io
    from repro_torch.training import checkpoint
    out = tmp_path_factory.mktemp("ssm_params")
    for name, params in reference_params.items():
        checkpoint.save(str(out / f"{name}.npz"), io.params_from_numpy(
            jax.tree.map(np.asarray, params), port_config(name),
            device="cpu"))
    return out


def spawn_runs(script, cases, params_dir, tmp_path_factory, tag: str):
    """{(nd, nm): (rank results, rank 0's arrays)} of ``script``'s worker
    over worlds 2 and 4, and ``cases``' one-process results under (1, 1);
    both worlds start at once and the one-process cases run meanwhile."""
    dirs = {w: tmp_path_factory.mktemp(f"{tag}_world{w}") for w in MESHES}
    started = {}
    for w in MESHES:
        env = tdist.rank_env(w)
        started[w] = [subprocess.Popen(
            [sys.executable, str(script), str(dirs[w]), str(params_dir)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(w)]
    res, arrays = cases(params_dir, None)
    out = {(1, 1): ([json.loads(json.dumps(res))], arrays)}
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
                              for r in range(w)], arrays)
    return out


@pytest.fixture(scope="module")
def runs(params_dir, tmp_path_factory):
    return spawn_runs(__file__, mesh_cases, params_dir, tmp_path_factory,
                      "ssm")


@pytest.fixture(scope="module")
def reference_grads(reference_params):
    """{name: (loss, {key: gradient})} of the reference's one-device
    ``jax.value_and_grad(M.loss_fn)`` on the batch of ``mesh_cases``."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro_torch import io
    out = {}
    for name, params in reference_params.items():
        cfg = reference_config(name)
        batch = {k: jnp.asarray(v)
                 for k, v in ttrain.lm_batch(cfg.vocab_size).items()}
        (loss, _), grads = jax.value_and_grad(
            lambda p, cfg=cfg, batch=batch: JM.loss_fn(p, cfg, batch),
            has_aux=True)(params)
        port = io.params_from_numpy(jax.tree.map(np.asarray, grads),
                                    port_config(name), device="cpu")
        out[name] = (float(loss), {k: v.float().numpy() for k, v in
                                   io.flatten(port).items()})
    return out


ALL_MESHES = ttrain.ALL_MESHES
MESH_IDS = ttrain.MESH_IDS
SPLIT_MESHES = [m for m in ALL_MESHES if m[1] > 1]
SPLIT_IDS = [f"{nd}x{nm}" for nd, nm in SPLIT_MESHES]
SERVE_IDS = [f"{nd}x{nm}" for nd, nm in SERVE_MESHES]


def _grads(arrays, name):
    pre = f"{name}/grad/"
    return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}


# ---------------------------------------------------------------------------
# losses, gradients and a step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_loss_and_gradients_equal_one_process(runs, mesh, name):
    _, arrays = runs[mesh]
    _, one = runs[(1, 1)]
    for k in ("loss", "ce"):
        assert abs(float(arrays[f"{name}/{k}"]) - float(one[f"{name}/{k}"])
                   ) <= F32_TOL, k
    ttrain._close_grads(_grads(arrays, name), _grads(one, name))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", [(1, 1)] + ALL_MESHES,
                         ids=["one"] + MESH_IDS)
def test_loss_and_gradients_equal_reference_one_device(runs, reference_grads,
                                                       mesh, name):
    _, arrays = runs[mesh]
    loss, grads = reference_grads[name]
    assert abs(float(arrays[f"{name}/loss"]) - loss) <= F32_TOL
    ttrain._close_grads(_grads(arrays, name), grads)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_one_sft_step_equals_one_process(runs, mesh, name):
    """The step's loss within 2e-5, and each param within 2e-5 wherever its
    gradient is above the gradient tests' noise (1e-4 of the leaf's
    largest): AdamW's first step moves a param by about lr_t g / |g|, so
    where g is float noise (the hybrid's ``embed`` has elements at 5e-8,
    2e-7 of its largest, whose sign two exact sums may differ on) it moves
    it by up to lr_t either way; there the params differ by at most twice
    the step's largest move."""
    sys.path.insert(0, str(SRC))
    from repro_torch.training.optimizer import AdamWConfig, lr_at
    _, arrays = runs[mesh]
    _, one = runs[(1, 1)]
    assert abs(float(arrays[f"{name}/sft1/loss"])
               - float(one[f"{name}/sft1/loss"])) <= F32_TOL
    lr = float(lr_at(AdamWConfig(lr=1e-3, warmup_steps=20,
                                 total_steps=100), 1))
    pre = f"{name}/sft1/params/"
    keys = [k for k in one if k.startswith(pre)]
    assert keys
    for k in keys:
        g = one[f"{name}/grad/{k[len(pre):]}"]
        sure = np.abs(g) > GRAD_TOL * max(float(np.abs(g).max()), 1e-30)
        np.testing.assert_allclose(arrays[k][sure], one[k][sure], rtol=0,
                                   atol=F32_TOL, err_msg=k)
        assert np.abs(arrays[k] - one[k]).max() <= 2 * lr * (
            1 + 0.01 * np.abs(one[k]).max()), k


# ---------------------------------------------------------------------------
# the split: heads, columns, gathers, bytes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_ssd_sees_a_rank_s_heads_and_in_proj_columns(runs, mesh, name):
    """Every SSD scan of the loss sees h / n heads, every ``in_proj``
    product has 2 d_inner / n + 2 n + h / n columns; ``model_split``
    reports Mamba split wherever ``model`` > 1 (16 and 28 heads divide 2
    and 4)."""
    h, din, state = SHAPES[name]
    n = mesh[1]
    for r in runs[mesh][0]:
        got = r[name]
        assert got["split"][3] is (n > 1)
        assert got["probe"]["ssd"] == [h // n]
        assert got["probe"]["in_proj"] == [2 * din // n + 2 * state + h // n]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_no_gather_returns_more_than_one_layer(runs, mesh, name):
    """Every parameter all-gather of the loss returned one layer of a
    stacked leaf or an unstacked leaf (each maybe split over ``model``),
    and each rank holds ``local_bytes`` of params."""
    for r in runs[mesh][0]:
        assert r[name]["bad_gathers"] == []
        assert r[name]["gathers"] > 0
        assert r[name]["local_bytes"] == r[name]["want_bytes"]


@pytest.mark.parametrize("mesh", SPLIT_MESHES, ids=SPLIT_IDS)
def test_gated_norm_over_split_rows_equals_the_whole_row(runs, mesh):
    """``shared_sum``'s all-reduce forward and backward: each rank's share
    of the output and of the gradients of y, z and the scale within 1e-6
    of the whole row's (relative to its largest)."""
    for r in runs[mesh][0]:
        assert max(r["norm"]) <= 1e-6, r["norm"]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ("predict", "refill_dense"))
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=SERVE_IDS)
def test_serve_equals_one_process(runs, mesh, name, case):
    one = runs[(1, 1)][0][0]["serve"][name]
    for r in runs[mesh][0]:
        got = r["serve"][name]
        tdist._same_pools(tdist._pools(got[case]), tdist._pools(one[case]))
        if "stats" in one[case]:
            assert got[case]["stats"] == one[case]["stats"]
        assert got["tokens"] == one["tokens"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=SERVE_IDS)
def test_decode_caches_and_ssd_calls_hold_a_rank_s_heads(runs, mesh, name):
    """A rank's caches: ``ssm`` (b, h / n, hd, state) and ``conv`` (b, w - 1,
    d_inner / n + 2 state) in each layer stack; every scan and decode step
    of the serve at h / n heads."""
    h, din, state = SHAPES[name]
    nd, n = mesh
    one = runs[(1, 1)][0][0]["serve"][name]
    assert one["heads"]["ssd"] == one["heads"]["ssd_decode_step"] == [h]
    for r in runs[mesh][0]:
        got = r["serve"][name]
        assert got["heads"]["ssd"] == [h // n]
        assert got["heads"]["ssd_decode_step"] == [h // n]
        ssm = [v for k, v in got["caches"].items() if k.endswith("/ssm")]
        conv = [v for k, v in got["caches"].items() if k.endswith("/conv")]
        assert ssm and conv
        for s in ssm:
            assert s[1:] == [4 // nd, h // n, 32, state]
        for c in conv:
            assert c[1:] == [4 // nd, 3, din // n + 2 * state]


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])
