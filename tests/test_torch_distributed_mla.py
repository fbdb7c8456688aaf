"""MLA's heads split over ``model``, and deepseek-v2-lite-16b over a device
mesh on the CPU: params placed by ``ReasoningEstimator.shard`` over gloo
ranks spawned as processes (one thread each), against one process of the
port and the reference's one-device run on the same weights.

The config is deepseek-v2-lite-16b's ``.reduced()`` on both sides, float32,
weights bridged from the reference's ``init_params``: 4 heads, q / k head
dim 48 (nope 32 + rope 16), v 32, a latent of 64, a dense MLA first layer
and an MLA + MoE layer (4 experts, top-2, a shared expert).  The batch is
8 x 64 tokens: two routing groups of 256, so on (2, 2) the rows also split
over ``data``.  Every rank runs ``mesh_cases`` on each of its world's
meshes — world 2 over (2, 1) and (1, 2), world 4 over (2, 2) and (1, 4) —
and rank 0 writes the results:

  * the loss, its metrics and every gradient leaf (gathered whole) of the
    batch, the (heads, d, dv) of every ``ops.flash_attention`` call, every
    parameter all-gather, each rank's param bytes;
  * one ``sft_step`` (its loss and params);
  * on (1, 2) and (2, 2): a batch predict and a dense refill stream of a
    ``ScopeEngine``, greedy tokens of ``sampler.generate``, the heads of
    every flash call and ``mla_decode`` of the serve, and the shapes of a
    rank's decode caches.

Tolerances, float32: the loss and ``aux`` within 2e-5, each gradient leaf
within 1e-4 of its largest magnitude, one step's loss and params within
2e-5; tokens, parsed fields and decisions equal, ``p_hat`` within 2e-5.

Run as a script, this file is one rank's worker:

  RANK=0 WORLD_SIZE=2 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
      python tests/test_torch_distributed_mla.py OUT_DIR PARAMS_DIR
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import test_torch_distributed as tdist
import test_torch_distributed_ssm as tssm
import test_torch_distributed_training as ttrain

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
MESHES = ttrain.MESHES
SERVE_MESHES = ttrain.SERVE_MESHES
NAME = "deepseek"
SEQ = 64
F32_TOL, GRAD_TOL = 2e-5, 1e-4
# heads, q / k head dim, v head dim, latent and rope widths of the config
HEADS, QK, V, LORA, ROPE = 4, 48, 32, 64, 16


def port_config():
    from repro_torch.configs import get_config
    return get_config("deepseek-v2-lite-16b").reduced()


def reference_config():
    from repro.configs import get_config
    return get_config("deepseek-v2-lite-16b").reduced()


def batch_np():
    return ttrain.lm_batch(port_config().vocab_size, SEQ)


# ---------------------------------------------------------------------------
# the cases: every rank of a mesh, or one process (mesh=None)
# ---------------------------------------------------------------------------
class Probe:
    """While installed: (heads, d, dv) of every ``ops.flash_attention``
    call and the heads of every ``attention.mla_decode`` call."""

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import attention
        self.seen = {"flash": set(), "mla_decode": set()}
        self._saved = (ops.flash_attention, attention.mla_decode)

        def flash(q, k, v, *a, **kw):
            self.seen["flash"].add((q.shape[1], q.shape[-1], v.shape[-1]))
            return self._saved[0](q, k, v, *a, **kw)

        def decode(p, cfg, *a, **kw):
            self.seen["mla_decode"].add((cfg.num_heads,))
            return self._saved[1](p, cfg, *a, **kw)

        ops.flash_attention, attention.mla_decode = flash, decode
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        from repro_torch.models import attention
        ops.flash_attention, attention.mla_decode = self._saved
        return False

    def result(self):
        return {k: sorted(list(t) for t in v) for k, v in self.seen.items()}


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

    cfg = port_config()

    def load():
        return io.load_checkpoint(str(Path(params_dir) / f"{NAME}.npz"),
                                  cfg, device="cpu")

    def placed():
        est = ReasoningEstimator(cfg, load())
        return est.params if mesh is None else est.shard(mesh).params

    n_model = 1 if mesh is None else shd.axis_sizes(mesh)["model"]
    arrays = {}
    seen = []
    gather = coll._all_gather

    def record(x, dim, group):
        out = gather(x, dim, group)
        seen.append(tuple(out.shape))
        return out

    plain = load()
    params = placed()
    batch = to_tensors(batch_np(), "cpu")
    coll._all_gather = record
    try:
        with Probe() as probe:
            loss, metrics, grads = value_and_grad(
                lambda p: M.loss_fn(p, cfg, batch), params)
    finally:
        coll._all_gather = gather
    for k in ("ce", "aux"):
        arrays[k] = metrics[k].numpy()
    arrays["loss"] = loss.numpy()
    for key, g in flatten(grads).items():
        arrays[f"grad/{key}"] = ttrain._whole(g)
    allowed = ttrain._allowed_gathers(plain, n_model) | {
        (r, SEQ, cfg.vocab_size) for r in (2, 4, 8)}
    rows = None if mesh is None else coll.train_rows(mesh, cfg, 8, SEQ)
    res = {"split": (None if mesh is None
                     else list(coll.model_split(cfg, mesh))),
           "rows": None if rows is None else [rows.start, rows.stop],
           "probe": probe.result(),
           "gathers": len(seen),
           "bad_gathers": sorted({s for s in seen if s not in allowed}),
           "local_bytes": sum(coll.local(t).numel() * t.element_size()
                              for t in flatten(params).values()),
           "want_bytes": (None if mesh is None else shd.local_bytes(
               mesh, plain, shd.param_specs(mesh, plain)))}
    # test_torch_training.py's one-step config
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=100)
    params = placed()
    params, _, loss, _ = sft_step(params, cfg, adamw_init(params), batch,
                                  opt_cfg)
    arrays["sft1/loss"] = loss.numpy()
    for key, t in flatten(params).items():
        arrays[f"sft1/params/{key}"] = ttrain._whole(t)
    if mesh is None or tuple(mesh.shape) in SERVE_MESHES:
        res["serve"] = serve_cases(plain, mesh)
    return res, arrays


def serve_cases(params, mesh):
    """A batch predict and a dense refill stream of a ``ScopeEngine``,
    greedy tokens of ``sampler.generate``, the heads of the serve's flash
    and ``mla_decode`` calls, and a rank's decode caches."""
    from repro_torch import api
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.serving import sampler as S
    from repro_torch.serving.scheduler import BucketConfig, MicrobatchScheduler

    cfg = port_config()
    data, _, retr = ttrain.scope_world()
    queries = [data.queries[int(q)] for q in data.test_qids[:6]]

    def estimator():
        est = ReasoningEstimator(cfg, params, max_new_tokens=tdist.NEW_TOKENS)
        return est if mesh is None else est.shard(mesh)

    def mk(**kw):
        # a fresh world each time: ``World.embed`` draws from its generator
        data, lib, _ = ttrain.scope_world()
        return api.ScopeEngine.build(api.EngineConfig(
            estimator=estimator(), retriever=retr, library=lib,
            models_meta={m: data.world.models[m] for m in data.models},
            **kw))

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
# fixtures
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_params():
    import jax

    from repro.models import model as JM
    return JM.init_params(jax.random.PRNGKey(0), reference_config())


@pytest.fixture(scope="module")
def params_dir(reference_params, tmp_path_factory):
    import jax

    from repro_torch import io
    from repro_torch.training import checkpoint
    out = tmp_path_factory.mktemp("mla_params")
    checkpoint.save(str(out / f"{NAME}.npz"), io.params_from_numpy(
        jax.tree.map(np.asarray, reference_params), port_config(),
        device="cpu"))
    return out


@pytest.fixture(scope="module")
def runs(params_dir, tmp_path_factory):
    """{(nd, nm): (rank results, rank 0's arrays)} and the one-process
    results under (1, 1)."""
    return tssm.spawn_runs(__file__, mesh_cases, params_dir,
                           tmp_path_factory, "mla")


@pytest.fixture(scope="module")
def reference_grads(reference_params):
    """(loss, aux, {key: gradient}) of the reference's one-device
    ``jax.value_and_grad(M.loss_fn)`` on the batch of ``mesh_cases``."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro_torch import io
    batch = {k: jnp.asarray(v) for k, v in batch_np().items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, reference_config(), batch),
        has_aux=True)(reference_params)
    port = io.params_from_numpy(jax.tree.map(np.asarray, grads),
                                port_config(), device="cpu")
    return (float(loss), float(metrics["aux"]),
            {k: v.float().numpy() for k, v in io.flatten(port).items()})


ALL_MESHES = ttrain.ALL_MESHES
MESH_IDS = ttrain.MESH_IDS
SERVE_IDS = [f"{nd}x{nm}" for nd, nm in SERVE_MESHES]


def _grads(arrays):
    return {k[len("grad/"):]: v for k, v in arrays.items()
            if k.startswith("grad/")}


# ---------------------------------------------------------------------------
# losses, gradients and a step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_loss_and_gradients_equal_one_process(runs, mesh):
    _, arrays = runs[mesh]
    _, one = runs[(1, 1)]
    for k in ("loss", "ce", "aux"):
        assert abs(float(arrays[k]) - float(one[k])) <= F32_TOL, k
    ttrain._close_grads(_grads(arrays), _grads(one))


@pytest.mark.parametrize("mesh", [(1, 1)] + ALL_MESHES,
                         ids=["one"] + MESH_IDS)
def test_loss_and_gradients_equal_reference_one_device(runs, reference_grads,
                                                       mesh):
    _, arrays = runs[mesh]
    loss, aux, grads = reference_grads
    assert abs(float(arrays["loss"]) - loss) <= F32_TOL
    assert abs(float(arrays["aux"]) - aux) <= F32_TOL
    ttrain._close_grads(_grads(arrays), grads)


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_one_sft_step_equals_one_process(runs, mesh):
    """The step's loss within 2e-5, and each param within 2e-5 wherever its
    gradient is above the gradient tests' noise (1e-4 of the leaf's
    largest); elsewhere AdamW's first step moves a param by about lr_t
    either way, so there the params differ by at most twice the step's
    largest move (``test_torch_distributed_ssm``'s reading)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.training.optimizer import AdamWConfig, lr_at
    _, arrays = runs[mesh]
    _, one = runs[(1, 1)]
    assert abs(float(arrays["sft1/loss"]) - float(one["sft1/loss"])) \
        <= F32_TOL
    lr = float(lr_at(AdamWConfig(lr=1e-3, warmup_steps=20,
                                 total_steps=100), 1))
    pre = "sft1/params/"
    keys = [k for k in one if k.startswith(pre)]
    assert keys
    for k in keys:
        g = one[f"grad/{k[len(pre):]}"]
        sure = np.abs(g) > GRAD_TOL * max(float(np.abs(g).max()), 1e-30)
        np.testing.assert_allclose(arrays[k][sure], one[k][sure], rtol=0,
                                   atol=F32_TOL, err_msg=k)
        assert np.abs(arrays[k] - one[k]).max() <= 2 * lr * (
            1 + 0.01 * np.abs(one[k]).max()), k


# ---------------------------------------------------------------------------
# the split: heads, rows, gathers, bytes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_flash_sees_a_rank_s_heads(runs, mesh):
    """Every flash call of the loss (both MLA layers, forward under remat
    and again in the backward) sees 4 / model heads at q / k 48, v 32, and
    ``model_split`` reports attention split wherever ``model`` > 1; the
    one process sees all 4 heads."""
    n = mesh[1]
    assert runs[(1, 1)][0][0]["probe"]["flash"] == [[HEADS, QK, V]]
    for r in runs[mesh][0]:
        assert r["split"][0] is (n > 1)
        assert r["probe"]["flash"] == [[HEADS // n, QK, V]]


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_moe_rows_split_where_groups_divide(runs, mesh):
    """8 x 64 tokens route in two groups of 256: over ``data`` = 2 rank r
    computes rows 4 r to 4 r + 4 (ranks along ``model`` the same), over
    ``data`` = 1 every row."""
    nd, _ = mesh
    for r in runs[mesh][0]:
        c = r["coord"][0]
        assert r["rows"] == [8 // nd * c, 8 // nd * (c + 1)]


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_no_gather_returns_more_than_one_layer(runs, mesh):
    """Every parameter all-gather of the loss returned one layer of a
    stacked leaf or an unstacked leaf (each maybe split over ``model``),
    and each rank holds ``local_bytes`` of params."""
    for r in runs[mesh][0]:
        assert r["bad_gathers"] == []
        assert r["gathers"] > 0
        assert r["local_bytes"] == r["want_bytes"]


def _fake_layout(n_model: int, split, monkeypatch):
    """A ``Layout`` of ``n_model`` ranks along ``model`` with no group
    behind it (``enter`` and ``leave`` of a group of None are identities),
    its gathers over ``model`` made of ``n_model`` copies of rank 0's
    block."""
    import torch

    from repro_torch.distributed import collectives as coll
    monkeypatch.setattr(coll, "gather", lambda x, dim, group, summed:
                        torch.cat([x] * n_model, dim))
    return coll.Layout(None, split, False, None, None, 1, n_model, 0)


def _mla_layer_blocks(cfg, n_model: int, cut: bool = True):
    """Layer 0 of ``cfg``'s first segment (the dense MLA layer) as rank 0's
    ``Block``s under the reference's specs on (1, ``n_model``); ``cut``
    False leaves every leaf uncut (a spec that does not cut over
    ``model``)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.sharding import MeshSpec
    from repro_torch.io import flatten
    from repro_torch.models import model as M
    params = M.init_params(cfg, seed=0, device="cpu")
    mesh = MeshSpec(("data", "model"), (1, n_model))
    specs = shd.param_specs(mesh, params)

    def block(key, t):
        spec = specs[key][1:] if cut else (None,) * (t.dim() - 1)
        dims = tuple(d for d, s in enumerate(spec) if s == "model")
        local = t[0]
        for d in dims:
            local = local.narrow(d, 0, local.shape[d] // n_model)
        return coll.Block(local, tuple(("model", d) for d in dims))

    flat = {k: v for k, v in flatten(params).items()
            if k.startswith("k:segments|i:0|k:0|")}

    def tree(prefix, sub):
        if isinstance(sub, dict):
            return {k: tree(f"{prefix}|k:{k}", v) for k, v in sub.items()}
        return block(prefix, flat[prefix])
    seg = params["segments"][0]["0"]
    return tree("k:segments|i:0|k:0", seg), seg


def test_layout_block_splits_mla_where_heads_divide(monkeypatch):
    """4 heads on ``model`` 2 and 4: ``model_split`` splits attention and
    ``Layout.block`` keeps rank 0's columns of ``wq``, ``w_uk``, ``w_uv``
    and rows of ``wo``, ``w_dkv`` and ``kv_norm`` whole, and returns a
    config of 4 / n heads (the other widths as they were)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import MeshSpec
    cfg = port_config()
    for n in (2, 4):
        split = coll.model_split(cfg, MeshSpec(("data", "model"), (1, n)))
        assert split.attn is True
        blocks, whole = _mla_layer_blocks(cfg, n)
        out, tp = _fake_layout(n, split, monkeypatch).block(blocks, cfg, "mla")
        a, w = out["attn"], whole["attn"]
        for k, dim in (("wq", 1), ("w_uk", 1), ("w_uv", 1), ("wo", 0)):
            want = list(w[k].shape[1:])
            want[dim] //= n
            assert list(a[k].shape) == want, k
        assert a["w_dkv"].shape == w["w_dkv"].shape[1:]
        assert a["kv_norm"]["scale"].shape == w["kv_norm"]["scale"].shape[1:]
        assert tp.attn_cfg.num_heads == HEADS // n
        assert tp.n == n
        for f in ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                  "v_head_dim", "d_model"):
            assert getattr(tp.attn_cfg, f) == getattr(cfg, f), f


def test_mla_computes_whole_where_heads_do_not_divide(monkeypatch):
    """3 heads on ``model`` 2: attention does not split (the spec may still
    cut ``wq`` mid-head) and ``Layout.block`` returns the attention's
    leaves whole, with no local config."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import MeshSpec
    cfg = get_config("deepseek-v2-lite-16b").reduced(num_heads=3)
    split = coll.model_split(cfg, MeshSpec(("data", "model"), (1, 2)))
    assert split.attn is False
    blocks, whole = _mla_layer_blocks(cfg, 2)
    out, tp = _fake_layout(2, split, monkeypatch).block(blocks, cfg, "mla")
    assert tp is None or tp.attn_cfg is None
    assert blocks["attn"]["wq"].cuts == (("model", 1),)
    for k in ("wq", "w_uk", "w_uv", "wo", "w_dkv"):
        assert out["attn"][k].shape == whole["attn"][k].shape[1:], k
    # the full-width config: 16 heads split at 2, 4, 8 and 16, not at 32 or 3
    full = get_config("deepseek-v2-lite-16b")
    for n, want in ((2, True), (4, True), (16, True), (32, False)):
        assert coll.model_split(full, MeshSpec(("data", "model"), (1, n))
                                ).attn is want, n


def test_split_mla_refuses_a_leaf_its_spec_does_not_cut(monkeypatch):
    """A split MLA layer whose ``wq`` is not cut over ``model`` raises
    rather than compute whole."""
    sys.path.insert(0, str(SRC))
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import MeshSpec
    cfg = port_config()
    split = coll.model_split(cfg, MeshSpec(("data", "model"), (1, 2)))
    blocks, _ = _mla_layer_blocks(cfg, 2, cut=False)
    with pytest.raises(ValueError, match="computes split over model"):
        _fake_layout(2, split, monkeypatch).block(blocks, cfg, "mla")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ("predict", "refill_dense"))
@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=SERVE_IDS)
def test_serve_equals_one_process(runs, mesh, case):
    one = runs[(1, 1)][0][0]["serve"]
    for r in runs[mesh][0]:
        got = r["serve"]
        tdist._same_pools(tdist._pools(got[case]), tdist._pools(one[case]))
        if "stats" in one[case]:
            assert got[case]["stats"] == one[case]["stats"]
        assert got["tokens"] == one["tokens"]


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=SERVE_IDS)
def test_serve_attends_a_rank_s_heads_over_whole_latent_caches(runs, mesh):
    """Every flash call and ``mla_decode`` of the serve at 4 / model heads,
    and a rank's latent caches whole: ``c_kv`` (L, b, S, 64) and ``k_rope``
    (L, b, S, 16), every row on every rank (a MoE serve computes every
    row), the shapes one process holds."""
    n = mesh[1]
    one = runs[(1, 1)][0][0]["serve"]
    assert one["heads"] == {"flash": [[HEADS, QK, V]],
                            "mla_decode": [[HEADS]]}
    lat = {k: v for k, v in one["caches"].items()
           if k.endswith(("/c_kv", "/k_rope"))}
    assert lat and len(lat) == len(one["caches"])
    for k, v in lat.items():
        assert v[-1] == (LORA if k.endswith("c_kv") else ROPE), k
        assert v[1] == 4, k
    for r in runs[mesh][0]:
        got = r["serve"]
        assert got["heads"] == {"flash": [[HEADS // n, QK, V]],
                                "mla_decode": [[HEADS // n]]}
        assert got["caches"] == one["caches"]


if __name__ == "__main__":
    tssm.worker(sys.argv[1], sys.argv[2], mesh_cases)
