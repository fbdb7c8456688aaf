"""Whisper's decoder attention and cross-attention split over ``model``, and
whisper-medium over a device mesh on the CPU: params placed by
``ReasoningEstimator.shard`` over gloo ranks spawned as processes (one
thread each), against one process of the port and the reference's
one-device run on the same weights.

The config is whisper-medium's ``.reduced()`` on both sides, float32,
weights bridged from the reference's ``init_params``: 4 heads of 64 (K/V
heads too), 2 encoder and 2 decoder layers, 32 stub frames, a GELU MLP.
The batch is 8 x 20 tokens with 32 frames a row.  Every rank runs
``mesh_cases`` on each of its world's meshes — world 2 over (2, 1) and (1,
2), world 4 over (2, 2) and (1, 4) — and rank 0 writes the results:

  * the loss, its metrics and every gradient leaf (gathered whole, the
    encoder's too) of the batch, the heads of every ``ops.flash_attention``
    call by what it computes (the encoder's, the decoder's self-attention,
    the cross-attention at sq = s), every parameter all-gather, each rank's
    param bytes;
  * where ``model`` > 1, the same gradients with the encoder output's sum
    over ``model`` taken out (``models.model``'s ``coll.enter``, patched
    to the identity): the negative control of that sum;
  * one ``sft_step`` (its loss and params);
  * on (1, 2), (2, 2) and (1, 4): the model-level serve (``prefill`` with
    the frames, then greedy ``decode_step``s, as the reference serves an
    encoder-decoder), its tokens and logits, the heads of its flash calls
    (the cross-attention at sq = 1 too) and dense decode calls, and the
    shapes of a rank's ``k`` / ``v`` / ``ck`` / ``cv``.

Tolerances, float32: the loss within 2e-5, each gradient leaf within 1e-4
of its largest magnitude, one step's loss and params within 2e-5; the
serve's tokens equal and its logits within 2e-5.

Run as a script, this file is one rank's worker:

  RANK=0 WORLD_SIZE=2 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
      python tests/test_torch_distributed_cross.py OUT_DIR PARAMS_DIR
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import test_torch_distributed_mla as tmla
import test_torch_distributed_ssm as tssm
import test_torch_distributed_training as ttrain

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
MESHES = ttrain.MESHES
SERVE_MESHES = ((1, 2), (2, 2), (1, 4))
NAME = "whisper"
SEQ = 20
F32_TOL, GRAD_TOL = 2e-5, 1e-4
# heads, head dim, layers and frames of the config
HEADS, HD, LAYERS, FRAMES = 4, 64, 2, 32
# the serve: rows, prompt tokens, greedy steps
ROWS, PROMPT, STEPS = 4, 12, 5
ENCODER = "k:encoder|"


def port_config():
    from repro_torch.configs import get_config
    return get_config("whisper-medium").reduced()


def reference_config():
    from repro.configs import get_config
    return get_config("whisper-medium").reduced()


def batch_np():
    """``lm_batch``'s 8 x 20 tokens and labels, and 32 seeded frames a
    row."""
    cfg = port_config()
    batch = ttrain.lm_batch(cfg.vocab_size, SEQ)
    batch["enc_features"] = np.random.default_rng(6).standard_normal(
        (8, FRAMES, cfg.d_model)).astype(np.float32)
    return batch


def serve_batch_np():
    """The serve's 4 prompts of 12 tokens and their frames."""
    cfg = port_config()
    rng = np.random.default_rng(7)
    return {"tokens": rng.integers(3, cfg.vocab_size, (ROWS, PROMPT)).astype(
                np.int32),
            "enc_features": rng.standard_normal(
                (ROWS, FRAMES, cfg.d_model)).astype(np.float32)}


# ---------------------------------------------------------------------------
# the cases: every rank of a mesh, or one process (mesh=None)
# ---------------------------------------------------------------------------
class Probe:
    """While installed: the (q-heads, kv-heads) of every
    ``ops.flash_attention`` call by its (sq, sk, causal), and of every
    ``ops.decode_attention`` call."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.seen = {}
        self._saved = (ops.flash_attention, ops.decode_attention)

        def flash(q, k, v, *a, causal=True, **kw):
            key = f"{q.shape[2]}/{k.shape[2]}/{causal}"
            self.seen.setdefault(key, set()).add((q.shape[1], k.shape[1]))
            return self._saved[0](q, k, v, *a, causal=causal, **kw)

        def decode(q, k, *a, **kw):
            self.seen.setdefault("decode", set()).add((q.shape[1],
                                                       k.shape[1]))
            return self._saved[1](q, k, *a, **kw)

        ops.flash_attention, ops.decode_attention = flash, decode
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention, ops.decode_attention = self._saved
        return False

    def result(self):
        return {k: sorted(list(t) for t in v) for k, v in self.seen.items()}


class NoEncoderSum:
    """While installed: ``models.model`` sees ``collectives`` with
    ``enter`` the identity, so the encoder output it hands the decoder
    stack has its gradient summed over nothing (the blocks keep their own
    ``enter``)."""

    def __enter__(self):
        from repro_torch.distributed import collectives as coll
        from repro_torch.models import model as M

        class Proxy:
            def __getattr__(self, name):
                return getattr(coll, name)

            @staticmethod
            def enter(x, group):
                return x

        self._saved = M.coll
        M.coll = Proxy()
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as M
        M.coll = self._saved
        return False


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
    for k in ("ce", "acc"):
        arrays[k] = metrics[k].numpy()
    arrays["loss"] = loss.numpy()
    for key, g in flatten(grads).items():
        arrays[f"grad/{key}"] = ttrain._whole(g)
    if n_model > 1:
        with NoEncoderSum():
            loss, _, grads = value_and_grad(
                lambda p: M.loss_fn(p, cfg, batch), params)
        arrays["nosum/loss"] = loss.numpy()
        for key, g in flatten(grads).items():
            arrays[f"nosum/grad/{key}"] = ttrain._whole(g)
    del grads
    allowed = ttrain._allowed_gathers(plain, n_model) | {
        (r, SEQ, cfg.vocab_size) for r in (4, 8)}
    res = {"split": (None if mesh is None
                     else list(coll.model_split(cfg, mesh))),
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
        res["serve"], arrays["serve/logits"] = serve_cases(placed())
    return res, arrays


def stub_generate(params, cfg, batch):
    """The model-level serve: ``prefill`` with the frames, the caches grown
    by ``STEPS`` slots, then ``STEPS`` greedy ``decode_step``s.  Returns
    (tokens (b, STEPS), logits (b, STEPS + 1, V), the prefill's
    caches)."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.serving.sampler import _pad_caches
    b, s = batch["tokens"].shape
    with torch.no_grad():
        logits, caches = M.prefill(params, cfg, batch)
        shapes = caches
        caches = _pad_caches(caches, s + STEPS, s)
        outs, toks = [logits[:, -1]], []
        for t in range(STEPS):
            nxt = outs[-1].argmax(-1)
            toks.append(nxt)
            lg, caches = M.decode_step(params, cfg, nxt[:, None], caches,
                                       torch.full((b,), s + t))
            outs.append(lg[:, 0])
    return torch.stack(toks, 1), torch.stack(outs, 1), shapes


def serve_cases(params):
    """The model-level serve's tokens, its logits, the heads of its flash
    and decode calls, and a rank's prefill caches' shapes."""
    from repro_torch.data.pipeline import to_tensors
    cfg = port_config()
    with Probe() as probe:
        toks, logits, caches = stub_generate(
            params, cfg, to_tensors(serve_batch_np(), "cpu"))
    out = {"tokens": toks.tolist(), "heads": probe.result(),
           "caches": {f"{i}/{j}/{k}": list(t.shape) for i, seg in
                      enumerate(caches) for j, unit in seg.items()
                      for k, t in unit.items()}}
    return out, logits.numpy()


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
    out = tmp_path_factory.mktemp("cross_params")
    checkpoint.save(str(out / f"{NAME}.npz"), io.params_from_numpy(
        jax.tree.map(np.asarray, reference_params), port_config(),
        device="cpu"))
    return out


@pytest.fixture(scope="module")
def runs(params_dir, tmp_path_factory):
    """{(nd, nm): (rank results, rank 0's arrays)} and the one-process
    results under (1, 1)."""
    return tssm.spawn_runs(__file__, mesh_cases, params_dir,
                           tmp_path_factory, "cross")


@pytest.fixture(scope="module")
def reference_grads(reference_params):
    """(loss, {key: gradient}) of the reference's one-device
    ``jax.value_and_grad(M.loss_fn)`` on the batch of ``mesh_cases``."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro_torch import io
    batch = {k: jnp.asarray(v) for k, v in batch_np().items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, reference_config(), batch),
        has_aux=True)(reference_params)
    port = io.params_from_numpy(jax.tree.map(np.asarray, grads),
                                port_config(), device="cpu")
    return float(loss), {k: v.float().numpy()
                         for k, v in io.flatten(port).items()}


@pytest.fixture(scope="module")
def reference_serve(reference_params):
    """(tokens, logits) of the reference's ``prefill`` and greedy
    ``decode_step``s on the serve's batch."""
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro.serving import sampler as JS
    cfg, params = reference_config(), reference_params
    batch = {k: jnp.asarray(v) for k, v in serve_batch_np().items()}
    logits, caches = JM.prefill(params, cfg, batch)
    caches = JS._pad_caches(caches, PROMPT + STEPS, PROMPT)
    outs, toks = [logits[:, -1]], []
    for t in range(STEPS):
        nxt = jnp.argmax(outs[-1], -1).astype(jnp.int32)
        toks.append(nxt)
        lg, caches = JM.decode_step(params, cfg, nxt[:, None], caches,
                                    jnp.full((ROWS,), PROMPT + t, jnp.int32))
        outs.append(lg[:, 0])
    return (np.asarray(jnp.stack(toks, 1)),
            np.asarray(jnp.stack(outs, 1), np.float32))


ALL_MESHES = ttrain.ALL_MESHES
MESH_IDS = ttrain.MESH_IDS
TP_MESHES = [m for m in ALL_MESHES if m[1] > 1]
TP_IDS = [f"{nd}x{nm}" for nd, nm in TP_MESHES]
SERVE_IDS = [f"{nd}x{nm}" for nd, nm in SERVE_MESHES]


def _grads(arrays, prefix="grad/"):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _leaf_errs(got, want):
    assert got.keys() == want.keys()
    return {k: float(np.abs(got[k] - w).max())
            / max(float(np.abs(w).max()), 1e-12) for k, w in want.items()}


# ---------------------------------------------------------------------------
# losses, gradients and a step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_loss_and_gradients_equal_one_process(runs, mesh):
    """The loss, its metrics and every gradient leaf, the encoder's
    included."""
    _, arrays = runs[mesh]
    _, one = runs[(1, 1)]
    for k in ("loss", "ce", "acc"):
        assert abs(float(arrays[k]) - float(one[k])) <= F32_TOL, k
    grads = _grads(arrays)
    assert any(k.startswith(ENCODER) for k in grads)
    ttrain._close_grads(grads, _grads(one))


@pytest.mark.parametrize("mesh", [(1, 1)] + ALL_MESHES,
                         ids=["one"] + MESH_IDS)
def test_loss_and_gradients_equal_reference_one_device(runs, reference_grads,
                                                       mesh):
    _, arrays = runs[mesh]
    loss, grads = reference_grads
    assert abs(float(arrays["loss"]) - loss) <= F32_TOL
    ttrain._close_grads(_grads(arrays), grads)


@pytest.mark.parametrize("mesh", TP_MESHES, ids=TP_IDS)
def test_encoder_gradients_need_the_sum_over_model(runs, mesh):
    """The negative control: with the encoder output's gradient not summed
    over ``model`` the loss is still right and so is every decoder leaf,
    but every encoder leaf misses the 1e-4 gate (each rank's share of it
    comes only through its own heads' cross K/V)."""
    _, arrays = runs[mesh]
    _, one = runs[(1, 1)]
    assert abs(float(arrays["nosum/loss"]) - float(one["loss"])) <= F32_TOL
    errs = _leaf_errs(_grads(arrays, "nosum/grad/"), _grads(one))
    enc = {k: e for k, e in errs.items() if k.startswith(ENCODER)}
    dec = {k: e for k, e in errs.items() if not k.startswith(ENCODER)}
    assert enc and min(enc.values()) > GRAD_TOL, enc
    assert max(dec.values()) <= GRAD_TOL, dec


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
    assert any(k.startswith(pre + ENCODER) for k in keys)
    for k in keys:
        g = one[f"grad/{k[len(pre):]}"]
        sure = np.abs(g) > GRAD_TOL * max(float(np.abs(g).max()), 1e-30)
        np.testing.assert_allclose(arrays[k][sure], one[k][sure], rtol=0,
                                   atol=F32_TOL, err_msg=k)
        assert np.abs(arrays[k] - one[k]).max() <= 2 * lr * (
            1 + 0.01 * np.abs(one[k]).max()), k


# ---------------------------------------------------------------------------
# the split: heads, gathers, bytes
# ---------------------------------------------------------------------------
def _calls(s):
    """The flash calls' keys: the encoder's, the decoder's causal
    self-attention, the cross-attention at sq = ``s``."""
    return {f"{FRAMES}/{FRAMES}/False": "encoder", f"{s}/{s}/True": "self",
            f"{s}/{FRAMES}/False": "cross"}


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_flash_sees_a_rank_s_heads(runs, mesh):
    """Every flash call of the loss (the encoder's, the decoder's
    self-attention and its cross-attention, forward under remat and again
    in the backward) sees 4 / model heads on as many K/V heads, and
    ``model_split`` reports attention split wherever ``model`` > 1; the one
    process sees all 4."""
    n = mesh[1]
    calls = _calls(SEQ)
    assert runs[(1, 1)][0][0]["probe"] == {k: [[HEADS, HEADS]]
                                           for k in calls}
    for r in runs[mesh][0]:
        assert r["split"][0] is (n > 1)
        assert r["probe"] == {k: [[HEADS // n, HEADS // n]] for k in calls}


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=MESH_IDS)
def test_no_gather_returns_more_than_one_layer(runs, mesh):
    """Every parameter all-gather of the loss returned one layer of a
    stacked leaf or an unstacked leaf (each maybe split over ``model``),
    and each rank holds ``local_bytes`` of params."""
    for r in runs[mesh][0]:
        assert r["bad_gathers"] == []
        assert r["gathers"] > 0
        assert r["local_bytes"] == r["want_bytes"]


def _cross_blocks(n, monkeypatch, cfg=None):
    sys.path.insert(0, str(SRC))
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import MeshSpec
    cfg = cfg or port_config()
    split = coll.model_split(cfg, MeshSpec(("data", "model"), (1, n)))
    blocks, whole = tmla.layer_blocks(cfg, n)
    return cfg, split, blocks, whole, tmla._fake_layout(n, split,
                                                        monkeypatch)


@pytest.mark.parametrize("n", (2, 4))
def test_layout_block_splits_cross_where_heads_divide(monkeypatch, n):
    """4 heads on ``model`` 2 and 4: ``Layout.block`` keeps rank 0's
    columns of the self- and cross-attention's ``wq``, ``wk``, ``wv`` and
    rows of their ``wo``, ``cross_norm`` whole, and returns a config of 4 /
    n heads on 4 / n K/V heads."""
    cfg, split, blocks, whole, lay = _cross_blocks(n, monkeypatch)
    assert split.attn is True
    out, tp = lay.block(blocks, cfg, "attn")
    for name in ("attn", "cross"):
        for k, dim in (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0)):
            want = list(whole[name][k].shape[1:])
            want[dim] //= n
            assert list(out[name][k].shape) == want, (name, k)
    assert out["cross_norm"]["scale"].shape == \
        whole["cross_norm"]["scale"].shape[1:]
    assert (tp.attn_cfg.num_heads, tp.attn_cfg.num_kv_heads) == (
        HEADS // n, HEADS // n)
    assert tp.attn_cfg.head_dim == HD and tp.n == n


def test_cross_computes_whole_where_heads_do_not_divide(monkeypatch):
    """4 heads on ``model`` 3: attention does not split, and
    ``Layout.block`` returns the self- and cross-attention's leaves whole
    with no local config; whisper-medium's 16 heads split at 2, 4, 8 and
    16, not at 3 or 32."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import MeshSpec
    cfg, split, blocks, whole, lay = _cross_blocks(3, monkeypatch)
    assert split.attn is False
    out, tp = lay.block(blocks, cfg, "attn")
    assert tp is None or tp.attn_cfg is None
    for name in ("attn", "cross"):
        for k in ("wq", "wk", "wv", "wo"):
            assert out[name][k].shape == whole[name][k].shape[1:], (name, k)
    full = get_config("whisper-medium")
    for n, want in ((2, True), (4, True), (8, True), (16, True), (3, False),
                    (32, False)):
        assert coll.model_split(full, MeshSpec(("data", "model"), (1, n))
                                ).attn is want, n


@pytest.mark.parametrize("leaf", ("wk", "wo"))
def test_split_cross_refuses_a_leaf_its_spec_does_not_cut(monkeypatch,
                                                          leaf):
    """A split decoder block whose cross-attention ``wk`` (or ``wo``) is not
    cut over ``model`` raises rather than compute it whole."""
    sys.path.insert(0, str(SRC))
    from repro_torch.distributed import collectives as coll
    cfg, split, blocks, whole, lay = _cross_blocks(2, monkeypatch)
    blocks["cross"][leaf] = coll.Block(whole["cross"][leaf][0], ())
    with pytest.raises(ValueError, match="computes split over model"):
        lay.block(blocks, cfg, "attn")


# ---------------------------------------------------------------------------
# the model-level serve
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=SERVE_IDS)
def test_serve_equals_one_process_and_reference(runs, reference_serve,
                                                mesh):
    """``prefill`` with the frames and greedy ``decode_step``s: tokens
    equal and logits within 2e-5 of one process and of the reference's."""
    one = runs[(1, 1)]
    got = runs[mesh]
    toks, logits = reference_serve
    assert one[0][0]["serve"]["tokens"] == toks.tolist()
    np.testing.assert_allclose(one[1]["serve/logits"], logits, rtol=0,
                               atol=F32_TOL)
    for r in got[0]:
        assert r["serve"]["tokens"] == toks.tolist()
    np.testing.assert_allclose(got[1]["serve/logits"], one[1]["serve/logits"],
                               rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(got[1]["serve/logits"], logits, rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=SERVE_IDS)
def test_serve_attends_and_caches_a_rank_s_heads(runs, mesh):
    """Every flash call of the serve (the encoder's, the decoder's
    self-attention, the cross-attention at sq = 12 and at sq = 1) and every
    dense decode call at 4 / model heads, and a rank's ``k`` / ``v`` (L, b,
    4 / model, 12, 64) and ``ck`` / ``cv`` (L, b, 4 / model, 32, 64): the
    reference's ``cache_specs`` block, every row on every rank."""
    n = mesh[1]
    calls = dict(_calls(PROMPT), decode="decode",
                 **{f"1/{FRAMES}/False": "cross_sq1"})
    want = {"k": PROMPT, "v": PROMPT, "ck": FRAMES, "cv": FRAMES}
    for res, h in ((runs[(1, 1)][0][0], HEADS),
                   *((r, HEADS // n) for r in runs[mesh][0])):
        got = res["serve"]
        assert got["heads"] == {k: [[h, h]] for k in calls}
        assert got["caches"] == {f"0/0/{k}": [LAYERS, ROWS, h, s, HD]
                                 for k, s in want.items()}


if __name__ == "__main__":
    tssm.worker(sys.argv[1], sys.argv[2], mesh_cases)
