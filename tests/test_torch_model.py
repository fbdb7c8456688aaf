"""The port's dense backbone against the JAX model on bridged weights:
the weight bridge leaf for leaf, prefill logits, per-row decode steps, and
the checkpoint round trip."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.scope_estimator import TINY as JTINY
from repro.models import model as JM
from repro.serving import sampler as JS
from repro.training import checkpoint
from repro_torch import io
from repro_torch.configs.scope_estimator import TINY
from repro_torch.models import model as TM
from repro_torch.serving import sampler as TS

F32_TOL = 2e-5


@pytest.fixture(scope="module")
def bridged():
    params = JM.init_params(jax.random.PRNGKey(0), JTINY)
    tp = io.params_from_numpy(jax.tree.map(np.asarray, params), TINY, "cpu")
    return params, tp


def _flat(tree, prefix=""):
    """{path: leaf} over nested dicts / tuples, for leaf-for-leaf checks."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def test_bridge_is_leaf_for_leaf(bridged):
    params, tp = bridged
    jf, tf_ = _flat(params), _flat(tp)
    assert set(jf) == set(tf_)
    for path, leaf in jf.items():
        assert tuple(tf_[path].shape) == tuple(leaf.shape), path
        np.testing.assert_array_equal(_np(tf_[path]), _np(leaf), err_msg=path)


def test_init_params_matches_jax_structure_and_dtypes():
    """Seeded port init: the JAX tree's paths, shapes and dtypes (every
    rank >= 2 leaf in cfg.dtype, the final norm in f32)."""
    for jcfg, tcfg in ((JTINY, TINY),
                       (dataclasses.replace(JTINY, dtype="bfloat16"),
                        dataclasses.replace(TINY, dtype="bfloat16"))):
        jf = _flat(jax.eval_shape(lambda k, c=jcfg: JM.init_params(k, c),
                                  jax.random.PRNGKey(0)))
        tf_ = _flat(TM.init_params(tcfg, seed=0, device="cpu"))
        assert set(jf) == set(tf_)
        for path, leaf in jf.items():
            t = tf_[path]
            assert tuple(t.shape) == tuple(leaf.shape), path
            want = torch.bfloat16 if leaf.dtype == jnp.bfloat16 \
                else torch.float32
            assert t.dtype == want, path
    wq = TM.init_params(TINY, seed=1, device="cpu")["segments"][0]["0"][
        "attn"]["wq"]
    std = 1.0 / TINY.d_model ** 0.5
    assert abs(float(wq.std()) - 0.88 * std) < 0.1 * std   # truncated at 2 std
    assert float(wq.abs().max()) <= 2 * std + 1e-6
    again = TM.init_params(TINY, seed=1, device="cpu")["segments"][0]["0"][
        "attn"]["wq"]
    assert torch.equal(wq, again)


def test_prefill_logits_and_caches_match(bridged):
    params, tp = bridged
    toks = np.random.default_rng(0).integers(0, 512, (3, 17)).astype(np.int32)
    jl, jc = JM.prefill(params, JTINY, {"tokens": jnp.asarray(toks)})
    tl, tc = TM.prefill(tp, TINY, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL,
                               rtol=F32_TOL)
    for name in ("k", "v"):
        assert tuple(tc[0]["0"][name].shape) == (2, 3, 2, 17, 32)
        np.testing.assert_allclose(tc[0]["0"][name].numpy(),
                                   np.asarray(jc[0]["0"][name]), atol=F32_TOL,
                                   rtol=F32_TOL)


def test_three_decode_steps_with_per_row_positions(bridged):
    """Ragged rows: each decodes from its own length; logits at 2e-5."""
    params, tp = bridged
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, (3, 11)).astype(np.int32)
    lens = np.array([11, 6, 9], np.int32)
    steps = rng.integers(0, 512, (3, 3)).astype(np.int32)
    _, jc = JM.prefill(params, JTINY, {"tokens": jnp.asarray(toks)})
    jc = JS._pad_caches(jc, 16, 11)
    _, tc = TM.prefill(tp, TINY, {"tokens": torch.tensor(toks)})
    tc = TS._pad_caches(tc, 16, 11)
    for t in range(3):
        jl, jc = JM.decode_step(params, JTINY, jnp.asarray(steps[:, t:t + 1]),
                                jc, jnp.asarray(lens + t))
        tl, tc = TM.decode_step(tp, TINY, torch.tensor(steps[:, t:t + 1]),
                                tc, torch.tensor(lens + t))
        assert tuple(tl.shape) == (3, 1, 512)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL,
                                   rtol=F32_TOL)
    np.testing.assert_allclose(tc[0]["0"]["k"].numpy(),
                               np.asarray(jc[0]["0"]["k"]), atol=F32_TOL,
                               rtol=F32_TOL)


def test_decode_step_writes_only_each_rows_slot(bridged):
    _, tp = bridged
    caches = TM.init_cache(TINY, 2, 8, device="cpu")
    pos = torch.tensor([2, 5], dtype=torch.int32)
    TM.decode_step(tp, TINY, torch.tensor([[7], [9]]), caches, pos)
    k = caches[0]["0"]["k"]                     # (L, b, hkv, S, hd)
    written = k.abs().sum(dim=(0, 2, 4)) > 0    # (b, S)
    assert written.tolist() == [[s == 2 for s in range(8)],
                                [s == 5 for s in range(8)]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_checkpoint_round_trip(tmp_path, dtype):
    jcfg = dataclasses.replace(JTINY, dtype=dtype)
    tcfg = dataclasses.replace(TINY, dtype=dtype)
    params = JM.init_params(jax.random.PRNGKey(3), jcfg)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, params)
    tp = io.load_checkpoint(path, tcfg, device="cpu")
    jf, tf_ = _flat(params), _flat(tp)
    assert set(jf) == set(tf_)
    for p, leaf in jf.items():
        assert tf_[p].dtype == (torch.bfloat16 if leaf.dtype == jnp.bfloat16
                                else torch.float32), p
        np.testing.assert_array_equal(_np(tf_[p]), _np(leaf), err_msg=p)
    with pytest.raises(ValueError, match="embed"):
        io.load_checkpoint(path, dataclasses.replace(tcfg, d_model=64),
                           device="cpu")
