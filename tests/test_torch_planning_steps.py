"""The planning path's step factories against the reference's
(``repro.launch.specs``), at reduced configs on the same seeded weights
(``io.params_from_numpy``): the train step over 1 and 2 microbatches (its
loss, every parameter leaf after the AdamW update, and both moments, which
carry the gradients), the prefill step over 2 microbatches, and the serve
step's logits and caches at ``capacity - 1``.

Tolerances, ROADMAP's: float32 values within 2e-5; the AdamW moments, as
gradients, within 1e-4 of each leaf's largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import InputShape as JShape
from repro.launch import specs as JS
from repro.models import model as JM
from repro.training import optimizer as JOpt
from repro_torch import io
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import specs as S
from repro_torch.training import optimizer as TOpt

F32_TOL = 2e-5
GRAD_TOL = 1e-4
# (config, sequence length): the long variant of gemma2 at a sequence past
# its 64-token window (its decode cache a 64-slot ring); mamba2 as the
# pure SSM stack it is at full width
CASES = {"starcoder2-3b": 24, "gemma2-2b@long": 80, "mamba2-1.3b": 32,
         "zamba2-7b": 32, "qwen2-vl-7b": 24, "whisper-medium": 24,
         "qwen3-moe-235b-a22b": 24, "deepseek-v2-lite-16b": 24}
ROWS = 2


def _configs(case):
    name, _, variant = case.partition("@")
    jcfg, tcfg = jget_config(name).reduced(), get_config(name).reduced()
    if name == "mamba2-1.3b":
        jcfg = dataclasses.replace(jcfg, shared_attn_every=0)
        tcfg = dataclasses.replace(tcfg, shared_attn_every=0)
    if variant == "long":
        jcfg = JS.resolved_config(jcfg, JShape("long_500k", 1, 1, "decode"))
        tcfg = S.resolved_config(tcfg, InputShape("long_500k", 1, 1,
                                                  "decode"))
    return jcfg, tcfg


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    jcfg, tcfg = _configs(request.param)
    params = JM.init_params(jax.random.PRNGKey(3), jcfg)
    return request.param, jcfg, tcfg, params


def _tparams(params, tcfg):
    return io.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")


def _batch(tcfg, s, seed, labels=True):
    """Tokens (and labels, 30 % ignored) with the config's stub inputs,
    as CPU tensors, and as the reference takes them."""
    r = np.random.default_rng(seed)
    cols = {"tokens": r.integers(0, tcfg.vocab_size, (ROWS, s))}
    if labels:
        cols["labels"] = np.where(r.random((ROWS, s)) < 0.3, -100,
                                  r.integers(0, tcfg.vocab_size, (ROWS, s)))
    batch = tpipe.with_stubs(tpipe.to_tensors(
        {k: v.astype(np.int32) for k, v in cols.items()}, "cpu"), tcfg,
        seed=seed + 1)
    jbatch = {k: jnp.asarray(v.numpy().astype(np.int32)
                             if v.dtype == torch.int64 else v.numpy())
              for k, v in batch.items()}
    return batch, jbatch


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("m", [1, 2])
def test_train_step_matches_reference(pair, m):
    case, jcfg, tcfg, params = pair
    batch, jbatch = _batch(tcfg, CASES[case], seed=5)
    jp, jopt, jloss = jax.jit(JS.make_train_step(jcfg, microbatches=m))(
        params, JOpt.adamw_init(params), jbatch)
    tp = _tparams(params, tcfg)
    tp, topt, tloss = S.make_train_step(tcfg, microbatches=m)(
        tp, TOpt.adamw_init(tp), batch)
    assert float(tloss) == pytest.approx(float(jloss), abs=F32_TOL)
    assert topt.step == int(jopt.step) == 1
    for got, want, tol in ((tp, jp, None), (topt.mu, jopt.mu, GRAD_TOL),
                           (topt.nu, jopt.nu, GRAD_TOL)):
        gflat, wflat = io.flatten(got), io.flatten(want)
        assert list(gflat) == list(wflat)
        for key, w in wflat.items():
            w = np.asarray(w, np.float32)
            atol = F32_TOL if tol is None else tol * max(
                float(np.abs(w).max()), 1e-30)
            _close(gflat[key], w, atol, key)


def test_prefill_step_matches_reference_over_two_microbatches(pair):
    case, jcfg, tcfg, params = pair
    batch, jbatch = _batch(tcfg, CASES[case], seed=6, labels=False)
    want = jax.jit(JS.make_prefill_step(jcfg, microbatches=2))(params,
                                                               jbatch)
    got = S.make_prefill_step(tcfg, microbatches=2)(_tparams(params, tcfg),
                                                    batch)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, F32_TOL, "logits")


def test_serve_step_matches_reference_at_the_last_slot(pair):
    """One token against caches of ``seq_len`` seeded slots: the logits
    and every cache leaf after the step, the new slot at
    ``_cache_capacity - 1`` (63 of gemma2's 64-slot ring, 0 for mamba2)."""
    case, jcfg, tcfg, params = pair
    s = CASES[case]
    shape = InputShape("decode", s, ROWS, "decode")
    data = S.materialize(tcfg, S.input_specs(tcfg, shape), rows=ROWS,
                         seed=7, device="cpu")
    # copies, and the reference's step done before the port's: the port
    # writes its caches in place, and a zero-copy array would share them
    caches = io.tree_map(lambda t: jnp.asarray(t.numpy().copy()),
                         data["caches"])
    token = jnp.asarray(data["token"].numpy().copy())
    jlogits, jcaches = jax.block_until_ready(jax.jit(
        JS.make_serve_step(jcfg))(params, token, caches))
    cap = S._cache_capacity(data["caches"])
    assert cap == JS._cache_capacity(caches) == (
        64 if case.endswith("@long") else 1 if case == "mamba2-1.3b" else s)
    tlogits, tcaches = S.make_serve_step(tcfg)(_tparams(params, tcfg),
                                               data["token"], data["caches"])
    _close(tlogits, jlogits, F32_TOL, "logits")
    gflat, wflat = io.flatten(tcaches), io.flatten(jcaches)
    assert list(gflat) == list(wflat)
    for key, w in wflat.items():
        _close(gflat[key], w, F32_TOL, key)
