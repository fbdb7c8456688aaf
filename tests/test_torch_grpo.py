"""The port's GRPO stage against the reference on scope-tiny, from the
bridged weights of the SFT-trained tiny estimator.

Tolerances: sequence log-probs within 2e-5; ``grpo_loss`` and
``grpo_step`` on a batch the reference's own trainer built (its second
rollout, where the policy has moved off the reference policy): loss, pg
and kl within 2e-5 and the updated params within 2e-5.  A greedy
``rollout_step`` gives the reference's tokens, mask, rewards and
advantages exactly and its loss within 2e-5.  Sampled rollouts cannot
match JAX's random bits: at temperature 1 a rollout is held to its
contract (shapes, mask, group-normalized advantages, rewards in range,
the same generator seed giving the same rollout), and refused without a
generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.scope_estimator import TINY as JTINY
from repro.core.fingerprint import FingerprintLibrary as JLibrary
from repro.core.fingerprint import build_anchor_set as jbuild_anchor_set
from repro.core.retrieval import AnchorRetriever as JRetriever
from repro.data.datasets import build_scope_data as jbuild_scope_data
from repro.data.datasets import stratified_anchors as jstratified
from repro.data.worldsim import World as JWorld
from repro.training import grpo as JG
from repro.training import optimizer as JOpt
from repro_torch import io
from repro_torch.configs.scope_estimator import TINY
from repro_torch.core.fingerprint import FingerprintLibrary, build_anchor_set
from repro_torch.core.retrieval import AnchorRetriever
from repro_torch.data import tokenizer as tok
from repro_torch.data.datasets import build_scope_data, stratified_anchors
from repro_torch.data.pipeline import to_tensors
from repro_torch.data.worldsim import World
from repro_torch.training import grpo as TG
from repro_torch.training import optimizer as TOpt

F32_TOL = 2e-5
GCFG = dict(group_size=2, tasks_per_step=4, max_new_tokens=8)


def _bridge(params):
    return io.params_from_numpy(jax.tree.map(np.asarray, params), TINY,
                                device="cpu")


def _trainers(jparams, tparams, *, temperature, generator=None, seed=0):
    """A reference and a port trainer, each on a world of its own built
    afresh (``World.embed`` draws from the world's generator)."""
    jw, tw = JWorld(seed=0), World(seed=0)
    jdata = jbuild_scope_data(jw, n_queries=200, seed=0)
    tdata = build_scope_data(tw, n_queries=200, seed=0)
    janch = jbuild_anchor_set(jw, jstratified(jw, n=80, seed=7))
    tanch = build_anchor_set(tw, stratified_anchors(tw, n=80, seed=7))
    jlib, tlib = JLibrary(janch), FingerprintLibrary(tanch)
    for m in jw.pool:
        if m.seen:
            jlib.onboard(jw, m.name, seed=3)
            tlib.onboard(tw, m.name, seed=3)
    jt = JG.GRPOTrainer(JTINY, jparams, jdata, jlib, JRetriever(janch),
                        gcfg=JG.GRPOConfig(temperature=temperature, **GCFG),
                        seed=seed)
    tt = TG.GRPOTrainer(TINY, tparams, tdata, tlib,
                        AnchorRetriever(tanch, device="cpu"),
                        gcfg=TG.GRPOConfig(temperature=temperature, **GCFG),
                        seed=seed, generator=generator)
    return jt, tt


@pytest.fixture(scope="module")
def trained(tiny_trained):
    cfg, params, _ = tiny_trained
    assert cfg == JTINY
    return params


class _Capture:
    """Records each ``grpo_step`` call's batch and loss in ``module``."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        inner = module.grpo_step

        def step(params, cfg, opt_state, batch, *args):
            out = inner(params, cfg, opt_state, batch, *args)
            self.calls.append({"params": params, "batch": batch,
                               "loss": float(out[2]),
                               "metrics": {k: float(v)
                                           for k, v in out[3].items()}})
            return out

        monkeypatch.setattr(module, "grpo_step", step)


@pytest.fixture(scope="module")
def reference_batch(trained):
    """The reference trainer's second sampled rollout: its batch, the
    params it was taken at, and its reference params."""
    jt, _ = _trainers(trained, _bridge(trained), temperature=1.0,
                      generator=torch.Generator().manual_seed(0))
    mp = pytest.MonkeyPatch()
    try:
        cap = _Capture(mp, JG)
        jt.rollout_step()
        jt.rollout_step()
    finally:
        mp.undo()
    call = cap.calls[1]
    batch = {k: np.asarray(v) for k, v in call["batch"].items()}
    return (jax.tree.map(np.asarray, call["params"]),
            jax.tree.map(np.asarray, jt.ref_params), batch)


def _port_batch(batch):
    return to_tensors(batch, "cpu")


def test_sequence_logprobs_match_reference(reference_batch):
    params, _, batch = reference_batch
    jlp, jmask = JG.sequence_logprobs(params, JTINY,
                                      jnp.asarray(batch["tokens"]),
                                      jnp.asarray(batch["gen_mask"]))
    tb = _port_batch(batch)
    with torch.no_grad():
        lp, mask = TG.sequence_logprobs(_bridge(params), TINY, tb["tokens"],
                                        tb["gen_mask"])
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=0,
                               atol=F32_TOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_grpo_loss_and_step_match_reference(reference_batch):
    params, _, batch = reference_batch
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    assert np.abs(batch["adv"]).max() > 0       # a non-trivial batch
    jloss, jm = JG.grpo_loss(params, JTINY, jb, 0.2, 0.02)
    tloss, tm = TG.grpo_loss(_bridge(params), TINY, _port_batch(batch), 0.2,
                             0.02)
    assert float(tloss) == pytest.approx(float(jloss), abs=F32_TOL)
    for k in ("pg", "kl"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), abs=F32_TOL)
    assert float(jm["kl"]) > 0                  # the policy has moved
    cfg = JOpt.AdamWConfig(lr=2e-4, warmup_steps=10, total_steps=1000)
    jp, _, jl2, _ = JG.grpo_step(params, JTINY, JOpt.adamw_init(params),
                                 jb, cfg, 0.2, 0.02)
    tparams = _bridge(params)
    tp, ts, tl2, _ = TG.grpo_step(tparams, TINY, TOpt.adamw_init(tparams),
                                  _port_batch(batch),
                                  TOpt.AdamWConfig(**vars(cfg)), 0.2, 0.02)
    assert float(tl2) == pytest.approx(float(jl2), abs=F32_TOL)
    assert ts.step == 1
    for (key, want), got in zip(io.flatten(jp).items(),
                                io.flatten(tp).values(), strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=F32_TOL, err_msg=key)


def test_greedy_rollout_step_matches_reference(trained, monkeypatch):
    jt, tt = _trainers(trained, _bridge(trained), temperature=0.0)
    jcap, tcap = _Capture(monkeypatch, JG), _Capture(monkeypatch, TG)
    jinfo, tinfo = jt.rollout_step(), tt.rollout_step()
    jb, tb = jcap.calls[0]["batch"], tcap.calls[0]["batch"]
    np.testing.assert_array_equal(tb["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
    np.testing.assert_array_equal(tb["gen_mask"].numpy(),
                                  np.asarray(jb["gen_mask"]))
    np.testing.assert_array_equal(tb["adv"].numpy(), np.asarray(jb["adv"]))
    np.testing.assert_allclose(tb["old_logp"].numpy(),
                               np.asarray(jb["old_logp"]), rtol=0,
                               atol=F32_TOL)
    assert tt.reward_history == jt.reward_history
    assert tinfo["format_rate"] == jinfo["format_rate"]
    assert tinfo["loss"] == pytest.approx(jinfo["loss"], abs=F32_TOL)
    assert tinfo["kl"] == pytest.approx(jinfo["kl"], abs=F32_TOL)
    # the trained estimator's greedy rollouts parse: rewards are not all 0
    assert jt.reward_history[0] > 0


def test_sampled_rollout_step_contract(trained, monkeypatch):
    """Temperature 1: one rollout of the sampled policy, the same generator
    seed giving the same rollout, and each group's advantages normalized."""
    runs = []
    for seed in (0, 0, 1):
        _, tt = _trainers(trained, _bridge(trained), temperature=1.0,
                          generator=torch.Generator().manual_seed(seed))
        cap = _Capture(monkeypatch, TG)
        info = tt.rollout_step()
        monkeypatch.undo()
        runs.append((info, cap.calls[0]["batch"], tt))
    (info, batch, tt), (_, again, _), (_, other, _) = runs
    g, n = GCFG["group_size"], GCFG["tasks_per_step"]
    tokens, mask, adv = batch["tokens"], batch["gen_mask"], batch["adv"]
    assert torch.equal(tokens, again["tokens"])
    assert not torch.equal(tokens, other["tokens"])
    B, L = tokens.shape
    lp_len = L - GCFG["max_new_tokens"]
    assert B == g * n
    assert torch.equal(tokens[::g, :lp_len], tokens[1::g, :lp_len])
    for i in range(B):
        gen = tokens[i, lp_len:].tolist()
        upto = gen.index(tok.EOS) + 1 if tok.EOS in gen else len(gen)
        want = torch.zeros(L)
        want[lp_len:lp_len + upto] = 1.0
        assert torch.equal(mask[i], want)
    group_mean = adv.reshape(-1, g).mean(dim=1)
    assert float(group_mean.abs().max()) < 1e-5
    assert 0.0 <= info["reward"] <= 2.0
    assert 0.0 <= info["format_rate"] <= 1.0
    assert np.isfinite([info["loss"], info["kl"]]).all()
    assert tt.reward_history == [info["reward"]]


def test_sampled_rollout_needs_a_generator(trained):
    _, tt = _trainers(trained, _bridge(trained), temperature=1.0)
    with pytest.raises(ValueError, match="Generator"):
        tt.rollout_step()


def test_trainer_keeps_a_reference_copy_and_trains_in_place(trained):
    tparams = _bridge(trained)
    _, tt = _trainers(trained, tparams, temperature=0.0)
    ref = io.flatten(tt.ref_params)
    before = {k: v.clone() for k, v in io.flatten(tparams).items()}
    tt.rollout_step()
    assert tt.params is tparams
    for key, t in io.flatten(tparams).items():
        assert torch.equal(ref[key], before[key]), key
        assert ref[key].data_ptr() != t.data_ptr()
    assert any(not torch.equal(t, before[k])
               for k, t in io.flatten(tparams).items())
