"""The port's evaluation, baselines and CLIs against the reference:
``core.evaluation``, ``core.baselines``, ``launch.train`` (``evaluate`` and
``main``) and ``launch.serve.main``, on the CPU.

Metrics, routing evaluations, oracle labels and the static and
decision-rule baselines are equal exactly (numpy on both sides).  The MLP
and hinge routers train from the same initial params (drawn by the
reference's own code and handed to the port's ``fit(init=...)``): equal
predictions, params within 1e-4 after 60 AdamW steps (float32 gradients
summed in other orders, compounded).  ``evaluate`` on the bridged
SFT-trained tiny estimator gives the reference's metrics exactly (greedy
token streams are equal).  ``serve.main`` with a reference checkpoint
prints the reference's JSON report, but for the stream's ``queue_age_ms``
(a wall-clock reading, compared by its keys) and ``compile_counts`` (XLA
executable builds, which the port has none of).
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.scope_estimator import TINY as JTINY
from repro.core import baselines as JB
from repro.core import evaluation as JE
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import model as JM
from repro.training import checkpoint as jckpt
from repro_torch import io
from repro_torch.configs.scope_estimator import TINY
from repro_torch.core import baselines as TB
from repro_torch.core import evaluation as TE
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain

PARAM_TOL = 1e-4


@pytest.fixture(scope="module")
def worlds():
    """(reference, port) ``build_world(200, 80, 0)``: world, data, library,
    retriever."""
    return (jtrain.build_world(200, 80, 0),
            ttrain.build_world(200, 80, 0, device="cpu"))


def test_estimator_configs_match_reference():
    for size in ("tiny", "100m", "qwen3-4b"):
        want, got = jtrain.estimator_config(size), ttrain.estimator_config(size)
        for field in ("name", "num_layers", "d_model", "num_heads",
                      "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                      "dtype", "qk_norm", "rope_theta"):
            assert getattr(got, field) == getattr(want, field), (size, field)
    with pytest.raises(ValueError):
        ttrain.estimator_config("huge")


def test_predictive_metrics_equal_reference():
    r = np.random.default_rng(0)
    y_hat, y_gt = r.integers(0, 2, 300), r.integers(0, 2, 300)
    len_hat, len_gt = r.integers(0, 3000, 300), r.integers(0, 3000, 300)
    doms = r.integers(0, 5, 300)
    for d in (None, doms):
        assert TE.predictive_metrics(y_hat, y_gt, len_hat, len_gt, d) == \
            JE.predictive_metrics(y_hat, y_gt, len_hat, len_gt, d)


def test_evaluate_choices_and_oracle_equal_reference(worlds):
    (_, jdata, _, _), (_, tdata, _, _) = worlds
    qids = [int(q) for q in jdata.test_qids[:40]]
    models = list(jdata.models)
    choices = np.random.default_rng(1).integers(0, len(models), len(qids))
    want = JE.evaluate_choices(jdata, qids, models, choices)
    got = TE.evaluate_choices(tdata, qids, models, choices)
    assert vars(got) == vars(want)
    np.testing.assert_array_equal(TB.oracle_labels(tdata, qids, models),
                                  JB.oracle_labels(jdata, qids, models))


def test_static_and_decision_rule_baselines_equal_reference(worlds):
    (jw, jdata, _, _), (tw, tdata, _, _) = worlds
    models = list(jdata.models)
    np.testing.assert_array_equal(TB.random_choices(50, 7, seed=3),
                                  JB.random_choices(50, 7, seed=3))
    for highest in (True, False):
        assert TB.price_rank_choice(tw, models, highest) == \
            JB.price_rank_choice(jw, models, highest)
    r = np.random.default_rng(2)
    p_hat, cost_hat = r.random((30, 7)), r.random((30, 7)) * 0.01
    for alpha in (0.0, 0.4, 1.0):
        np.testing.assert_array_equal(
            TB.chebyshev_choices(p_hat, cost_hat, alpha),
            JB.chebyshev_choices(p_hat, cost_hat, alpha))
    for budget in (0.0, 0.003, 1.0):
        np.testing.assert_array_equal(
            TB.highest_cost_choices(cost_hat, budget),
            JB.highest_cost_choices(cost_hat, budget))
    for q in jdata.test_qids[:10]:
        assert TB.tts_outcome(tdata, int(q), models) == \
            JB.tts_outcome(jdata, int(q), models)


def _router_data(data):
    qids = [int(q) for q in data.train_qids[:150]]
    embs = np.stack([data.queries[q].embedding for q in qids]).astype(
        np.float32)
    return embs, JB.oracle_labels(data, qids, list(data.models))


def test_knn_router_equals_reference(worlds):
    (_, jdata, _, _), _ = worlds
    embs, labels = _router_data(jdata)
    jr, tr = JB.KNNRouter(k=5), TB.KNNRouter(k=5)
    jr.fit(embs[:100], labels[:100], 7)
    tr.fit(embs[:100], labels[:100], 7)
    np.testing.assert_array_equal(tr.predict(embs[100:]),
                                  jr.predict(embs[100:]))


def _reference_init(kind, d, m, hidden, seed):
    """The initial params the reference's ``fit`` draws, as numpy."""
    key = jax.random.PRNGKey(seed)
    if kind == "mlp":
        k1, k2 = jax.random.split(key)
        return {"w1": np.asarray(jax.random.normal(k1, (d, hidden))
                                 * (1 / np.sqrt(d))),
                "b1": np.zeros((hidden,), np.float32),
                "w2": np.asarray(jax.random.normal(k2, (hidden, m))
                                 * (1 / np.sqrt(hidden))),
                "b2": np.zeros((m,), np.float32)}
    return {"w": np.asarray(jax.random.normal(key, (d, m)) * (1 / np.sqrt(d))),
            "b": np.zeros((m,), np.float32)}


@pytest.mark.parametrize("kind", ["mlp", "svm"])
def test_trained_routers_match_reference_from_the_same_init(worlds, kind):
    (_, jdata, _, _), _ = worlds
    embs, labels = _router_data(jdata)
    if kind == "mlp":
        jr = JB.MLPRouter(hidden=16, steps=60, seed=4)
        tr = TB.MLPRouter(hidden=16, steps=60, seed=4, device="cpu")
    else:
        jr = JB.LinearSVMRouter(steps=60, seed=4)
        tr = TB.LinearSVMRouter(steps=60, seed=4, device="cpu")
    jr.fit(embs[:100], labels[:100], 7)
    tr.fit(embs[:100], labels[:100], 7,
           init=_reference_init(kind, embs.shape[1], 7, 16, 4))
    assert set(tr.params) == set(jr.params)
    for k, want in jr.params.items():
        np.testing.assert_allclose(tr.params[k], want, rtol=0,
                                   atol=PARAM_TOL, err_msg=k)
    np.testing.assert_array_equal(tr.predict(embs[100:]),
                                  jr.predict(embs[100:]))
    # without init, the port draws its own seeded params: deterministic
    a = TB.LinearSVMRouter(steps=3, seed=1, device="cpu")
    b = TB.LinearSVMRouter(steps=3, seed=1, device="cpu")
    a.fit(embs, labels, 7)
    b.fit(embs, labels, 7)
    assert all(np.array_equal(a.params[k], b.params[k]) for k in a.params)
    with pytest.raises(ValueError, match="init"):
        TB.LinearSVMRouter(steps=1, device="cpu").fit(
            embs, labels, 7, init={"w": np.zeros((3, 7), np.float32),
                                   "b": np.zeros(7, np.float32)})


def test_evaluate_matches_reference_on_trained_tiny(tiny_trained):
    cfg, params, _ = tiny_trained
    tparams = io.params_from_numpy(jax.tree.map(np.asarray, params), TINY,
                                   device="cpu")
    # built afresh on both sides: evaluate draws from the world's generator
    jworld = jtrain.build_world(200, 80, 0)
    tworld = ttrain.build_world(200, 80, 0, device="cpu")
    want = jtrain.evaluate(cfg, params, *jworld[1:], n_eval=16)
    got = ttrain.evaluate(TINY, tparams, *tworld[1:], n_eval=16)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-12), k
    assert want["well_formed"] > 0


@pytest.fixture(scope="module")
def reference_checkpoint(tiny_trained, tmp_path_factory):
    _, params, _ = tiny_trained
    path = str(tmp_path_factory.mktemp("ck") / "tiny")
    jckpt.save(path, params)
    return path


def _report(capsys, main, argv):
    assert main(argv) == 0
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


@pytest.mark.parametrize("extra", [
    [], ["--stream-ticks", "2", "--refill", "--kv-paged"]],
    ids=["batch", "stream-refill-paged"])
def test_serve_main_prints_the_reference_report(reference_checkpoint, capsys,
                                                extra):
    argv = ["--checkpoint", reference_checkpoint, "--queries", "8", *extra]
    want = _report(capsys, jserve.main, argv)
    got = _report(capsys, tserve.main, ["--device", "cpu", *argv])
    if "scheduler" in want:
        for rep in (want, got):
            ages = rep["scheduler"].pop("queue_age_ms")
            assert set(ages) == {"p50", "p95", "max"}
        # XLA executable builds: the port compiles none
        assert "compile_counts" not in got["scheduler"]
        want["scheduler"].pop("compile_counts")
    assert got == want


def test_serve_mesh_needs_a_process_group(reference_checkpoint,
                                         monkeypatch):
    """``--mesh`` outside torchrun raises and names what is missing; the
    sharded serve itself is in ``test_torch_distributed.py``."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="no process group: RANK"):
        tserve.main(["--device", "cpu", "--checkpoint", reference_checkpoint,
                     "--mesh"])


def test_train_main_writes_a_checkpoint_the_reference_loads(tmp_path,
                                                            capsys):
    out = str(tmp_path / "port_tiny")
    assert ttrain.main(["--device", "cpu", "--queries", "120", "--anchors",
                        "60", "--sft-steps", "4", "--sft-examples", "200",
                        "--grpo-steps", "1", "--out", out]) == 0
    log = capsys.readouterr().out
    assert "SFT done" in log and "GRPO done" in log and "eval:" in log
    template = JM.init_params(jax.random.PRNGKey(0), JTINY)
    loaded = jckpt.load(out, template)
    with np.load(out + ".npz") as z:
        flat = io.flatten(loaded)
        assert sorted(z.files) == sorted(flat)
        for key, leaf in flat.items():
            np.testing.assert_array_equal(np.asarray(leaf), z[key])
    # the trained params differ from a fresh init: the steps were applied
    fresh = io.flatten(jax.tree.map(np.asarray, template))
    assert any(not np.array_equal(np.asarray(flat[k]), fresh[k])
               for k in flat)


def test_clis_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--sft-steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--queries", "1"])
