"""The twins of the scripts under ``examples/``
(``repro_torch.examples``) against the reference's scripts: each run with
its SFT replaced by the shared SFT-trained tiny estimator (the
``tiny_trained`` fixture, bridged for the twin), every ``serve`` report
recorded on both sides.  Tolerances: p_hat within 2e-5, decisions, cache
counts and costs equal, the printed lines equal (alpha values masked).
"""
import importlib
import re

import jax
import numpy as np
import pytest

from repro import api as japi
from repro_torch import api as tapi
from repro_torch import io
from repro_torch.configs import get_config

F32_TOL = 2e-5


# ---------------------------------------------------------------------------
# the examples' twins
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trained_tiny_pair(tiny_trained):
    """The shared SFT-trained tiny estimator, as the reference's params and
    bridged to the port's."""
    cfg, params, _ = tiny_trained
    return params, io.params_from_numpy(jax.tree.map(np.asarray, params),
                                        get_config(cfg.name), "cpu")


def _record_serves(monkeypatch, engine_cls):
    """Every ``engine_cls.serve`` call's report, in order."""
    served = []
    serve = engine_cls.serve

    def recording(self, *args, **kwargs):
        served.append(serve(self, *args, **kwargs))
        return served[-1]

    monkeypatch.setattr(engine_cls, "serve", recording)
    return served


def _serve_lines(out):
    """Printed lines with their alpha values masked: a budget alpha is
    printed to three places and held by the test instead."""
    return [re.sub(r"alpha(\*?)=[0-9.]+", r"alpha\1=", ln)
            for ln in out.splitlines()]


@pytest.mark.parametrize("name", ["quickstart", "budget_control",
                                  "serve_router"])
def test_example_twin_decisions_and_cache_counts_equal_reference(
        name, trained_tiny_pair, monkeypatch, capsys):
    """The reference script and the port's twin, each with its SFT replaced
    by the shared trained tiny weights: every serve's decisions, cache
    counts and costs equal, p_hat within 2e-5, the printed lines equal
    (serve_router's cache asserts hold on both sides)."""
    jparams, tparams = trained_tiny_pair
    runs = []
    for module, engine_cls, params, argv in (
            (f"examples.{name}", japi.ScopeEngine, jparams, ()),
            (f"repro_torch.examples.{name}", tapi.ScopeEngine, tparams,
             (["--device", "cpu"],))):
        script = importlib.import_module(module)
        monkeypatch.setattr(script, "train_sft",
                            lambda *a, trained=params, **k: (trained, [0.0]))
        served = _record_serves(monkeypatch, engine_cls)
        script.main(*argv)
        runs.append((served, capsys.readouterr().out))
    (want, ref_out), (got, twin_out) = runs
    assert len(got) == len(want) > 1
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert [d.model for d in g.decisions] == \
            [d.model for d in w.decisions], i
        np.testing.assert_allclose([d.p_hat for d in g.decisions],
                                   [d.p_hat for d in w.decisions],
                                   atol=F32_TOL)
        assert (g.cache_hits, g.cache_misses) == (w.cache_hits,
                                                  w.cache_misses), i
        assert g.total_cost == pytest.approx(w.total_cost, rel=1e-9)
        assert g.info.get("expected_cost") == pytest.approx(
            w.info.get("expected_cost"), rel=1e-9)
        # a budget alpha is a crossing point of two p_hat-affine utility
        # lines, (s_j - s_i) / ((p - s)_i - (p - s)_j): p_hat's float32
        # differences (2e-5) move it by 2e-5 over that slope gap (here
        # ~0.02), while the decisions above stay equal
        assert (g.alpha is None) == (w.alpha is None)
        if g.alpha is not None:
            assert g.alpha == pytest.approx(w.alpha, abs=5e-3)
    assert _serve_lines(twin_out) == _serve_lines(ref_out)


def test_example_twin_trains_from_its_seeded_init(monkeypatch, capsys):
    """The twin trains the seeded tiny init as the script does (here two
    steps on 200 of its 2500 examples) and serves."""
    from repro_torch.examples import quickstart
    train, build = quickstart.train_sft, quickstart.build_sft_dataset
    monkeypatch.setattr(quickstart, "train_sft",
                        lambda p, c, ds, steps, batch_size:
                        train(p, c, ds, steps=2, batch_size=batch_size))
    monkeypatch.setattr(quickstart, "build_sft_dataset",
                        lambda *a, max_examples: build(*a, max_examples=200))
    served = _record_serves(monkeypatch, tapi.ScopeEngine)
    quickstart.main(["--device", "cpu"])
    assert "SFT loss" in capsys.readouterr().out and len(served) == 2
    assert all(len(r.decisions) == 8 for r in served)


def test_train_estimator_twin_is_the_ported_launcher():
    """The twin runs ``repro_torch.launch.train.main`` itself, which
    ``tests/test_torch_launch.py`` holds to the reference's launcher."""
    from repro_torch.examples import train_estimator
    from repro_torch.launch import train as ttrain
    assert train_estimator.main is ttrain.main
    with pytest.raises(SystemExit) as done:
        train_estimator.main(["--help"])
    assert done.value.code == 0
