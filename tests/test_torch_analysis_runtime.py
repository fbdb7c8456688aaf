"""scopelint-torch's runtime pass (repro_torch.analysis.runtime_pass) on the
CPU: the five serve units run clean, the recorder flags a poisoned toy and
places syncs and host-value uploads against the window's first launch, a
failing unit and a stale plain-only entry are findings, and the dense
refill merges its rows without a host value mid-segment."""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.analysis import runtime_pass as rp
from repro_torch.analysis.selftest import clean, poisoned
from repro_torch.configs.scope_estimator import TINY
from repro_torch.models import model as M
from repro_torch.serving import sampler

CPU = torch.device("cpu")
UNITS = {"dense_segment": 1, "dense_refill_segment": 5, "paged_segment": 2,
         "paged_refill_segment": 6, "tier0_forward": 0}


@pytest.fixture(scope="module")
def reports():
    return {r.name: r for r in rp.run_runtime_pass(device="cpu")}


def test_registry_holds_the_five_units_with_their_syncs():
    units = rp.registered()
    assert {n: u.syncs for n, u in units.items()} == UNITS
    assert all(u.why for u in units.values())
    assert all(u.plain_only == {} for u in units.values())


@pytest.mark.parametrize("name", sorted(UNITS))
def test_runtime_pass_is_clean_on_the_cpu(reports, name):
    rep = reports[name]
    assert rep.device == "cpu" and rep.ops > 0
    assert rep.findings == [], [f.render() for f in rep.findings]
    # the window computes on its inputs: a first launch, no sync on the CPU
    assert rep.first_launch is not None
    assert rep.syncs_before == rep.syncs_after == 0


def test_runtime_pass_at_other_shapes():
    """Rows, prompt length, steps and pages of the caller's choosing."""
    reps = rp.run_runtime_pass(device="cpu", rows=3, prompt_len=11, steps=2,
                               page_size=8)
    assert [r.findings for r in reps] == [[]] * 5


def test_poisoned_toy_is_flagged_and_clean_is_not():
    x = torch.arange(4, dtype=torch.float32)
    msgs = [f.message for f in rp.check_window("p", lambda: poisoned(x), CPU)]
    assert any("aten::_local_scalar_dense" in m for m in msgs)
    assert any("torch.float64 output" in m for m in msgs)
    assert rp.check_window("c", lambda: clean(x), CPU) == []


def test_syncs_are_placed_against_the_first_launch():
    x = torch.ones(3)

    def window():
        warnings.warn(rp.SYNC_WARNING)      # before: the stream is empty
        y = x * 2                           # the first launch reads x
        warnings.warn(rp.SYNC_WARNING)      # after it: a real wait
        return y + 1

    _, rec, _ = rp.record(window, CPU, (x,))
    assert rec.first_launch == 0
    assert [(op, during) for op, during, _ in rec.syncs] == \
        [(0, False), (1, False)]
    assert [s[0] for s in rec.after_launch(rec.syncs)] == [1]
    assert rec.syncs[1][2].startswith("test_torch_analysis_runtime.py:")


def test_host_value_lifted_after_the_first_launch_is_flagged():
    x = torch.zeros(2, 4)
    rows = torch.tensor([0, 1])

    def window():
        ids = torch.as_tensor((1, 0))       # an upload before the launch
        y = x[:, :2] + 1                    # the first launch
        y[rows, 1:] = 0                     # a host 0 after it
        return y, ids

    _, rec, _ = rp.record(window, CPU, (x,))
    late = rec.after_launch(rec.lifts)
    assert len(rec.lifts) == 2 and len(late) == 1
    assert late[0][1].startswith("test_torch_analysis_runtime.py:")


def test_a_unit_that_raises_is_a_finding(monkeypatch):
    def build(s):
        def call(state):
            raise RuntimeError("no kernel for this shape")
        return (lambda: None), call
    monkeypatch.setitem(rp._REGISTRY, "boom", rp.Unit(build, 0, "", {}))
    (rep,) = rp.run_runtime_pass(device="cpu", only=["boom"])
    assert [f.message for f in rep.findings] == [
        "serve segment failed to run: RuntimeError('no kernel for this "
        "shape')"]
    assert rep.findings[0].path == "<runtime:boom>"


@pytest.mark.parametrize("stale", [False, True])
def test_plain_only_entries_suppress_and_cannot_go_stale(monkeypatch, stale):
    """A CPU finding of a plain version alone is listed with its reason and
    reported as suppressed; an entry that matches nothing is a finding."""
    x = torch.arange(3.0)

    def build(s):
        return (lambda: x), (lambda t: t * 2 if stale else t.sum().item())
    msg = "host read of a device value: aten::_local_scalar_dense at " \
        "test_torch_analysis_runtime.py:" + \
        str(build.__code__.co_firstlineno + 1)
    monkeypatch.setitem(rp._REGISTRY, "plain", rp.Unit(
        build, 0, "", {msg: "the plain version reads it on the host"}))
    (rep,) = rp.run_runtime_pass(device="cpu", only=["plain"])
    if stale:
        assert [f.suppressed for f in rep.findings] == [False]
        assert "matched no finding" in rep.findings[0].message
    else:
        assert [(f.suppressed, f.suppress_reason) for f in rep.findings] == \
            [(True, "the plain version reads it on the host")]


# ---------------------------------------------------------------------------
# The fault the pass found: the dense refill's merge wrote a host 0
# ---------------------------------------------------------------------------
def _merge_rows_with_a_host_zero(caches, new_caches, rows, src):
    """``sampler._merge_rows`` as it was: the rows past the prompt zeroed
    with a Python 0, a host value each indexed store copies to the card."""
    for (name, old), (_, new) in zip(sampler._leaves(caches),
                                     sampler._leaves(new_caches),
                                     strict=True):
        ax = sampler.CACHE_SEQ_AXIS.get(name)
        if ax is None:
            old[:, rows] = new[:, src].to(old.dtype)
            continue
        width = new.shape[ax]
        lead = (slice(None), rows) + (slice(None),) * (ax - 2)
        old[lead + (slice(None, width),)] = new[:, src].to(old.dtype)
        old[lead + (slice(width, None),)] = 0


def test_dense_refill_uploads_nothing_after_its_first_launch(monkeypatch):
    (rep,) = rp.run_runtime_pass(device="cpu", only=["dense_refill_segment"])
    assert rep.findings == []
    monkeypatch.setattr(sampler, "_merge_rows", _merge_rows_with_a_host_zero)
    (rep,) = rp.run_runtime_pass(device="cpu", only=["dense_refill_segment"])
    msgs = [f.message for f in rep.findings]
    assert len(msgs) == 2       # the k and the v leaf
    assert all("host value made a tensor after the window's first launch"
               in m and "test_torch_analysis_runtime.py" in m for m in msgs)


def test_merge_rows_is_unchanged_by_the_repair():
    params = M.init_params(TINY, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(16, TINY.vocab_size, (4, 9), dtype=np.int32)
    caches = [sampler.prefill_state(params, TINY, prompts,
                                    max_new_tokens=5).caches
              for _ in range(2)]
    new = M.prefill(params, TINY, {"tokens": torch.as_tensor(
        prompts[:2, :6])})[1]
    rows = torch.tensor([3, 1])
    src = torch.tensor([0, 1])
    sampler._merge_rows(caches[0], new, rows, src)
    _merge_rows_with_a_host_zero(caches[1], new, rows, src)
    for (_, a), (_, b) in zip(sampler._leaves(caches[0]),
                              sampler._leaves(caches[1]), strict=True):
        assert torch.equal(a, b)
