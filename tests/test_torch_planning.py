"""The planning path against the reference: the four input shapes, which
(arch, shape) pairs run and why not, the long-context variant, the input
and cache specs and the parameter counts at full width (meta tensors
against ``jax.eval_shape``'s structs: neither allocates), the serve step's
position, the dry-run's rows and entry point, and the flash kernels' grid
limit at long shapes.  The step factories are held in
``test_torch_planning_steps.py``, the FLOP count in
``test_torch_planning_flops.py``.

Only ``repro.launch.specs`` is imported of the reference's launchers:
``repro.launch.dryrun`` forces 512 host devices when it is imported.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs import base as JB
from repro.launch import specs as JS
from repro_torch import io
from repro_torch import configs as TC
from repro_torch.configs import base as TB
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S

ROOT = Path(__file__).resolve().parents[1]
PAIRS = [(a, s) for a in JC.ASSIGNED_ARCHS for s in JB.INPUT_SHAPES]
RUNS = [(a, s) for a, s in PAIRS
        if JB.shape_applicable(JC.get_config(a), JB.INPUT_SHAPES[s])[0]]
# the fields of the reference's dry-run rows this port keeps, and those a
# reader of the rows (benchmarks/bench_roofline.py) needs
ROW_FIELDS = {"arch", "shape", "mesh", "mode", "status", "microbatches",
              "num_params", "hlo_flops_per_device",
              "hlo_hbm_bytes_per_device", "collectives", "memory_analysis",
              "roofline", "num_devices"}


def _struct(tree):
    """{flat key: (shape, dtype name)} of a tree of meta tensors or
    ``ShapeDtypeStruct``s."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in io.flatten(tree).items()}


def test_registry_and_input_shapes_equal_reference():
    assert TC.ASSIGNED_ARCHS == JC.ASSIGNED_ARCHS
    assert sorted(TC.list_configs()) == sorted(JC.list_configs())
    assert set(TC.__all__) == set(JC.__all__)
    assert list(TB.INPUT_SHAPES) == list(JB.INPUT_SHAPES)
    for name, shape in JB.INPUT_SHAPES.items():
        assert dataclasses.asdict(TB.INPUT_SHAPES[name]) == \
            dataclasses.asdict(shape)


@pytest.mark.parametrize("arch", JC.ASSIGNED_ARCHS)
def test_shape_applicable_and_long_variant_equal_reference(arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    for name, shape in JB.INPUT_SHAPES.items():
        assert TB.shape_applicable(tcfg, TB.INPUT_SHAPES[name]) == \
            JB.shape_applicable(jcfg, shape)
    jl, tl = JB.long_context_variant(jcfg), TB.long_context_variant(tcfg)
    for f in dataclasses.fields(tl):
        assert getattr(tl, f.name) == getattr(jl, f.name), f.name
    assert tl.force_window == tcfg.long_context_window
    for name, shape in JB.INPUT_SHAPES.items():
        assert S.resolved_config(tcfg, TB.INPUT_SHAPES[name]) == (
            tl if name == "long_500k" else tcfg)


def test_six_pairs_skip_with_the_reference_reason():
    skipped = [(a, s) for a, s in PAIRS if (a, s) not in RUNS]
    assert len(RUNS) == 34 and len(skipped) == 6
    assert {s for _, s in skipped} == {"long_500k"}


@pytest.mark.parametrize("arch,shape", RUNS, ids=[f"{a}-{s}" for a, s in RUNS])
def test_input_and_cache_specs_equal_reference_at_full_width(arch, shape):
    """Keys, shapes and dtypes of every input, and of every decode cache
    leaf, at the shape's full batch and length, on the resolved config."""
    jshape, tshape = JB.INPUT_SHAPES[shape], TB.INPUT_SHAPES[shape]
    jcfg = JS.resolved_config(JC.get_config(arch), jshape)
    tcfg = S.resolved_config(TC.get_config(arch), tshape)
    want, got = JS.input_specs(jcfg, jshape), S.input_specs(tcfg, tshape)
    assert list(got) == list(want)
    assert _struct(got) == _struct(want)
    assert all(t.device.type == "meta" for t in io.flatten(got).values())


@pytest.mark.parametrize("arch", sorted(JC.list_configs()))
def test_num_params_and_leaves_equal_reference(arch):
    """Every param leaf's shape and dtype, and so the count, for all
    twelve configs at full width, from ``init_params``' own code on the
    meta device."""
    want = _struct(JS.abstract_params(JC.get_config(arch)))
    params = S.abstract_params(TC.get_config(arch))
    assert _struct(params) == want
    assert S.num_params(params) == sum(int(np.prod(s)) for s, _ in
                                       want.values())
    opt = S.abstract_opt_state(params)
    assert {k: s for k, (s, _) in _struct(opt.mu).items()} == \
        {k: s for k, (s, _) in want.items()}
    assert {dt for _, dt in _struct(opt.nu).values()} == {"float32"}


@pytest.mark.parametrize("arch", ["gemma2-2b", "zamba2-7b",
                                  "deepseek-v2-lite-16b", "whisper-medium"])
def test_meta_params_are_init_params_shapes(arch):
    """The meta params cannot drift from ``init_params``: at a reduced
    config both give the same leaves, shapes and dtypes."""
    cfg = TC.get_config(arch).reduced()
    real = S.M.init_params(cfg, seed=0, device="cpu")
    assert _struct(S.abstract_params(cfg)) == _struct(real)


def test_serve_step_position_copies_the_reference():
    """``_cache_capacity``: a windowed ring's slots (long_500k decodes at
    4095, not 524287), 1 for a cache with no K/V or latent leaf (mamba2
    decodes at 0), the latent's slots for MLA; the reference's value in
    each case."""
    long, dec = TB.INPUT_SHAPES["long_500k"], TB.INPUT_SHAPES["decode_32k"]
    cases = {("gemma2-9b", "long_500k"): 4096,
             ("zamba2-7b", "long_500k"): 4096,
             ("mamba2-1.3b", "long_500k"): 1,
             ("mamba2-1.3b", "decode_32k"): 1,
             ("deepseek-v2-lite-16b", "decode_32k"): 32768,
             ("whisper-medium", "decode_32k"): 32768}
    for (arch, shape), cap in cases.items():
        tshape = long if shape == "long_500k" else dec
        tcfg = S.resolved_config(TC.get_config(arch), tshape)
        jcfg = JS.resolved_config(JC.get_config(arch),
                                  JB.INPUT_SHAPES[shape])
        got = S._cache_capacity(S.input_specs(tcfg, tshape)["caches"])
        want = JS._cache_capacity(JS.input_specs(
            jcfg, JB.INPUT_SHAPES[shape])["caches"])
        assert got == want == cap, (arch, shape)


def test_plan_all_pairs_with_the_reference_fields(tmp_path, capsys):
    """``main --all`` plans 40 pairs on the host, 34 ok and 6 skipped with
    the reference's reason, in rows a reader of the reference's rows can
    read; nothing is allocated."""
    out = tmp_path / "plan.json"
    assert D.main(["--all", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [(r["arch"], r["shape"]) for r in rows] == PAIRS
    for r in rows:
        ok, reason = JB.shape_applicable(JC.get_config(r["arch"]),
                                         JB.INPUT_SHAPES[r["shape"]])
        if not ok:
            assert r["status"] == "skipped" and r["reason"] == reason
            continue
        assert r["status"] == "ok" and ROW_FIELDS <= set(r)
        assert r["num_devices"] == 1 and r["mesh"] == "1"
        assert 1 <= r["microbatches"] <= 16
        t = r["roofline"]
        assert t["collective_s"] == 0 and t["bottleneck"] in (
            "compute_s", "memory_s")
        assert r["collectives"]["total_bytes"] == 0
        assert r["hlo_flops_per_device"] > 0 and \
            r["hlo_hbm_bytes_per_device"] > 0
        if r["mode"] == "decode":
            assert r["microbatches"] == 1
    assert "40 combos, 34 ok, 6 skipped, 0 failed" in capsys.readouterr().out


def test_main_runs_a_reduced_step_on_the_cpu(tmp_path):
    """``--run --device cpu --reduced``: the plan and one measured step of
    the reduced config at the shape's own length, with its cut."""
    out = tmp_path / "run.json"
    assert D.main(["--arch", "whisper-medium", "--shape", "decode_32k",
                   "--run", "--device", "cpu", "--reduced", "--rows", "2",
                   "--out", str(out)]) == 0
    (row,) = json.loads(out.read_text())
    assert ROW_FIELDS <= set(row) and row["status"] == "ok"
    run = row["run"]
    assert run["seq_len"] == 32768 and run["rows"] == 2
    assert run["finite"] and run["output_shape"] == [2, 1, 512]
    assert run["pos"] == 32767
    assert row["reduced"] == {"rows": [2, 128]}
    assert run["flops"] > 0 and run["device_ms"] is None


def test_device_time_profiles_again_when_events_are_lost(monkeypatch):
    """A profile that holds fewer events of the port's kernels than the
    call launched is taken again; after three such profiles the step
    fails instead of reporting a device time summed over lost events."""
    import torch.profiler as P
    from repro_torch import kernels
    seen = iter([1, 2, 1, 1, 1])

    class Event:
        def __init__(self, key, count):
            self.key, self.count = key, count
            self.self_device_time_total = 500.0 * count

    class Profile:
        def __init__(self, **_):
            self.count = next(seen)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [Event("void repro::flash_mma_kernel<128, 128>", self.count),
                    Event("ampere_bf16_gemm", 3)]

    def call():                 # two launches of the port's kernels
        FA.launches += 2
        return "out"

    monkeypatch.setattr(P, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    kernels.reset_launch_counts()
    assert D._device_ms(call) == ("out", 2.5)      # the second profile
    with pytest.raises(RuntimeError, match="events lost"):
        D._device_ms(call)
    kernels.reset_launch_counts()


def test_multi_pod_plans_every_pair(tmp_path):
    """``--all --multi-pod`` plans the 34 admitted pairs per device of the
    2x16x16 mesh (the argument bytes against the reference's specs are in
    ``test_torch_sharding.py``) and skips the other 6; a mesh row is never
    run."""
    out = tmp_path / "multi_pod.json"
    assert D.main(["--all", "--multi-pod", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    ok = [r for r in rows if r["status"] == "ok"]
    assert len(rows) == 40 and len(ok) == 34
    assert all(r["mesh"] == "2x16x16" and r["num_devices"] == 512
               for r in ok)
    with pytest.raises(SystemExit):
        D.main(["--arch", "gemma2-2b", "--shape", "decode_32k", "--mesh",
                "16x16", "--run"])


def test_importing_the_dry_run_sets_nothing_global():
    code = ("import os; before = dict(os.environ); "
            "import repro_torch.launch.dryrun, repro_torch.launch.step_cost; "
            "import sys; "
            "sys.exit(0 if dict(os.environ) == before and 'jax' not in "
            "sys.modules else 1)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    assert subprocess.run([sys.executable, "-c", code], env=env,
                          timeout=120).returncode == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_final_softcap_in_place_without_grad_equals_the_recorded_form(
        dtype):
    """gemma2's float32 logits under its final softcap: softcapped in place
    when no gradient is recorded (a prefill of 32768 tokens holds one 33.5
    GB copy, not three), bit for bit the out-of-place form a loss takes."""
    cfg = dataclasses.replace(TC.get_config("gemma2-9b").reduced(),
                              dtype=dtype)
    params = S.M.init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                     generator=torch.Generator()
                                     .manual_seed(1))}
    with torch.no_grad():
        in_place = S.M.forward_train(params, cfg, batch)[0]
    recorded = S.M.forward_train(params, cfg, batch)[0]
    assert in_place.dtype == torch.float32
    assert torch.equal(in_place, recorded)


def test_flash_check_args_refuse_a_grid_past_its_limit():
    """At 32768 positions the flash grids' y extent is group x sq / 64
    (bf16): qwen3-moe's group 16 gives 8192 blocks; a group of 128 would
    give 65536, past CUDA's 65535, and is refused before any launch."""
    def qkv(hq, hkv, s, dt=torch.bfloat16):
        q = torch.zeros(1, 1, 1, 128, dtype=dt).expand(1, hq, s, 128)
        k = torch.zeros(1, 1, 1, 128, dtype=dt).expand(1, hkv, s, 128)
        return q, k, k
    FA.check_args(*qkv(64, 4, 32768))
    FA.check_args(*qkv(127, 1, 32768))
    with pytest.raises(ValueError, match="grid of 65536 blocks"):
        FA.check_args(*qkv(128, 1, 32768))
    with pytest.raises(ValueError, match="65535"):
        FA.check_args(*qkv(4, 1, 2 ** 20 + 16, torch.float32))
