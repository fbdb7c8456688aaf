"""scopelint-torch (repro_torch.analysis): the rule corpus self-test, the
suppressions, manifest and neutral-snippet findings held to the reference's
(repro.analysis) on the same inputs, the port tree clean under both lints,
and the ctypes kernel boundary held to the extern "C" signatures."""
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import manifest as ref_manifest
from repro.analysis import runner as ref_runner
from repro.analysis.findings import Finding as RefFinding
from repro.analysis.suppress import Suppressions as RefSuppressions
from repro_torch.analysis import all_rules, main, scan_paths, scan_source
from repro_torch.analysis.astpass import ModuleContext
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.manifest import is_hot_path
from repro_torch.analysis.rules_capture import CaptureHazardRule
from repro_torch.analysis.rules_kernel import (KernelContractRule,
                                               argtype_kinds, c_signatures,
                                               package_csrc)
from repro_torch.analysis.selftest import run_self_test
from repro_torch.analysis.suppress import (MISSING_REASON, UNUSED,
                                           Suppressions)

REPO = pathlib.Path(__file__).resolve().parents[1]
SRC = REPO / "src"
PORT = SRC / "repro_torch"
RULE_IDS = ["cuda-kernel-contract", "device-body-side-effect",
            "graph-capture-hazard", "host-sync-in-hot-path",
            "serve-time-nondeterminism"]


# ---------------------------------------------------------------------------
# Rule corpus: every rule fires on its triggers, stays silent on its twins
# ---------------------------------------------------------------------------
def test_self_test_corpus_is_green():
    assert run_self_test() == []


def test_every_rule_ships_a_corpus():
    for rule in all_rules():
        assert rule.triggers, f"{rule.id} has no trigger corpus"
        assert rule.non_triggers, f"{rule.id} has no non-trigger corpus"


def test_rule_ids_are_the_documented_five():
    assert sorted(r.id for r in all_rules()) == RULE_IDS


@pytest.mark.parametrize("flag", ["--list-rules", "--self-test"])
def test_cli_flags_exit_zero(flag, capsys):
    args = [flag] if flag == "--list-rules" else \
        [flag, "--no-runtime", str(PORT)]
    assert main(args) == 0
    out = capsys.readouterr().out
    if flag == "--list-rules":
        assert all(rid in out for rid in RULE_IDS)
    else:
        assert "scopelint-torch: 0 findings" in out


def test_cli_scans_the_port_and_runs_the_runtime_pass():
    """The documented command: static pass, self-test and the runtime
    pass's five units on the CPU (no card here)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch",
         "--self-test"], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)), timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert re.fullmatch(r"scopelint-torch: 0 findings \(\d+ suppressed\); "
                        r"runtime pass: 5 units run on cpu", last), last


# ---------------------------------------------------------------------------
# Suppressions: the reference's parser and meta-rules, the port's marker
# ---------------------------------------------------------------------------
SUPPRESSION_SOURCES = {
    "inline": "x = 1  # M: allow[host-sync-in-hot-path] -- ok\n",
    "standalone-star": "# M: allow[*] -- blanket\nx = 1\n",
    "no-reason": "x = 1  # M: allow[recompile-hazard]\n",
    "list": "x = f()  # M: allow[a, b,c] -- two words\n",
    "docstring": '"""Docs: use # M: allow[rule] -- reason to waive."""\n',
    "meta": "x = 1  # M: allow[unused-suppression] -- nice try\n",
    "nested": ("def f():\n    # M: allow[x] -- r\n"
               "    return 1  # M: allow[y]\n"),
    "untokenizable": "x = (\n# M: allow[a] -- r\n",
}
PROBES = [("host-sync-in-hot-path", 1), ("any-rule-at-all", 2),
          ("another", 1), ("recompile-hazard", 1), ("b", 1), ("c", 1),
          ("rule", 1), (UNUSED, 1), (MISSING_REASON, 1), ("x", 3),
          ("y", 3), ("a", 3)]


def _entries(sup):
    return [(e.comment_line, e.target_line, e.rules, e.reason)
            for e in sup._entries]


def _finding_tuple(f):
    return (f.rule, f.path, f.line, f.message, f.suppressed,
            f.suppress_reason)


@pytest.mark.parametrize("name", sorted(SUPPRESSION_SOURCES))
def test_suppressions_parse_as_the_reference(name):
    src = SUPPRESSION_SOURCES[name]
    ours = Suppressions.parse(src.replace("# M:", "# scopelint-torch:"))
    ref = RefSuppressions.parse(src.replace("# M:", "# scopelint:"))
    assert _entries(ours) == _entries(ref)
    for rule, line in PROBES:
        a, b = ours.match(rule, line), ref.match(rule, line)
        assert (a is None) == (b is None), (rule, line)
    assert [_finding_tuple(f) for f in ours.meta_findings("p.py")] == \
        [_finding_tuple(f) for f in ref.meta_findings("p.py")]


def test_markers_do_not_cross():
    """The reference's pattern does not read the port's marker, nor the
    port's the reference's: a port waiver can never be an unused
    suppression of the reference's lint."""
    port = "x = 1  # scopelint-torch: allow[r] -- why\n"
    ref = "x = 1  # scopelint: allow[r] -- why\n"
    assert _entries(RefSuppressions.parse(port)) == []
    assert _entries(Suppressions.parse(ref)) == []


def test_inline_suppression_absorbs_finding_and_keeps_reason():
    src = textwrap.dedent("""\
        def step_cuda(x):
            return float(x)  # scopelint-torch: allow[host-sync-in-hot-path] -- ok
        """)
    path = "repro_torch/kernels/x.py"
    out = scan_source(src, path)
    assert out and all(f.suppressed for f in out)
    assert out[0].suppress_reason == "ok"
    raw = scan_source(src.replace(
        "  # scopelint-torch: allow[host-sync-in-hot-path] -- ok", ""), path)
    assert any(not f.suppressed for f in raw)


@pytest.mark.parametrize("kw", [
    {}, {"suppressed": True, "suppress_reason": "because"}])
@pytest.mark.parametrize("line", [0, 7])
def test_finding_render_matches_reference(kw, line):
    args = ("some-rule", "<runtime:x>" if line == 0 else "a/b.py", line,
            "message")
    assert Finding(*args, **kw).render() == RefFinding(*args, **kw).render()


# ---------------------------------------------------------------------------
# Hot-path manifest
# ---------------------------------------------------------------------------
def _mapped(path: pathlib.Path, src: str, dst: str) -> str:
    return str(path).replace(f"/{src}/", f"/{dst}/", 1)


@pytest.mark.parametrize("tree", ["repro", "repro_torch"])
def test_hot_path_agrees_with_the_reference(tree):
    files = sorted((SRC / tree).rglob("*.py"))
    assert len(files) > 40
    for f in files:
        if tree == "repro":
            ours, ref = _mapped(f, "repro", "repro_torch"), str(f)
        else:
            ours, ref = str(f), _mapped(f, "repro_torch", "repro")
        assert is_hot_path(ours) == ref_manifest.is_hot_path(ref), f


def test_hot_path_manifest():
    assert is_hot_path("src/repro_torch/serving/sampler.py")
    assert is_hot_path("src/repro_torch/kernels/decode_attention.py")
    assert is_hot_path("src/repro_torch/api/engine.py")
    assert is_hot_path("src/repro_torch/models/tier0.py")
    assert not is_hot_path("src/repro_torch/api/cache.py")
    assert not is_hot_path("src/repro_torch/training/grpo.py")
    assert not is_hot_path("src/repro/serving/sampler.py")
    assert not is_hot_path("tests/test_runtime.py")


# ---------------------------------------------------------------------------
# Framework-neutral snippets: equal (rule, line) findings from both lints
# ---------------------------------------------------------------------------
NEUTRAL = {
    "clocks": """\
import time
import datetime

def tick(clock=time.monotonic):
    t0 = time.monotonic()
    t1 = time.perf_counter()
    return datetime.datetime.now(), t0, t1, clock
""",
    "stdlib-rng": """\
import random

def pick(slots):
    random.seed(3)
    return random.choice(slots), random.random()
""",
    "numpy-rng": """\
import numpy as np

def plan(n):
    rng = np.random.default_rng(0)
    return np.random.rand(n), rng.random(n)
""",
    "item": """\
def read(x, rows):
    n = x.item()
    return rows[:n], x.item() + 1
""",
}


@pytest.mark.parametrize("hot", [True, False])
@pytest.mark.parametrize("name", sorted(NEUTRAL))
def test_neutral_snippets_give_the_reference_findings(name, hot):
    src = NEUTRAL[name]
    sub = "serving" if hot else "training"
    ours = scan_source(src, f"src/repro_torch/{sub}/x.py")
    ref = ref_runner.scan_source(src, f"src/repro/{sub}/x.py")
    key = sorted((f.rule, f.line) for f in ours)
    assert key == sorted((f.rule, f.line) for f in ref)
    assert bool(key) == hot


# ---------------------------------------------------------------------------
# The port's tree under both lints
# ---------------------------------------------------------------------------
# (rule, file) of every waiver in the port, one entry a finding
WAIVED = sorted(
    [("device-body-side-effect", "kernels/decode_attention.py")] * 2
    + [("device-body-side-effect", "kernels/flash_attention.py")] * 4
    + [("device-body-side-effect", "kernels/ssd_scan.py")] * 2
    + [("device-body-side-effect", "kernels/ssd_decode_step.py"),
       ("device-body-side-effect", "kernels/topk_retrieval.py"),
       ("graph-capture-hazard", "kernels/decode_attention.py"),
       ("device-body-side-effect", "models/moe.py"),
       ("serve-time-nondeterminism", "serving/faults.py")]
    + [("host-sync-in-hot-path", "serving/sampler.py")] * 2
    + [("host-sync-in-hot-path", "models/tier0.py")] * 2)


def test_port_tree_has_no_unsuppressed_findings():
    findings = scan_paths([str(PORT)])
    hard = [f.render() for f in findings if not f.suppressed]
    assert hard == []
    waived = sorted((f.rule, str(pathlib.Path(f.path).relative_to(PORT)))
                    for f in findings if f.suppressed)
    assert waived == WAIVED
    assert all(f.suppress_reason for f in findings)


def test_scan_paths_reads_a_checkout_under_a_build_directory(tmp_path):
    """Directories like build/ are skipped below the root given, never in
    the root's own path."""
    root = tmp_path / "build" / "checkout" / "src"
    for rel in ("repro_torch/serving/x.py", "repro_torch/build/y.py"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text("def f(x):\n    return x.item()\n")
    found = [(f.rule, pathlib.Path(f.path).name)
             for f in scan_paths([str(root)])]
    assert found == [("host-sync-in-hot-path", "x.py")]


def test_reference_lint_is_clean_over_the_port():
    """The reference's lint scans all of src/, this package included; a
    waiver in its syntax (``# scopelint:``) in a port file would be its
    unused suppression.  The port's waivers use ``# scopelint-torch:``."""
    hard = [f.render() for f in ref_runner.scan_paths([str(PORT)])
            if not f.suppressed]
    assert hard == [], ("the reference's lint flags the port; a port "
                        "waiver must read '# scopelint-torch: allow[...]', "
                        f"never '# scopelint: allow[...]': {hard}")


# ---------------------------------------------------------------------------
# Device-body index and taint
# ---------------------------------------------------------------------------
def _ctx(rel: str) -> ModuleContext:
    path = PORT / rel
    return ModuleContext(path.read_text(), str(path))


@pytest.mark.parametrize("rel,name,kind,tainted", [
    ("models/model.py", "decode_step", "root",
     {"params", "token", "caches", "pos", "paged"}),
    ("models/transformer.py", "block_decode", "root",
     {"p", "h", "cos", "sin", "cache", "pos", "paged"}),
    ("models/attention.py", "gqa_decode", "root",
     {"p", "x", "cos", "sin", "cache", "pos"}),
    ("models/attention.py", "_gqa_qkv", "transitive", set()),
    ("models/ssm.py", "mamba_decode", "root", {"p", "x", "cache"}),
    ("models/tier0.py", "tier0_forward", "root",
     {"params", "qf", "af", "mf", "mid"}),
    ("kernels/decode_attention.py", "paged_decode_attention_cuda", "wrapper",
     {"q", "k_pages", "v_pages", "cache_len", "page_table"}),
    ("kernels/decode_attention.py", "check_args", "transitive", set()),
    ("kernels/ssd_scan.py", "ssd_scan_bwd_cuda", "wrapper",
     {"x", "dt", "A", "B", "C", "dy", "dstate", "states"}),
])
def test_device_bodies_are_indexed(rel, name, kind, tainted):
    """Roots taint their positional parameters except those annotated with
    a host type (cfg: ModelConfig, kind: str); keyword-only parameters
    (a wrapper's window, softcap, page_size) stay static."""
    ctx = _ctx(rel)
    fns = {ctx.qualname(fn.node): fn for fn in ctx.device.values()}
    assert fns[name].kind == kind
    assert set(fns[name].tainted_params) == tainted


def test_no_device_body_outside_the_manifest():
    for rel in ("serving/sampler.py", "api/engine.py", "training/sft.py"):
        assert _ctx(rel).device == {}


_KWONLY = textwrap.dedent("""\
    import torch

    def step_cuda(x, cfg: ModelConfig, kind: str, *, softcap: float = 0.0):
        if softcap > 0.0 and cfg.qk_norm and kind == "attn":
            x = x / float(softcap)
        return x
    """)


def test_static_parameters_do_not_taint():
    ctx = ModuleContext(_KWONLY, "repro_torch/kernels/k.py")
    assert list(CaptureHazardRule().check(ctx)) == []


def test_positional_parameter_branch_is_flagged():
    src = _KWONLY.replace("cfg: ModelConfig", "cfg").replace(
        "*, softcap: float = 0.0", "softcap")
    hits = list(CaptureHazardRule().check(
        ModuleContext(src, "repro_torch/kernels/k.py")))
    assert hits and hits[0].rule == "graph-capture-hazard"


# every rule reaches the real device bodies: one mutation of the port's own
# source each, which the lint must flag (and the unmutated file passes)
MUTATIONS = [
    ("models/model.py", "    b = token.shape[0]\n",
     "    b = token.shape[0]\n    if pos.max() > 100:\n        pass\n",
     "graph-capture-hazard"),
    ("models/attention.py",
     "    q, k, v = _gqa_qkv(p, cfg, x, cos, sin)\n"
     "    rows = torch.arange(b, device=x.device)\n",
     "    q, k, v = _gqa_qkv(p, cfg, x, cos, sin)\n"
     "    rows = torch.tensor(list(range(b)), device=x.device)\n",
     "graph-capture-hazard"),
    ("models/ssm.py", "    xh = x_in.reshape(b, heads, hd)\n",
     "    xh = x_in.reshape(b, heads, hd)\n    _STEPS.append(1)\n",
     "device-body-side-effect"),
    ("kernels/ssd_decode_step.py",
     "    y = torch.empty((b, h, p), dtype=torch.float32, device=dev)\n",
     "    y = torch.empty((b, h, p), dtype=torch.float32, device=dev)\n"
     "    if dt:\n        pass\n",
     "host-sync-in-hot-path"),
    ("kernels/topk_retrieval.py", "    nq, d = queries.shape\n",
     "    nq, d = queries.shape\n    _ = anchors.tolist()\n",
     "host-sync-in-hot-path"),
    # the form sinusoid_at had: a copy from the host each decode step
    ("models/common.py", "    log_base = torch.log(torch.tensor(10000.0))\n",
     "    log_base = torch.log(torch.tensor(10000.0, device=pos.device))\n",
     "graph-capture-hazard"),
    ("serving/scheduler.py", "from __future__ import annotations\n",
     "from __future__ import annotations\nimport time\n_T0 = time.time()\n",
     "serve-time-nondeterminism"),
]


@pytest.mark.parametrize("rel,old,new,rule", MUTATIONS,
                         ids=[m[0] + ":" + m[3] for m in MUTATIONS])
def test_lint_flags_a_mutated_port_module(rel, old, new, rule):
    path = PORT / rel
    src = path.read_text()
    assert src.count(old) == 1
    before = [f for f in scan_source(src, str(path)) if not f.suppressed]
    after = [f for f in scan_source(src.replace(old, new), str(path))
             if not f.suppressed]
    assert before == []
    assert [f.rule for f in after] == [rule], [f.render() for f in after]


# ---------------------------------------------------------------------------
# cuda-kernel-contract: the ctypes boundary against csrc/*.cu
# ---------------------------------------------------------------------------
WRAPPERS = [
    ("topk_retrieval.py", "repro_topk_retrieval", 10),
    ("flash_attention.py", "repro_flash_attention", 28),
    ("flash_attention.py", "repro_flash_attention_bwd", 39),
    ("decode_attention.py", "repro_decode_attention", 24),
    ("decode_attention.py", "repro_paged_decode_attention", 26),
    ("ssd_scan.py", "repro_ssd_scan", 27),
    ("ssd_scan.py", "repro_ssd_scan_bwd", 38),
    ("ssd_decode_step.py", "repro_ssd_decode_step", 25),
]


@pytest.mark.parametrize("module,symbol,n", WRAPPERS,
                         ids=[w[1] for w in WRAPPERS])
def test_wrapper_argtypes_match_the_c_signature(module, symbol, n):
    import ast
    path = PORT / "kernels" / module
    tree = ast.parse(path.read_text())
    assigns = {t.id: node.value for node in tree.body
               if isinstance(node, ast.Assign) for t in node.targets
               if isinstance(t, ast.Name)}
    loads = [node for node in ast.walk(tree) if isinstance(node, ast.Call)
             and ast.unparse(node.func) == "build.load"
             and node.args[1].value == symbol]
    assert len(loads) == 1
    kinds = argtype_kinds(loads[0].args[2], assigns)
    want = c_signatures(package_csrc(str(path)))[symbol]
    assert kinds == want and len(want) == n


def test_every_extern_c_symbol_has_its_wrapper():
    sigs = c_signatures(package_csrc(str(PORT / "kernels" / "build.py")))
    assert sorted(sigs) == sorted(w[1] for w in WRAPPERS)
    assert all(k in ("pointer", "int", "long long", "float")
               for kinds in sigs.values() for k in kinds)


def test_kernel_contract_holds_every_wrapper():
    for module in sorted({w[0] for w in WRAPPERS}):
        assert list(KernelContractRule().check(
            _ctx(f"kernels/{module}"))) == [], module


_DECODE = PORT / "kernels" / "decode_attention.py"
CONTRACT_BREAKS = {
    "argtypes one short": (
        "             + [ctypes.c_longlong] * 8\n"
        "             + [ctypes.c_int, ctypes.c_float, ctypes.c_float, "
        "ctypes.c_void_p])",
        "             + [ctypes.c_longlong] * 7\n"
        "             + [ctypes.c_int, ctypes.c_float, ctypes.c_float, "
        "ctypes.c_void_p])",
        "23 argtypes for 24"),
    "c_int for long long": (
        "_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7\n"
        "             + [ctypes.c_longlong] * 8",
        "_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8\n"
        "             + [ctypes.c_longlong] * 7",
        "argument 12 is int in argtypes, long long in C"),
    "no check": ("    check_args(q, k_cache, v_cache, lens)\n", "",
                 "without its check_*"),
    "no stream": ("             torch.cuda.current_stream(dev).cuda_stream)\n"
                  "    build.check(err, \"decode_attention\")",
                  "             0)\n    build.check(err, \"decode_attention\")",
                  "current_stream"),
    "unchecked result": ("    build.check(err, \"decode_attention\")\n", "",
                         "build.check"),
}


@pytest.mark.parametrize("name", sorted(CONTRACT_BREAKS))
def test_kernel_contract_flags_a_broken_wrapper(name):
    old, new, msg = CONTRACT_BREAKS[name]
    src = _DECODE.read_text()
    assert src.count(old) == 1
    ctx = ModuleContext(src.replace(old, new), str(_DECODE))
    hits = list(KernelContractRule().check(ctx))
    assert len(hits) == 1 and msg in hits[0].message, \
        [h.message for h in hits]


@pytest.mark.parametrize("wrap", ["loop", "fallback"])
def test_kernel_contract_flags_a_launch_in_a_loop_or_try(wrap):
    src = _DECODE.read_text()
    old = ("    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),")
    head, tail = src.split(old)
    call, rest = tail.split("    build.check(err, \"decode_attention\")\n", 1)
    body = textwrap.indent(old.lstrip() + call, "        ")
    if wrap == "loop":
        block = f"    for _ in range(2):\n{body}" \
                "        build.check(err, \"decode_attention\")\n"
        msg = "inside a loop"
    else:
        block = f"    try:\n{body}" \
                "        build.check(err, \"decode_attention\")\n" \
                "    except RuntimeError:\n" \
                "        return decode_attention_plain(q, k_cache, v_cache, " \
                "cache_len)\n"
        msg = "inside a try"
    ctx = ModuleContext(head + block + rest, str(_DECODE))
    hits = [h.message for h in KernelContractRule().check(ctx)]
    assert len(hits) == 1 and msg in hits[0], hits
