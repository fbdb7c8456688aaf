"""scopelint-torch self-test: prove every rule alive before trusting a clean
run.  The port of ``repro/analysis/selftest.py``.

A static checker's worst failure mode is silence — a refactor that makes a
rule stop matching produces the same output as a healthy codebase.  So
every rule ships a corpus: ``triggers`` it must flag and ``non_triggers``
(near-identical twins) it must not.  The suppression machinery and the
runtime recorder get the same treatment: a deliberately poisoned toy (a
``.item()`` and a ``.double()`` among four ops) must be flagged, a clean
one must not.

``run_self_test()`` returns failure messages; empty means healthy.
"""
from __future__ import annotations

from typing import List

# a kernel module: hot path, and its *_cuda functions are device bodies
SELFTEST_PATH = "repro_torch/kernels/_scopelint_selftest.py"

_SUPPRESSED_SNIPPET = """\
def toy_cuda(x):
    return float(x)  # scopelint-torch: allow[host-sync-in-hot-path] -- corpus
"""

_UNSUPPRESSED_TWIN = _SUPPRESSED_SNIPPET.replace(
    "  # scopelint-torch: allow[host-sync-in-hot-path] -- corpus", "")


def run_self_test() -> List[str]:
    from repro_torch.analysis.astpass import ModuleContext
    from repro_torch.analysis.runner import all_rules, scan_source

    failures: List[str] = []
    for rule in all_rules():
        for i, snip in enumerate(rule.triggers):
            ctx = ModuleContext(snip, SELFTEST_PATH, hot_path=True,
                                csrc=rule.corpus_csrc)
            if not list(rule.check(ctx)):
                failures.append(
                    f"{rule.id}: trigger snippet #{i} produced no finding")
        for i, snip in enumerate(rule.non_triggers):
            ctx = ModuleContext(snip, SELFTEST_PATH, hot_path=True,
                                csrc=rule.corpus_csrc)
            hits = list(rule.check(ctx))
            if hits:
                failures.append(
                    f"{rule.id}: non-trigger snippet #{i} false-positived: "
                    f"{hits[0].message!r}")

    # suppression machinery: the allow comment must absorb the finding...
    sup = scan_source(_SUPPRESSED_SNIPPET, SELFTEST_PATH, hot_path=True)
    if [f for f in sup if not f.suppressed]:
        failures.append("suppression: allow[...] comment did not suppress")
    if not [f for f in sup if f.suppressed]:
        failures.append("suppression: suppressed finding not reported")
    # ...and the twin without it must fail
    raw = scan_source(_UNSUPPRESSED_TWIN, SELFTEST_PATH, hot_path=True)
    if not [f for f in raw if not f.suppressed]:
        failures.append("suppression: unsuppressed twin produced no finding")

    failures.extend(_runtime_self_test())
    return failures


def poisoned(x):
    """Four ops, two of them forbidden: a host read and a float64 output."""
    y = x * 2.0
    return y.sum().item(), y.double()


def clean(x):
    return (x * 2.0).sum()


def _runtime_self_test() -> List[str]:
    import torch

    from repro_torch.analysis.runtime_pass import check_window

    failures: List[str] = []
    dev = torch.device("cpu")
    x = torch.arange(4, dtype=torch.float32)
    msgs = " ".join(f.message for f in
                    check_window("poisoned", lambda: poisoned(x), dev))
    if "_local_scalar_dense" not in msgs:
        failures.append("runtime: poisoned toy's host read missed")
    if "float64" not in msgs:
        failures.append("runtime: poisoned toy's float64 output missed")
    leftover = check_window("clean", lambda: clean(x), dev)
    if leftover:
        failures.append(
            f"runtime: clean toy false-positived: {leftover[0].message!r}")
    return failures
