"""scopelint-torch runner: scan files, apply suppressions, run the runtime
pass.  The port of ``repro/analysis/runner.py``."""
from __future__ import annotations

import pathlib
from typing import Iterable, List, Optional, Sequence

from repro_torch.analysis.astpass import ModuleContext, Rule
from repro_torch.analysis.findings import Finding

PACKAGE = pathlib.Path(__file__).resolve().parents[1]      # src/repro_torch
_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", "build",
              "dist", ".mypy_cache", ".pytest_cache"}


def all_rules() -> List[Rule]:
    from repro_torch.analysis.rules_capture import CaptureHazardRule
    from repro_torch.analysis.rules_determinism import NondeterminismRule
    from repro_torch.analysis.rules_host import HostSyncRule
    from repro_torch.analysis.rules_kernel import KernelContractRule
    from repro_torch.analysis.rules_sideeffect import DeviceSideEffectRule
    return [HostSyncRule(), NondeterminismRule(), CaptureHazardRule(),
            DeviceSideEffectRule(), KernelContractRule()]


def scan_source(source: str, path: str, hot_path: Optional[bool] = None,
                csrc: Optional[str] = None) -> List[Finding]:
    """Run every applicable rule over one module's source."""
    try:
        ctx = ModuleContext(source, path, hot_path=hot_path, csrc=csrc)
    except SyntaxError as exc:
        return [Finding("parse-error", path, exc.lineno or 0, str(exc))]
    findings: List[Finding] = []
    for rule in all_rules():
        if rule.applies(ctx):
            findings.extend(rule.check(ctx))
    findings = ctx.suppressions.apply(findings)
    findings.extend(ctx.suppressions.meta_findings(path))
    return findings


def iter_py_files(paths: Sequence[str]) -> Iterable[pathlib.Path]:
    for raw in paths:
        p = pathlib.Path(raw)
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            # skip by the parts below the root given: a checkout under a
            # directory named build/ is still scanned
            for f in sorted(p.rglob("*.py")):
                if not any(part in _SKIP_DIRS
                           for part in f.relative_to(p).parts):
                    yield f


def scan_paths(paths: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(scan_source(f.read_text(), str(f)))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="scopelint-torch: static serve-path invariant checks "
                    "(AST rules + runtime pass over the serve segments)")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files/directories to scan (default: the "
                         "repro_torch package)")
    ap.add_argument("--self-test", action="store_true",
                    help="run the rule corpus + runtime poison checks")
    ap.add_argument("--no-runtime", action="store_true",
                    help="skip running the registered serve segments")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            scope = "hot-path" if rule.hot_path_only else "all files"
            print(f"{rule.id:28s} [{scope}] {rule.description}")
        return 0

    failed = False

    if args.self_test:
        from repro_torch.analysis.selftest import run_self_test
        failures = run_self_test()
        for msg in failures:
            print(f"self-test FAILED: {msg}")
        n_rules = len(all_rules())
        if failures:
            failed = True
        else:
            print(f"self-test: {n_rules} rules fire/stay-silent on their "
                  "corpus twins; runtime poison checks pass")

    findings = scan_paths(args.paths or [str(PACKAGE)])
    runtime = ""
    if not args.no_runtime:
        import torch

        from repro_torch.analysis import runtime_pass
        # the card when there is one; the summary names the device
        device = torch.device("cuda" if torch.cuda.is_available()
                              else "cpu")
        reports = runtime_pass.run_runtime_pass(device=device)
        findings.extend(f for r in reports for f in r.findings)
        runtime = (f"; runtime pass: {len(reports)} units run on "
                   f"{device.type}")

    hard = [f for f in findings if not f.suppressed]
    soft = [f for f in findings if f.suppressed]
    for f in hard + soft:
        print(f.render())
    print(f"scopelint-torch: {len(hard)} findings ({len(soft)} suppressed)"
          + runtime)
    if hard:
        failed = True
    return 1 if failed else 0
