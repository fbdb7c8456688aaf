"""scopelint-torch: static analysis enforcing the port's serve-path
invariants.  The port of ``repro/analysis`` (scopelint).

Two layers:

- **AST rules** (``astpass`` + ``rules_*``): host syncs in the hot path,
  serve-time nondeterminism, CUDA-graph capture hazards, side effects in
  device bodies, and the contract of the ctypes kernel boundary (argtypes
  against the ``extern "C"`` signatures in ``csrc/``), checked over the
  source with a device-body index and value taint so host-side config
  idioms don't false-positive.
- **runtime pass** (``runtime_pass``): the registered serve segments run
  under a dispatch recorder (and, on the card, CUDA's sync debug mode),
  which flags host reads of device values, float64 outputs, device->host
  copies, and syncs after a segment's first launch — what the card is
  asked to do, not what the source says.

CLI: ``python -m repro_torch.analysis [--self-test] [--list-rules]
[--no-runtime] [paths]``.  Suppress a finding with ``# scopelint-torch:
allow[rule-id] -- reason``.
"""
from repro_torch.analysis.astpass import ModuleContext, Rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.runner import all_rules, main, scan_paths, scan_source

__all__ = ["Finding", "ModuleContext", "Rule", "all_rules", "main",
           "scan_paths", "scan_source"]
