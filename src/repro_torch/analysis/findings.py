"""Finding record shared by both scopelint-torch layers (AST rules and the
runtime pass).  The port of ``repro/analysis/findings.py``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location.

    ``path`` is the file as given to the scanner (or ``<runtime:name>`` for
    runtime-pass findings, which have no source line).  ``suppressed`` marks
    a finding matched by an inline ``# scopelint-torch: allow[rule] --
    reason`` comment; suppressed findings are reported but do not fail the
    run.
    """
    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    suppress_reason: str = ""

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        base = f"{loc}: [{self.rule}] {self.message}"
        if self.suppressed:
            base += f"  (suppressed: {self.suppress_reason})"
        return base
