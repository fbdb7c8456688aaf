"""Inline suppression comments: ``# scopelint-torch: allow[rule-id] -- reason``.

The port of ``repro/analysis/suppress.py`` with its own marker.  The
reference's lint scans the whole source tree, this package included, and
its pattern (``# scopelint: allow[...]``) would read a port waiver as one of
its own that matched nothing, a finding it cannot suppress.  The port's
marker is one that pattern does not match.

A suppression applies to findings on the same physical line, or — when the
comment stands alone on its line — to the line directly below it.  Several
rule ids may be listed comma-separated; ``allow[*]`` matches any rule.

The suppression machinery polices itself: a suppression without a
``-- reason`` justification and a suppression that matched nothing are both
findings (``suppression-missing-reason`` / ``unused-suppression``), so dead
or unexplained waivers cannot accumulate silently.  Those two meta-rules
cannot themselves be suppressed.
"""
from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from typing import List, Optional

from repro_torch.analysis.findings import Finding

_ALLOW_RX = re.compile(
    r"#\s*scopelint-torch:\s*allow\[([A-Za-z0-9_*\-, ]+)\]"
    r"(?:\s*--\s*(.*\S))?\s*$")

# meta-findings emitted by the suppression layer itself; never suppressible
MISSING_REASON = "suppression-missing-reason"
UNUSED = "unused-suppression"
_META = frozenset({MISSING_REASON, UNUSED})


@dataclasses.dataclass
class _Entry:
    comment_line: int       # line the comment sits on (1-based)
    target_line: int        # line whose findings it suppresses
    rules: List[str]
    reason: Optional[str]
    used: bool = False


class Suppressions:
    """Parsed ``allow[...]`` comments of one module."""

    def __init__(self, entries: List[_Entry]):
        self._entries = entries

    @classmethod
    def parse(cls, source: str) -> "Suppressions":
        # real COMMENT tokens only — the syntax quoted in a docstring or
        # string literal is documentation, not a waiver
        entries: List[_Entry] = []
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(source).readline))
        except (tokenize.TokenError, SyntaxError, IndentationError):
            tokens = []
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _ALLOW_RX.search(tok.string)
            if not m:
                continue
            rules = [r.strip() for r in m.group(1).split(",") if r.strip()]
            line = tok.start[0]
            standalone = tok.line[: tok.start[1]].strip() == ""
            entries.append(_Entry(
                comment_line=line,
                target_line=line + 1 if standalone else line,
                rules=rules,
                reason=m.group(2)))
        return cls(entries)

    def match(self, rule: str, line: int) -> Optional[_Entry]:
        """Return (and mark used) the entry covering ``rule`` at ``line``."""
        if rule in _META:
            return None
        for e in self._entries:
            if e.target_line == line and (rule in e.rules or "*" in e.rules):
                e.used = True
                return e
        return None

    def meta_findings(self, path: str) -> List[Finding]:
        """Findings about the suppressions themselves (run after matching)."""
        out: List[Finding] = []
        for e in self._entries:
            if e.reason is None:
                out.append(Finding(
                    MISSING_REASON, path, e.comment_line,
                    "suppression lacks a '-- reason' justification"))
            if not e.used:
                out.append(Finding(
                    UNUSED, path, e.comment_line,
                    f"suppression allow[{', '.join(e.rules)}] matched "
                    "no finding — remove it or fix the target line"))
        return out

    def apply(self, findings: List[Finding]) -> List[Finding]:
        """Mark findings covered by an entry as suppressed."""
        out: List[Finding] = []
        for f in findings:
            e = self.match(f.rule, f.line)
            if e is not None:
                f = dataclasses.replace(
                    f, suppressed=True, suppress_reason=e.reason or "")
            out.append(f)
        return out
