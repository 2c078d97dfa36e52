"""``# tmog: disable=`` suppressions (the part of
``transmogrifai_tpu.analysis.astutil`` the DAG lint reads).

A ``# tmog: disable=TM060`` comment (comma-separate several ids) disables
the rule on that line, and, for a statement spanning several lines, on
any line the flagged node covers.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, Optional, Set

__all__ = ["Suppressions"]

_DISABLE_RE = re.compile(r"#\s*tmog:\s*disable=([A-Z0-9,\s]+)")


class Suppressions:
    """Per-file ``# tmog: disable=`` map: line number -> suppressed ids."""

    def __init__(self, code: str):
        self.by_line: Dict[int, Set[str]] = {}
        for i, line in enumerate(code.splitlines(), 1):
            m = _DISABLE_RE.search(line)
            if m:
                self.by_line[i] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()}

    def suppressed(self, rule: str, node: Optional[ast.AST] = None,
                   extra_lines: Iterable[Optional[int]] = ()) -> bool:
        """True when ``rule`` is disabled on any line ``node`` covers or on
        any of ``extra_lines``."""
        lines = list(extra_lines)
        if node is not None:
            start = getattr(node, "lineno", None)
            if start is not None:
                end = getattr(node, "end_lineno", None) or start
                lines.extend(range(start, end + 1))
        return any(ln is not None and rule in self.by_line.get(ln, ())
                   for ln in lines)
