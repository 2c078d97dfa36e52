"""Diagnostics of the DAG lint (counterpart of
``transmogrifai_tpu.analysis.diagnostics``).

Every finding is a ``Diagnostic`` with a stable rule id, a severity and a
location: the offending stage's uid, and the stage class's ``file:line``.
``Findings`` is the ordered container ``lint_dag`` returns;
``OpWorkflow.train`` raises ``PipelineLintError`` when it holds an error.
The catalog keeps the JAX package's ids and severities for the rules the
port's linter emits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["Diagnostic", "Findings", "PipelineLintError", "RULES", "ERROR",
           "WARNING", "JSON_SCHEMA_VERSION"]

ERROR = "error"
WARNING = "warning"

#: rule id -> (default severity, one-line title)
RULES: Dict[str, Any] = {
    "TM001": (ERROR, "dangling input column: no stage in the DAG produces it"),
    "TM002": (ERROR, "shadowed column: a stage output overwrites an earlier "
                     "column of the same name"),
    "TM003": (ERROR, "duplicate output column: two stages emit the same name"),
    "TM004": (ERROR, "feature-type mismatch at a stage boundary"),
    "TM005": (WARNING, "dead stage: computed but never consumed by a result "
                       "feature"),
    "TM006": (ERROR, "label leakage: response-derived feature wired into a "
                     "predictor input"),
    "TM060": (ERROR, "event-time leakage: a predictor reads event data not "
                     "provably before the key's cutoff (no cutoff spec, or "
                     "a response event field consumed as a predictor)"),
}

#: version of the report shape ``Findings.to_json`` writes
JSON_SCHEMA_VERSION = 3


@dataclasses.dataclass
class Diagnostic:
    """One finding: rule id, message, severity and where."""

    rule: str
    message: str
    severity: str = ERROR
    #: the offending stage's uid
    stage_uid: Optional[str] = None
    #: "path.py:42"
    location: Optional[str] = None

    def format(self) -> str:
        where = self.location or (f"stage {self.stage_uid}"
                                  if self.stage_uid else "<pipeline>")
        return f"{where}: {self.rule} [{self.severity}] {self.message}"

    def to_json(self) -> Dict[str, Any]:
        return {"rule": self.rule, "severity": self.severity,
                "message": self.message, "stageUid": self.stage_uid,
                "location": self.location}


class Findings:
    """Ordered collection of diagnostics from one lint."""

    def __init__(self, diagnostics: Optional[Iterable[Diagnostic]] = None):
        self.diagnostics: List[Diagnostic] = list(diagnostics or ())

    def add(self, rule: str, message: str, *, stage_uid: Optional[str] = None,
            location: Optional[str] = None,
            severity: Optional[str] = None) -> Diagnostic:
        d = Diagnostic(rule=rule, message=message,
                       severity=severity or RULES.get(rule, (ERROR,))[0],
                       stage_uid=stage_uid, location=location)
        self.diagnostics.append(d)
        return d

    def extend(self, other: "Findings") -> "Findings":
        self.diagnostics.extend(other.diagnostics)
        return self

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    def rules_fired(self) -> List[str]:
        return sorted({d.rule for d in self.diagnostics})

    def by_rule(self, rule: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.rule == rule]

    def __len__(self) -> int:
        return len(self.diagnostics)

    def __bool__(self) -> bool:
        return bool(self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)

    def format(self) -> str:
        if not self.diagnostics:
            return "no findings"
        lines = [d.format() for d in self.diagnostics]
        lines.append(f"{len(self.errors)} error(s), "
                     f"{len(self.warnings)} warning(s)")
        return "\n".join(lines)

    def to_json(self) -> Dict[str, Any]:
        return {"schemaVersion": JSON_SCHEMA_VERSION,
                "findings": [d.to_json() for d in self.diagnostics],
                "errors": len(self.errors), "warnings": len(self.warnings)}


class PipelineLintError(ValueError):
    """Raised by ``OpWorkflow.train(validate=True)`` when the DAG lint
    finds error-severity problems; carries the ``Findings``."""

    def __init__(self, findings: Findings):
        self.findings = findings
        super().__init__(
            "pipeline failed static validation "
            f"({len(findings.errors)} error(s)):\n" + findings.format())


@dataclasses.dataclass
class LintSnapshot:
    """The lint result a trained model carries (``model.lint_snapshot``):
    per-rule finding counts, the formatted warnings (errors raise before
    training) and the lint's wall seconds."""

    wall_s: float = 0.0
    rule_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    warnings: List[str] = dataclasses.field(default_factory=list)

    @staticmethod
    def from_findings(findings: Findings, wall_s: float) -> "LintSnapshot":
        counts: Dict[str, int] = {}
        for d in findings:
            counts[d.rule] = counts.get(d.rule, 0) + 1
        return LintSnapshot(wall_s=wall_s, rule_counts=counts,
                            warnings=[d.format() for d in findings.warnings])

    def to_json(self) -> Dict[str, Any]:
        return {"wallSecs": round(self.wall_s, 5),
                "ruleCounts": dict(self.rule_counts),
                "warnings": list(self.warnings)}

    def format(self) -> str:
        head = (f"dag lint: {sum(self.rule_counts.values())} finding(s) "
                f"in {self.wall_s * 1e3:.1f} ms")
        return "\n".join([head] + [f"  {w}" for w in self.warnings])
