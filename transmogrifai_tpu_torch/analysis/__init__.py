"""Static validation of pipelines (counterpart of
``transmogrifai_tpu.analysis``): the DAG lint (``linter``, rules
TM001-TM006 and TM060) that ``OpWorkflow.train(validate=True)`` runs
before any data moves, and the diagnostics it reports in
(``diagnostics``).  ``lint_plan``, the lint CLI and the source-level rule
families are not ported (ROADMAP Queue A item 6, "static analysis")."""
from .diagnostics import (ERROR, RULES, WARNING, Diagnostic, Findings,
                          PipelineLintError)
from .linter import lint_dag, lint_workflow

__all__ = ["Diagnostic", "Findings", "PipelineLintError", "RULES", "ERROR",
           "WARNING", "lint_dag", "lint_workflow"]
