"""DAG lint: static validation of a feature/stage DAG before any data moves
(counterpart of ``transmogrifai_tpu.analysis.linter``, same rules, ids and
messages):

* TM001 dangling input: a stage reads a column no stage in the DAG
  produces.
* TM002 shadowed column: a stage's output name collides with a raw
  (generator) column.
* TM003 duplicate output: two stages emit the same column name.
* TM004 feature-type mismatch: the wired feature's type does not conform
  to the consumer's declared ``input_types``.
* TM005 dead stage (warning): computed, but consumed by no result feature.
* TM006 label leakage: a response-derived feature reaches a predictor
  input.  Taint starts at the raw responses and flows through ordinary
  stages; the declared label slots of label-aware stages
  (``label_input_positions``) absorb it, and a tainted wire anywhere else
  in such a stage, or into a vectorizer, is the finding.
* TM060 event-time leakage over an event reader
  (``readers/aggregates.py``, ``readers/events.py``): a raw predictor
  whose events are not provably before the key's cutoff — the reader has
  no cutoff, or the predictor reads an event field a response reads.
  Findings point at the feature's construction site, where
  ``# tmog: disable=TM060`` suppresses them.
"""
from __future__ import annotations

import inspect
from typing import Dict, Iterable, List, Optional, Sequence, Set

from ..features.feature import Feature
from ..stages.base import PipelineStage
from ..stages.generator import FeatureGeneratorStage
from ..types.feature_types import OPVector
from .diagnostics import Findings

__all__ = ["lint_dag", "lint_workflow"]

_CLASS_LOC: Dict[type, Optional[str]] = {}


def _stage_location(stage: PipelineStage) -> Optional[str]:
    cls = type(stage)
    if cls not in _CLASS_LOC:
        try:
            f = inspect.getsourcefile(cls)
            _, line = inspect.getsourcelines(cls)
            _CLASS_LOC[cls] = f"{f}:{line}" if f else None
        except (OSError, TypeError):
            _CLASS_LOC[cls] = None
    return _CLASS_LOC[cls]


def _is_generator(stage: PipelineStage) -> bool:
    return isinstance(stage, FeatureGeneratorStage)


def lint_dag(dag, result_features: Optional[Sequence[Feature]] = None,
             suppress: Iterable[str] = (), reader=None) -> Findings:
    """Lint a ``StagesDAG``.  ``result_features`` enables the dead-stage
    rule (TM005); ``suppress`` drops the listed rule ids; ``reader`` is
    the workflow's data reader (TM060 reads event readers only)."""
    findings = Findings()
    suppress = set(suppress)

    produced: Dict[str, PipelineStage] = {}
    for layer in dag.layers:
        for s in layer:
            name = s.get_output().name
            prev = produced.get(name)
            if prev is None:
                produced[name] = s
            elif prev.uid != s.uid:
                if _is_generator(prev) and not _is_generator(s):
                    findings.add(
                        "TM002",
                        f"output {name!r} of {type(s).__name__} shadows the "
                        f"raw column produced by generator {prev.uid}",
                        stage_uid=s.uid, location=_stage_location(s))
                else:
                    findings.add(
                        "TM003",
                        f"output {name!r} emitted by both {prev.uid} "
                        f"({type(prev).__name__}) and {s.uid} "
                        f"({type(s).__name__})",
                        stage_uid=s.uid, location=_stage_location(s))

    for layer in dag.layers:
        for s in layer:
            if _is_generator(s):
                continue
            for i, f in enumerate(s.input_features):
                if f.name not in produced:
                    findings.add(
                        "TM001",
                        f"input {i} ({f.name!r}) of {type(s).__name__} is "
                        f"produced by no stage in the DAG",
                        stage_uid=s.uid, location=_stage_location(s))
                exp = s.expected_input_type(i)
                if exp is not None and not (
                        isinstance(f.ftype, type)
                        and issubclass(f.ftype, exp)):
                    findings.add(
                        "TM004",
                        f"input {i} ({f.name!r}) of {type(s).__name__}: "
                        f"expected {exp.__name__}, got "
                        f"{getattr(f.ftype, '__name__', f.ftype)!r}",
                        stage_uid=s.uid, location=_stage_location(s))

    if result_features is not None:
        needed: Set[str] = set()
        frontier: List[PipelineStage] = [
            produced[f.name] for f in result_features if f.name in produced]
        while frontier:
            s = frontier.pop()
            if s.uid in needed:
                continue
            needed.add(s.uid)
            frontier += [produced[f.name] for f in s.input_features
                         if f.name in produced]
        for layer in dag.layers:
            for s in layer:
                if not _is_generator(s) and s.uid not in needed:
                    findings.add(
                        "TM005",
                        f"{type(s).__name__} -> {s.get_output().name!r} is "
                        f"computed but consumed by no result feature",
                        stage_uid=s.uid, location=_stage_location(s))

    findings.extend(_lint_leakage(dag))
    findings.extend(_lint_event_windows(dag, reader))

    if suppress:
        findings.diagnostics = [d for d in findings.diagnostics
                                if d.rule not in suppress]
    return findings


def _lint_leakage(dag) -> Findings:
    """Taint walk: raw responses taint; ordinary stages propagate; label
    slots absorb; tainted predictor wires are findings."""
    findings = Findings()
    tainted: Set[str] = set()
    for layer in dag.layers:
        for s in layer:
            out_name = s.get_output().name
            if _is_generator(s):
                if s.get_output().is_response:
                    tainted.add(out_name)
                continue
            label_pos = set(s.label_input_positions)
            offending = [(i, f) for i, f in enumerate(s.input_features)
                         if f.name in tainted and i not in label_pos]
            is_vectorizer = (isinstance(s.output_type, type)
                             and issubclass(s.output_type, OPVector))
            if offending and (label_pos or is_vectorizer):
                names = ", ".join(f"{f.name!r} (input {i})"
                                  for i, f in offending)
                kind = ("predictor input of label-aware stage" if label_pos
                        else "featurizer input")
                findings.add(
                    "TM006",
                    f"response-derived feature(s) {names} wired into a "
                    f"{kind} of {type(s).__name__}",
                    stage_uid=s.uid, location=_stage_location(s))
                continue  # the root cause once, no cascade
            if offending:
                # a plain transform of a response (label rescaling) is
                # legitimate; the taint flows on to catch a later consumer
                tainted.add(out_name)
    return findings


_SUPPRESS_CACHE: Dict[str, object] = {}


def _suppressed_at(rule: str, location: Optional[str]) -> bool:
    """``# tmog: disable=<rule>`` check for a ``file:line`` site (the
    file's suppressions are read once; an unreadable file never
    suppresses)."""
    if not location or ":" not in location:
        return False
    path, _, line_s = location.rpartition(":")
    try:
        line = int(line_s)
    except ValueError:
        return False
    if path not in _SUPPRESS_CACHE:
        from .astutil import Suppressions

        try:
            with open(path, "r", encoding="utf-8", errors="replace") as fh:
                _SUPPRESS_CACHE[path] = Suppressions(fh.read())
        except OSError:
            _SUPPRESS_CACHE[path] = None
    sup = _SUPPRESS_CACHE[path]
    return sup is not None and sup.suppressed(rule, extra_lines=(line,))


def _event_reader(reader):
    """The event-time reader behind ``reader`` (through ``inner_reader``
    wrappers), or None."""
    from ..readers.aggregates import AggregateDataReader
    from ..readers.events import StreamingAggregateReader

    for _ in range(8):
        if reader is None:
            return None
        if isinstance(reader, (AggregateDataReader,
                               StreamingAggregateReader)):
            return reader
        reader = getattr(reader, "inner_reader", None)
    return None


def _lint_event_windows(dag, reader) -> Findings:
    """TM060: event-time leakage over aggregate/conditional readers.

    A raw predictor over an event reader is safe only when its events are
    provably before the key's cutoff.  Two violations: the reader
    declares no cutoff (``CutOffTime.no_cutoff`` and no target
    condition), or the predictor reads an event field a response reads
    (``event_field``, else the implicit ``r.get(name)`` of a feature
    without an extractor)."""
    findings = Findings()
    er = _event_reader(reader)
    if er is None:
        return findings
    gens = [s for layer in dag.layers for s in layer if _is_generator(s)]
    predictors = [s for s in gens if not s.get_output().is_response]
    responses = [s for s in gens if s.get_output().is_response]
    if not predictors or not responses:
        return findings

    cutoff = getattr(er, "cutoff", None)
    has_cutoff = (getattr(er, "target_condition", None) is not None
                  or (cutoff is not None and cutoff.kind != "no_cutoff"))

    def field_of(s) -> Optional[str]:
        if s.event_field is not None:
            return s.event_field
        return s.name if s.extract_fn is None else None

    response_fields = {field_of(s) for s in responses} - {None}
    for s in predictors:
        problems = []
        if not has_cutoff:
            problems.append(
                "the reader declares no cutoff (CutOffTime.no_cutoff, no "
                "target condition), so predictor events are not provably "
                "before the key's cutoff")
        fld = field_of(s)
        if fld is not None and fld in response_fields:
            problems.append(
                f"event field {fld!r} is also read by a response feature "
                "(outcome data consumed as a predictor)")
        if not problems:
            continue
        site = s.source_location
        if _suppressed_at("TM060", site):
            continue
        findings.add(
            "TM060",
            f"event-time leakage in raw feature {s.name!r}: "
            + "; ".join(problems),
            stage_uid=s.uid, location=site or _stage_location(s))
    return findings


def lint_workflow(wf, suppress: Iterable[str] = ()) -> Findings:
    """Lint an ``OpWorkflow`` (or fitted ``OpWorkflowModel``) from the DAG
    its result features reach."""
    from ..workflow.dag import compute_dag

    return lint_dag(compute_dag(wf.result_features),
                    result_features=wf.result_features, suppress=suppress,
                    reader=getattr(wf, "reader", None))
