"""Workflow engine — the user-facing train/score orchestration (counterpart
of ``transmogrifai_tpu.workflow.workflow``).

Ported: ``OpWorkflow.set_result_features / set_reader / set_input_data /
set_parameters / with_model_stages / train / compute_data_up_to`` on the
in-core path with the static DAG lint (``train(validate=True)``, the
default: ``analysis/linter.py``; errors raise ``PipelineLintError`` before
any data moves), the train-time serializability gate
(``allow_non_serializable()`` opts out) and RawFeatureFilter
(``with_raw_feature_filter``: ``filters/raw_feature_filter.py``),
``OpWorkflow.load_model`` and ``OpWorkflowModel.score / evaluate /
score_and_evaluate / get_fitted_stage / save / load``
(``workflow/persistence.py``), ``summary / summary_json /
summary_pretty`` and ``model_insights``
(``insights/model_insights.py``).  Every stage that owns a ``device``
runs on the workflow's device (``OpWorkflow(device=...)``), which
defaults to the package default (``cuda`` unless the caller asked for
the CPU).

``train(chunk_rows=k)`` is the out-of-core train
(``workflow/streaming.py``): the reader streams chunks of k rows, the
streamable estimators fit from mergeable states, RawFeatureFilter profiles
chunk by chunk, and only the kept columns (the packed feature matrix,
the response) are ever held whole; a model selector fits in-core on them.

``with_workflow_cv()`` is workflow-level CV: the DAG is cut at the
model selector (``workflow/dag.py::cut_dag_cv``), and the selector
validates with the during-DAG (the label-aware stages, such as
SanityChecker) refit inside every fold; in core, the before-DAG fits
once and the full DAG then fits with its models in place, the selector
refitting its CV winner; under ``chunk_rows=k`` the during-DAG's
estimators fold a state a fold as they stream
(``workflow/streaming_cv.py``) and the fold models come from merged fold
states, without another reader pass.

``refresh(model, data=...)`` is the warm-start refresh
(``workflow/refresh.py``): a chunked model's saved ``fit_states`` fold
in the new rows only.  ``train(profile=True)`` keeps the plan
profiler's per-stage profile on the model (``train_profile``); every
train records its stage observations in the cost history at
``TMOG_COST_HISTORY``.  ``train(tuner=Tuner(...))`` runs every model
selector under the tuner's strategy for that train, and with
``auto_plan=True`` lets the cost planner choose stream or in-core
(``tuning/``).

Not ported yet (ROADMAP Queue A): spans and the trace exporters
(6.5.5), meshes and pods (6.7).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..evaluators.evaluators import OpEvaluatorBase
from ..features.feature import Feature
from ..models.trees import clear_sweep_caches
from ..readers.base import Reader, reader_for
from ..stages.base import Model, PipelineStage
from ..stages.generator import FeatureGeneratorStage
from ..types.columns import ColumnarDataset
from ..types.feature_types import Prediction
from ..utils.profiling import (OpStep, PlanProfiler, backend_name,
                               with_job_group)
from .dag import (compute_dag, cut_dag_cv, fit_and_transform_dag,
                  transform_dag)

__all__ = ["OpWorkflow", "OpWorkflowModel"]


class _WorkflowCore:
    def __init__(self):
        self.result_features: List[Feature] = []
        self.reader: Optional[Reader] = None
        #: raw features the RawFeatureFilter dropped from the DAG
        self.blocklisted: List[str] = []
        #: per-stage params by uid or class name (``set_parameters``)
        self.parameters: Dict[str, Dict[str, Any]] = {}

    def set_reader(self, reader) -> "_WorkflowCore":
        """The data source: a ``Reader`` (or anything ``reader_for``
        takes)."""
        self.reader = reader_for(reader)
        return self

    def set_input_data(self, data) -> "_WorkflowCore":
        """Ad-hoc dataset (a ColumnarDataset or pandas DataFrame)."""
        self.reader = reader_for(data)
        return self

    def raw_features(self) -> List[Feature]:
        out: List[Feature] = []
        seen = set()
        for rf in self.result_features:
            for f in rf.raw_features():
                if f.uid not in seen:
                    seen.add(f.uid)
                    out.append(f)
        return out

    def generate_raw_data(self) -> ColumnarDataset:
        if self.reader is None:
            raise RuntimeError(
                "no reader set — call set_reader/set_input_data")
        return self.reader.generate_dataset(self.raw_features())


class OpWorkflow(_WorkflowCore):
    def __init__(self, device: DeviceLike = None):
        super().__init__()
        self.device = device
        self._allow_non_serializable = False
        self._raw_feature_filter = None
        self._model_stages: Dict[str, Model] = {}
        self._workflow_cv = False

    def allow_non_serializable(self) -> "OpWorkflow":
        """Opt out of the train-time serializability gate: train with
        callable stage params (lambda extractors) anyway; saving stubs
        them with a warning."""
        self._allow_non_serializable = True
        return self

    def load_model(self, path: str,
                   device: DeviceLike = None) -> "OpWorkflowModel":
        """A saved model (either package's), on ``device`` (else this
        workflow's, else the default device)."""
        return OpWorkflowModel.load(
            path, device=device if device is not None else self.device)

    def set_result_features(self, *features: Feature) -> "OpWorkflow":
        self.result_features = list(features)
        return self

    def set_parameters(self, params: Dict[str, Dict[str, Any]]
                       ) -> "OpWorkflow":
        """Stage params to set at ``train()``, keyed by stage uid or class
        name (OpWorkflow.setStageParameters); an unknown param name
        raises there."""
        self.parameters = dict(params)
        return self

    def with_model_stages(self, model: "OpWorkflowModel") -> "OpWorkflow":
        """Warm start: ``train()`` takes ``model``'s fitted models for the
        estimators of the same uids instead of fitting them."""
        for s in model.stages:
            if isinstance(s, Model):
                self._model_stages[s.uid] = s
        return self

    def _inject_params(self, dag) -> None:
        for stage in dag.all_stages():
            for key in (stage.uid, type(stage).__name__):
                if key in self.parameters:
                    stage.set_params(**self.parameters[key])

    def compute_data_up_to(self, feature: Feature,
                           data=None) -> ColumnarDataset:
        """The dataset with every feature up to ``feature`` computed, the
        estimators below it fitted (OpWorkflow.computeDataUpTo)."""
        if data is not None:
            self.set_input_data(data)
        raw = self.generate_raw_data()
        dag = compute_dag([feature])
        placed = self._place(dag, resolve_device(self.device))
        try:
            _, transformed = fit_and_transform_dag(dag, raw)
        finally:
            for s in placed:
                s.device = None
            clear_sweep_caches()
        return transformed

    @staticmethod
    def _place(dag, dev: torch.device) -> List[PipelineStage]:
        """Put every stage that owns an unset ``device`` on ``dev``; the
        stages placed, for the caller to reset."""
        placed = [s for s in dag.all_stages()
                  if hasattr(s, "device") and s.device is None]
        for s in placed:
            s.device = str(dev)
        return placed

    def with_workflow_cv(self) -> "OpWorkflow":
        """Refit the label-aware feature engineering inside every CV fold
        of the model selector (OpWorkflow.withWorkflowCV)."""
        self._workflow_cv = True
        return self

    def _workflow_cv_models(self, dag, data: ColumnarDataset,
                            substitutes: Dict[str, Model]
                            ) -> Dict[str, Model]:
        """The workflow-CV step: fit the before-DAG once, let the selector
        find its winner with the during-DAG refit in every fold, and
        return the before-DAG's models by uid (none where the DAG has no
        selector or nothing to refit)."""
        cut = cut_dag_cv(dag)
        if cut.selector is None or not cut.during.layers:
            return {}
        before_fitted, before_data = fit_and_transform_dag(
            cut.before, data, fitted_substitutes=substitutes)
        cut.selector.find_best_estimator(before_data, cut.during)
        return {m.uid: m for m in before_fitted if isinstance(m, Model)}

    def with_mesh(self, mesh) -> "OpWorkflow":
        raise NotImplementedError(
            "multi-device trains are not ported yet (ROADMAP Queue A item "
            "6.7: meshes and pods)")

    def with_raw_feature_filter(self, **kwargs) -> "OpWorkflow":
        """Profile the raw features before the DAG runs and drop the ones
        that fail RawFeatureFilter's checks (``kwargs`` are its
        constructor's)."""
        from ..filters.raw_feature_filter import RawFeatureFilter

        self._raw_feature_filter = RawFeatureFilter(**kwargs)
        return self

    def _apply_blocklist(self, dropped: Sequence[str]) -> None:
        """Prune dropped raw features out of stage inputs: a variadic stage
        loses the input; a stage whose inputs all drop propagates the
        drop; a result feature that becomes unreachable is an error."""
        if not dropped:
            return
        self.blocklisted = list(dropped)
        gone = set(dropped)
        for layer in compute_dag(self.result_features).layers:
            for stage in layer:
                if isinstance(stage, FeatureGeneratorStage):
                    continue
                remaining = [f for f in stage.input_features
                             if f.name not in gone]
                if len(remaining) == len(stage.input_features):
                    continue
                lo, _ = stage.input_arity
                out = stage.get_output()
                if remaining and len(remaining) >= max(lo, 1):
                    stage.input_features = remaining
                    out.parents = list(remaining)
                else:
                    gone.add(out.name)
        bad = [f.name for f in self.result_features if f.name in gone]
        if bad:
            raise ValueError(
                f"RawFeatureFilter dropped features required by result "
                f"features {bad}; protect them via protected_features")

    def _lint_dag(self, dag):
        """The ``train(validate=True)`` gate: errors raise
        ``PipelineLintError``; the findings come back with the lint's wall
        seconds."""
        from ..analysis.diagnostics import PipelineLintError
        from ..analysis.linter import lint_dag

        t0 = time.perf_counter()
        findings = lint_dag(dag, result_features=self.result_features,
                            reader=self.reader)
        wall = time.perf_counter() - t0
        if findings.errors:
            raise PipelineLintError(findings)
        return findings, wall

    def train(self, profile: bool = False, chunk_rows: Optional[int] = None,
              prefetch_chunks: int = 2, validate: bool = True,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every_chunks: int = 16,
              tuner=None) -> "OpWorkflowModel":
        """Fit every stage of the DAG in layer order on the input data.

        ``validate=True`` (the default) lints the DAG first
        (``analysis/linter.py``): error-severity findings raise
        ``PipelineLintError`` before any data is read; the warnings land on
        the model's ``lint_snapshot`` with the lint's wall seconds.  With a
        RawFeatureFilter (``with_raw_feature_filter``) the raw data is
        profiled next, the dropped features leave the DAG, and the pruned
        DAG is linted again (the snapshot is that lint's, as in the JAX
        package, which lints after the filter).

        ``chunk_rows=k`` trains out-of-core (``workflow/streaming.py``),
        the reader parsing up to ``prefetch_chunks`` chunks ahead on a
        host thread; the model then carries ``ingest_profile`` (its
        ``rff``: the filter's chunked pass) and ``fit_states`` (each
        streamed estimator's final state, saved with the model: what
        ``refresh`` resumes from).  ``chunk_rows=None`` is the in-core
        train.  With ``with_workflow_cv()`` a chunked train validates on
        fold states (``workflow/streaming_cv.py``).

        ``profile=True`` keeps the plan profiler on the model as
        ``train_profile`` (``.format()``, ``.to_json()``): each stage's
        wall, rows, input width and, run serially, its kernel launches.
        A profiler runs on every train, and its observations go to the
        cost history at ``TMOG_COST_HISTORY`` where that names a file.

        ``tuner`` (``tuning.Tuner``) sets its ``strategy`` (and
        ``halving``) on every model selector for this train, restoring
        theirs after it; with ``auto_plan=True``, no ``chunk_rows`` and a
        reader that can estimate its rows, the cost planner chooses
        stream or in-core and the chunk geometry.

        ``checkpoint_dir`` makes the train resumable.  Chunked: the fit
        passes checkpoint every ``checkpoint_every_chunks`` chunks and at
        their ends (``workflow/checkpoint.py``), and every model selector
        without a sweep checkpoint of its own keeps its sweep's under
        ``checkpoint_dir/sweep``; a rerun in the same directory resumes
        (``ingest_profile.resumed``).  In-core: every model selector keeps
        its sweep's checkpoint in ``checkpoint_dir``; a DAG without one
        raises ``ValueError``.  A checkpoint of another run (other data,
        DAG, chunk size or CV folds) raises ``CheckpointMismatchError``.
        Success removes the checkpoint.

        The returned model's ``stage_seconds`` maps each stage's class name
        to its fit+transform wall seconds (synchronised with the device;
        out-of-core, a prefix stage's host seconds over every pass).  The
        tree fits' sweep memo is cleared at its end."""
        if (tuner is not None and tuner.auto_plan and chunk_rows is None
                and self.reader is not None):
            advice = self._plan_advice(tuner)
            if advice is not None and advice.mode == "stream":
                # advice.retain_mb is a host budget: the port's retained
                # blocks are device memory and keep TMOG_STREAM_RETAIN_MB;
                # the number waits for the mesh's block store (ROADMAP
                # Queue A item 6.7)
                chunk_rows = advice.chunk_rows
                prefetch_chunks = advice.prefetch_chunks
        routed = []
        if checkpoint_dir is not None:
            from ..selector.model_selector import ModelSelector

            sels = [s for s in compute_dag(self.result_features).all_stages()
                    if isinstance(s, ModelSelector)]
            if chunk_rows is None and not sels:
                raise ValueError(
                    "checkpoint_dir requires the out-of-core path — pass "
                    "chunk_rows=k as well (the in-core fit only "
                    "checkpoints ModelSelector sweeps, and this DAG has "
                    "none)")
            for s in sels:
                if chunk_rows is None:
                    routed.append((s, s.sweep_checkpoint_dir))
                    s.sweep_checkpoint_dir = checkpoint_dir
                elif s.sweep_checkpoint_dir is None:
                    routed.append((s, None))
                    s.sweep_checkpoint_dir = os.path.join(checkpoint_dir,
                                                          "sweep")
        tuned = self._apply_tuner(tuner)
        try:
            return self._train(chunk_rows, prefetch_chunks, validate,
                               checkpoint_dir, checkpoint_every_chunks,
                               profile)
        finally:
            for s, d in routed:
                s.sweep_checkpoint_dir = d
            for s, strategy, halving in tuned:
                s.strategy, s.halving = strategy, halving

    def _plan_advice(self, tuner):
        """The cost planner's advice for an ``auto_plan`` train, or None
        where the reader cannot estimate its rows."""
        rows = self.reader.estimate_rows()
        if not rows:
            return None
        from ..tuning.planner import advise_plan

        return advise_plan(rows, max(len(self.raw_features()), 1),
                           cost_model=tuner.resolved_cost_model(),
                           host_budget_bytes=tuner.host_budget_bytes,
                           backend=backend_name(self.device))

    def _apply_tuner(self, tuner) -> list:
        """Set the tuner's strategy (and halving) on every model selector
        for this train: (stage, its strategy, its halving) records for
        the caller to restore."""
        if tuner is None:
            return []
        from ..selector.model_selector import ModelSelector

        tuned = []
        for s in compute_dag(self.result_features).all_stages():
            if isinstance(s, ModelSelector):
                tuned.append((s, s.strategy, s.halving))
                s.strategy = tuner.strategy
                if tuner.halving is not None:
                    s.halving = tuner.halving
        return tuned

    def _streaming_cv_context(self, dag):
        """The fold-tagged CV context of a chunked train or refresh, or
        None where workflow CV is off (or the DAG has no CV cut).  A
        during-DAG estimator that cannot stream raises, naming it."""
        if not self._workflow_cv:
            return None
        from ..stages.base import Estimator
        from .streaming_cv import StreamingCVContext

        cut = cut_dag_cv(dag)
        if cut.selector is None or not cut.during.layers:
            return None
        for s in cut.during.all_stages():
            if (isinstance(s, Estimator) and s.uid not in self._model_stages
                    and not s.supports_streaming_fit):
                raise ValueError(
                    f"chunk_rows with workflow-level CV requires every "
                    f"fold-refit (during-DAG) estimator to support "
                    f"streaming fit; stage {s.uid} ({type(s).__name__}) "
                    f"does not — fit it in-core or make its state a "
                    f"mergeable monoid (stages/base.py streaming-fit "
                    f"protocol)")
        return StreamingCVContext(cut.selector, cut.during,
                                  dict(self._model_stages))

    @staticmethod
    def _stage_timer(dev: torch.device):
        """(a {class name: seconds} dict, the ``on_stage`` callback that
        fills it, synchronising with the card)."""
        seconds: Dict[str, float] = {}

        def on_stage(stage: PipelineStage, dt: float) -> None:
            if dev.type == "cuda":
                t0 = time.perf_counter()
                torch.cuda.synchronize(dev)
                dt += time.perf_counter() - t0
            name = type(stage).__name__
            seconds[name] = seconds.get(name, 0.0) + dt

        return seconds, on_stage

    def _train(self, chunk_rows: Optional[int], prefetch_chunks: int,
               validate: bool, checkpoint_dir: Optional[str],
               checkpoint_every: int, profile: bool) -> "OpWorkflowModel":
        """``train``'s body, with the selectors' sweep checkpoints routed
        and the tuner applied."""
        dev = resolve_device(self.device)
        lint = (self._lint_dag(compute_dag(self.result_features))
                if validate else None)
        if self.reader is None:
            raise RuntimeError(
                "no reader set — call set_reader/set_input_data")
        with with_job_group(OpStep.DataReadingAndFiltering):
            data = (None if chunk_rows is not None
                    else self.generate_raw_data())
        filter_results = rff_stats = chunk_filter = None
        rff_seconds = None
        if self._raw_feature_filter is not None:
            rff = self._raw_feature_filter
            t0 = time.perf_counter()
            with with_job_group(OpStep.DataReadingAndFiltering):
                if chunk_rows is None:
                    data, filter_results = rff.filter_raw_data(
                        data, self.raw_features(), device=dev)
                else:
                    filter_results, rff_stats = rff.filter_streaming(
                        self.reader, self.raw_features(), chunk_rows,
                        device=dev)
                if filter_results.dropped_map_keys:
                    dropped = list(filter_results.dropped_features)
                    keys = dict(filter_results.dropped_map_keys)
                    chunk_filter = (lambda ds: rff.clean_chunk(ds, dropped,
                                                               keys))
            rff_seconds = time.perf_counter() - t0
            self._apply_blocklist(filter_results.dropped_features)
            if validate and filter_results.dropped_features:
                findings, wall = self._lint_dag(
                    compute_dag(self.result_features))
                lint = (findings, lint[1] + wall)
        dag = self._prepared_dag()
        seconds, on_stage = self._stage_timer(dev)
        # a profiler runs on every train (its stage observations feed the
        # cost history); it lands on the model only when asked for
        profiler = PlanProfiler()
        placed = self._place(dag, dev)
        ingest = fit_states = None
        substitutes = dict(self._model_stages)
        try:
            if self._workflow_cv and chunk_rows is None:
                with with_job_group(OpStep.CrossValidation):
                    substitutes.update(
                        self._workflow_cv_models(dag, data, substitutes))
            with with_job_group(OpStep.FeatureEngineering):
                if chunk_rows is None:
                    fitted, transformed = fit_and_transform_dag(
                        dag, data, on_stage=on_stage,
                        fitted_substitutes=substitutes, profiler=profiler)
                else:
                    from .streaming import fit_dag_streaming

                    cv_ctx = self._streaming_cv_context(dag)
                    fitted, transformed, ingest, fit_states = \
                        fit_dag_streaming(
                            dag, self.reader, self.raw_features(),
                            chunk_rows, keep=self._train_keep_columns(),
                            fitted_substitutes=self._model_stages,
                            prefetch=prefetch_chunks,
                            chunk_filter=chunk_filter, on_stage=on_stage,
                            checkpoint_dir=checkpoint_dir,
                            checkpoint_every=checkpoint_every, device=dev,
                            profiler=profiler, cv_ctx=cv_ctx,
                            fingerprint_extra=(cv_ctx.fingerprint()
                                               if cv_ctx is not None
                                               else None))
                    ingest.rff = rff_stats
        finally:
            for s in placed:
                s.device = None
            # the sweep memo's sketches and binned matrices live no
            # longer than the train
            clear_sweep_caches()
        model = OpWorkflowModel(self.result_features, fitted, transformed)
        model.reader = self.reader
        model.stage_seconds = seconds
        model.blocklisted = list(self.blocklisted)
        model.raw_feature_filter_results = filter_results
        model.raw_feature_filter_seconds = rff_seconds
        model.ingest_profile = ingest
        model.fit_states = fit_states
        if lint is not None:
            from ..analysis.diagnostics import LintSnapshot

            model.lint_snapshot = profiler.lint = \
                LintSnapshot.from_findings(*lint)
        model.train_profile = profiler if profile else None
        from ..tuning.costmodel import record_train_observations

        record_train_observations(profiler)
        return model

    def refresh(self, model: "OpWorkflowModel", data=None,
                chunk_rows: int = 512, prefetch_chunks: int = 2,
                profile: bool = False, checkpoint_dir: Optional[str] = None,
                checkpoint_every_chunks: int = 16) -> "OpWorkflowModel":
        """Warm-start refresh: fit ``model`` further on new data only.

        Every streamable estimator whose exported state rides on
        ``model`` (``fit_states``: chunked trains and refreshes keep
        them) resumes from that state and folds in the new chunks, so the
        result matches a streaming train over old and new rows within
        each stage's ``streaming_fit_tol`` while reading only the new
        window.  Estimators without a state, or whose upstream geometry
        changed (a vocabulary's set, a keep decision;
        ``workflow/refresh.py``), refit on the new data alone, and the
        tail that cannot stream refits in core on the window; the
        returned model's ``refresh_report`` says which path each took.

        ``data`` defaults to this workflow's reader.  A RawFeatureFilter
        reuses the base model's recorded decisions (a trained model's
        results or a loaded model's JSON form; profiling again would
        change the geometry under the restored states).  Workflow CV
        validates again on the window.  ``checkpoint_dir`` checkpoints as
        a chunked train does, with the base model in the fingerprint: a
        killed refresh resumes, and its checkpoint never resumes into a
        plain train or a refresh of another model.  The refreshed model
        carries its merged ``fit_states``, so refreshes chain."""
        from .refresh import RefreshContext
        from .streaming import fit_dag_streaming

        if data is not None:
            self.set_input_data(data)
        if self.reader is None:
            raise RuntimeError(
                "no refresh data — pass data= or set a reader")
        dev = resolve_device(self.device)
        filter_results = chunk_filter = None
        if self._raw_feature_filter is not None:
            filter_results = getattr(model, "raw_feature_filter_results",
                                     None)
            if filter_results is None:
                raise ValueError(
                    "refresh with RawFeatureFilter requires the base "
                    "model's recorded filter results "
                    "(model.raw_feature_filter_results — train with the "
                    "filter first); re-profiling inside a refresh would "
                    "change the feature geometry under the warm-started "
                    "states")
            if isinstance(filter_results, dict):     # a loaded model's
                dropped = list(filter_results.get("droppedFeatures", []))
                keys = dict(filter_results.get("droppedMapKeys") or {})
            else:
                dropped = list(filter_results.dropped_features)
                keys = dict(filter_results.dropped_map_keys)
            self._apply_blocklist(dropped)
            if keys:
                rff = self._raw_feature_filter
                chunk_filter = (lambda ds: rff.clean_chunk(ds, dropped,
                                                           keys))
        dag = self._prepared_dag()
        lint = self._lint_dag(dag)
        cv_ctx = self._streaming_cv_context(dag)
        ctx = RefreshContext(model, dag)
        fingerprint_extra = ctx.base_digest()
        if cv_ctx is not None:
            fingerprint_extra = {**fingerprint_extra, **cv_ctx.fingerprint()}
        seconds, on_stage = self._stage_timer(dev)
        profiler = PlanProfiler()
        placed = self._place(dag, dev)
        try:
            with with_job_group(OpStep.FeatureEngineering):
                fitted, transformed, ingest, fit_states = fit_dag_streaming(
                    dag, self.reader, self.raw_features(), chunk_rows,
                    keep=self._train_keep_columns(), prefetch=prefetch_chunks,
                    chunk_filter=chunk_filter, on_stage=on_stage,
                    checkpoint_dir=checkpoint_dir,
                    checkpoint_every=checkpoint_every_chunks, device=dev,
                    profiler=profiler, refresh_ctx=ctx,
                    fingerprint_extra=fingerprint_extra, cv_ctx=cv_ctx)
        finally:
            for s in placed:
                s.device = None
            clear_sweep_caches()
        refreshed = OpWorkflowModel(self.result_features, fitted, transformed)
        refreshed.reader = self.reader
        refreshed.stage_seconds = seconds
        refreshed.blocklisted = list(self.blocklisted)
        refreshed.raw_feature_filter_results = filter_results
        refreshed.ingest_profile = ingest
        refreshed.fit_states = fit_states
        refreshed.refresh_report = ctx.report.to_json()
        from ..analysis.diagnostics import LintSnapshot

        refreshed.lint_snapshot = profiler.lint = \
            LintSnapshot.from_findings(*lint)
        refreshed.train_profile = profiler if profile else None
        from ..tuning.costmodel import record_train_observations

        record_train_observations(profiler)
        return refreshed

    def _prepared_dag(self):
        """The DAG of the result features, its stage uids distinct, the
        stage parameters set and (unless ``allow_non_serializable``) every
        stage checked to be serializable."""
        dag = compute_dag(self.result_features)
        seen = set()
        for s in dag.all_stages():
            if s.uid in seen:
                raise ValueError(f"duplicate stage uid {s.uid}")
            seen.add(s.uid)
        self._inject_params(dag)
        if not self._allow_non_serializable:
            from .persistence import check_serializable

            check_serializable(dag.all_stages())
        return dag

    def _train_keep_columns(self) -> List[str]:
        """The columns an out-of-core train keeps whole: the result
        features, the response and the result stages' direct inputs."""
        keep = {f.name for f in self.result_features}
        keep |= {f.name for f in self.raw_features() if f.is_response}
        for f in self.result_features:
            if f.origin_stage is not None:
                keep |= {ff.name for ff in f.origin_stage.input_features}
        return sorted(keep)




class OpWorkflowModel(_WorkflowCore):
    def __init__(self, result_features: Sequence[Feature],
                 stages: Sequence[PipelineStage],
                 train_data: Optional[ColumnarDataset] = None):
        super().__init__()
        self.result_features = list(result_features)
        self.stages = list(stages)
        self.train_data = train_data
        self.stage_seconds: Dict[str, float] = {}
        #: ``RawFeatureFilterResults`` of the train (a loaded model: its
        #: JSON form), else None
        self.raw_feature_filter_results = None
        #: the filter's wall seconds in ``train()``, else None
        self.raw_feature_filter_seconds: Optional[float] = None
        #: ``LintSnapshot`` from ``OpWorkflow.train(validate=True)``
        self.lint_snapshot = None
        #: ``IngestProfiler`` of an out-of-core train, else None
        self.ingest_profile = None
        #: each streamed estimator's exported final state by uid (chunked
        #: trains and refreshes; saved with the model): what a refresh
        #: resumes from
        self.fit_states = None
        #: the ``PlanProfiler`` of ``train(profile=True)``, else None
        self.train_profile = None
        #: the ``RefreshReport`` JSON of a model made by ``refresh``
        self.refresh_report: Optional[Dict[str, Any]] = None
        self._scoring_dag_memo = None

    def _scoring_dag(self):
        """The DAG over the fitted stages, built once (scoring, saving and
        every serving registry entry share it)."""
        if self._scoring_dag_memo is None:
            stage_map = {s.uid: s for s in self.stages}
            self._scoring_dag_memo = compute_dag(
                [f.copy_with_new_stages(stage_map)
                 for f in self.result_features])
        return self._scoring_dag_memo

    def score(self, data=None, keep_raw_features: bool = False,
              keep_intermediate_features: bool = False) -> ColumnarDataset:
        """Apply the fitted DAG; returns the responses and result features
        (with ``keep_raw_features`` the raw features first; with
        ``keep_intermediate_features`` every column is kept, no
        intermediate dropped after its last consumer)."""
        if data is not None:
            self.set_input_data(data)
        responses = [f.name for f in self.raw_features() if f.is_response]
        results = [f.name for f in self.result_features]
        plan_keep = None
        if not keep_intermediate_features:
            plan_keep = set(responses) | set(results)
            if keep_raw_features:
                plan_keep |= {f.name for f in self.raw_features()}
        scored = transform_dag(self._scoring_dag(), self.generate_raw_data(),
                               keep=sorted(plan_keep)
                               if plan_keep is not None else None)
        if keep_raw_features and keep_intermediate_features:
            return scored
        keep = results
        if keep_raw_features:
            keep = [f.name for f in self.raw_features()] + keep
        keep = responses + [k for k in keep if k not in responses]
        return scored.select([k for k in dict.fromkeys(keep) if k in scored])

    def evaluate(self, evaluator: OpEvaluatorBase, data=None,
                 scored: Optional[ColumnarDataset] = None) -> Dict[str, float]:
        if scored is None:
            scored = self.score(data)
        evaluator.label_col = evaluator.label_col or next(
            (f.name for f in self.raw_features() if f.is_response), None)
        evaluator.prediction_col = evaluator.prediction_col or next(
            (f.name for f in self.result_features
             if issubclass(f.ftype, Prediction) and f.name in scored), None)
        return evaluator.evaluate(scored)

    def score_and_evaluate(self, evaluator: OpEvaluatorBase, data=None):
        scored = self.score(data)
        return scored, self.evaluate(evaluator, scored=scored)

    def get_fitted_stage(self, uid_or_name: str) -> PipelineStage:
        """The fitted stage of that uid, else the first of that class
        name; KeyError if none."""
        for s in self.stages:
            if s.uid == uid_or_name or type(s).__name__ == uid_or_name:
                return s
        raise KeyError(uid_or_name)

    def summary(self) -> Dict[str, Any]:
        """Every fitted stage's metadata, by stage uid."""
        return {s.uid: _jsonable(s.metadata) for s in self.stages
                if s.metadata}

    def summary_json(self) -> str:
        return json.dumps(self.summary(), indent=2, default=str)

    def summary_pretty(self) -> str:
        """The training summary as the JAX package prints it: the
        selector's candidates (the first 20), winner and holdout metrics,
        and the columns the sanity checker dropped (the first 10)."""
        lines: List[str] = []
        for s in self.stages:
            summ = s.metadata.get("model_selector_summary")
            if summ:
                lines.append("Evaluated models:")
                for row in summ.get("validationResults", [])[:20]:
                    lines.append(
                        f"  {row['modelType']} {row['params']} -> "
                        f"{row['metricName']}={row['metricValue']:.4f}")
                lines.append(
                    f"Best model: {summ.get('bestModelType')} "
                    f"{summ.get('bestModelParams')}")
                hold = summ.get("holdoutMetrics")
                if hold:
                    lines.append("Holdout metrics: " + json.dumps(hold))
            sc = s.metadata.get("summary")
            if sc and "dropped" in sc:
                lines.append(
                    f"SanityChecker dropped {len(sc['dropped'])} columns: "
                    f"{sc['dropped'][:10]}")
        return "\n".join(lines) if lines else "(no fitted summaries)"

    def model_insights(self, feature: Optional[Feature] = None):
        """One merged document of the trained workflow: the label summary,
        each raw feature's derived columns with their contributions and
        SanityChecker statistics, the selector's summary and the
        RawFeatureFilter results (``insights/model_insights.py``)."""
        from ..insights.model_insights import extract_model_insights

        return extract_model_insights(self, feature)

    def save(self, path: str, overwrite: bool = True) -> None:
        """Write the model in the format both packages read
        (``workflow/persistence.py``)."""
        from .persistence import save_workflow_model

        save_workflow_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "OpWorkflowModel":
        """Load a saved model (either package's) with its tensors on
        ``device`` (else the default device)."""
        from .persistence import load_workflow_model

        return load_workflow_model(path, device=device)


def _jsonable(obj):
    """``obj`` where JSON takes it as is, else its dicts and lists walked,
    arrays as lists and anything else as its string."""
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        if isinstance(obj, dict):
            return {k: _jsonable(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [_jsonable(v) for v in obj]
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, torch.Tensor):
            return obj.cpu().tolist()
        return str(obj)
