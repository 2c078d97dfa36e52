"""Production entry points — run-mode dispatch and app bootstrap
(counterpart of ``transmogrifai_tpu.workflow.runner``).

Reference: ``OpWorkflowRunner`` (core/.../OpWorkflowRunner.scala — run modes
Train/Score/StreamingScore/Features/Evaluate :70,163-296,358-365; config
``OpWorkflowRunnerConfig`` :379; app-end metrics handlers :145), ``OpParams``
(features/.../op/OpParams.scala:81-97), ``OpApp`` bootstrap (OpApp.scala:49-213).

There is no Spark session to bootstrap: ``OpApp`` is a thin argparse
CLI; streaming score overlaps the host's parse of batch k+1 with the
card's scoring of batch k through ``AsyncBatcher``.  Scores and features
are written as CSV with the ``csv`` module (no pandas): a cell holds the
value as pandas' ``to_csv`` writes it (a prediction its dict, a missing
value nothing).  ``custom_params.profile`` needs the plan profiler
(ROADMAP Queue A item 6.5) and raises there.
"""
from __future__ import annotations

import argparse
import csv
import enum
import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..evaluators.evaluators import OpEvaluatorBase
from ..readers.streaming import AsyncBatcher, StreamingReader
from ..utils.profiling import (AppMetrics, MetricsCollector, OpStep,
                               install_collector, with_job_group)
from .workflow import OpWorkflow, OpWorkflowModel

__all__ = ["RunType", "OpParams", "OpWorkflowRunner",
           "OpWorkflowRunnerResult", "OpApp", "write_csv"]


class RunType(enum.Enum):
    Train = "train"
    Score = "score"
    StreamingScore = "streamingScore"
    Features = "features"
    Evaluate = "evaluate"


@dataclass
class OpParams:
    """JSON/YAML-loadable run configuration (OpParams.scala:81-97 parity)."""

    stage_params: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    reader_params: Dict[str, Any] = field(default_factory=dict)
    model_location: Optional[str] = None
    write_location: Optional[str] = None
    metrics_location: Optional[str] = None
    custom_params: Dict[str, Any] = field(default_factory=dict)
    custom_tag_name: Optional[str] = None
    custom_tag_value: Optional[str] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OpParams":
        snake = {"stageParams": "stage_params", "readerParams": "reader_params",
                 "modelLocation": "model_location",
                 "writeLocation": "write_location",
                 "metricsLocation": "metrics_location",
                 "customParams": "custom_params",
                 "customTagName": "custom_tag_name",
                 "customTagValue": "custom_tag_value"}
        kwargs = {snake.get(k, k): v for k, v in d.items()}
        return cls(**kwargs)

    @classmethod
    def from_file(cls, path: str) -> "OpParams":
        with open(path) as fh:
            text = fh.read()
        if path.endswith((".yaml", ".yml")):
            try:
                import yaml
                return cls.from_dict(yaml.safe_load(text))
            except ImportError as e:  # pragma: no cover
                raise RuntimeError("pyyaml unavailable; use JSON params") from e
        return cls.from_dict(json.loads(text))

    def to_json(self) -> Dict[str, Any]:
        return {"stageParams": self.stage_params,
                "readerParams": self.reader_params,
                "modelLocation": self.model_location,
                "writeLocation": self.write_location,
                "metricsLocation": self.metrics_location,
                "customParams": self.custom_params}


@dataclass
class OpWorkflowRunnerResult:
    run_type: str
    metrics: Optional[Dict[str, Any]] = None
    summary: Optional[Dict[str, Any]] = None
    scores_location: Optional[str] = None
    n_batches: int = 0
    n_rows: int = 0
    app_metrics: Optional[AppMetrics] = None


class OpWorkflowRunner:
    """Dispatches a workflow through one of the five run modes."""

    def __init__(self,
                 workflow: OpWorkflow,
                 train_reader=None,
                 score_reader=None,
                 streaming_score_reader: Optional[StreamingReader] = None,
                 evaluation_reader=None,
                 evaluator: Optional[OpEvaluatorBase] = None,
                 scoring_evaluator: Optional[OpEvaluatorBase] = None,
                 features_to_compute: Sequence = ()):
        self.workflow = workflow
        self.train_reader = train_reader
        self.score_reader = score_reader
        self.streaming_score_reader = streaming_score_reader
        self.evaluation_reader = evaluation_reader
        self.evaluator = evaluator
        self.scoring_evaluator = scoring_evaluator
        self.features_to_compute = list(features_to_compute)
        self._end_handlers: List[Callable[[AppMetrics], None]] = []

    def add_application_end_handler(
            self, fn: Callable[[AppMetrics], None]) -> None:
        """Called with the run's AppMetrics when run() completes
        (OpWorkflowRunner.scala:145)."""
        self._end_handlers.append(fn)

    # -- dispatch ------------------------------------------------------------

    def run(self, run_type: RunType, params: Optional[OpParams] = None
            ) -> OpWorkflowRunnerResult:
        params = params or OpParams()
        collector = MetricsCollector(run_type=run_type.value)
        for fn in self._end_handlers:
            collector.add_application_end_handler(fn)
        if params.custom_tag_name:
            collector.metrics.custom_tags[params.custom_tag_name] = (
                params.custom_tag_value or "")
        if params.stage_params:
            self.workflow.set_parameters(params.stage_params)
        dispatch = {RunType.Train: self._train,
                    RunType.Score: self._score,
                    RunType.StreamingScore: self._streaming_score,
                    RunType.Features: self._features,
                    RunType.Evaluate: self._evaluate}
        with install_collector(collector):
            result = dispatch[run_type](params)
        result.app_metrics = collector.finish()
        self._write_metrics(params, result)
        return result

    # -- modes ---------------------------------------------------------------

    def _train(self, params: OpParams) -> OpWorkflowRunnerResult:
        if self.train_reader is not None:
            self.workflow.set_reader(self.train_reader)
        # custom_params.profile=true turns on the execution plan's per-stage
        # profile; it rides along in the train summary (and thence the
        # metrics_location JSON) as "executionProfile".
        # custom_params.chunk_rows=k selects the out-of-core chunked train
        # (workflow/streaming.py); its pass counters ride along as
        # "ingestProfile".
        profile = bool(params.custom_params.get("profile"))
        chunk_rows = params.custom_params.get("chunk_rows")
        model = self.workflow.train(
            profile=profile,
            chunk_rows=int(chunk_rows) if chunk_rows else None)
        if params.model_location:
            with with_job_group(OpStep.ModelIO):
                model.save(params.model_location)
        summary = model.summary()
        if profile and model.train_profile is not None:
            summary["executionProfile"] = model.train_profile.to_json()
        if model.ingest_profile is not None:
            summary["ingestProfile"] = model.ingest_profile.to_json()
        return OpWorkflowRunnerResult(run_type="train", summary=summary)

    def _load_model(self, params: OpParams) -> OpWorkflowModel:
        if not params.model_location:
            raise ValueError("model_location required")
        with with_job_group(OpStep.ModelIO):
            return OpWorkflowModel.load(params.model_location)

    def _write_scores(self, scored, params: OpParams,
                      suffix: str = "") -> Optional[str]:
        if not params.write_location:
            return None
        with with_job_group(OpStep.ResultsSaving):
            os.makedirs(params.write_location, exist_ok=True)
            path = os.path.join(params.write_location, f"scores{suffix}.csv")
            write_csv(scored, path)
        return path

    def _score(self, params: OpParams) -> OpWorkflowRunnerResult:
        model = self._load_model(params)
        if self.score_reader is not None:
            model.set_reader(self.score_reader)
        with with_job_group(OpStep.Scoring):
            scored = model.score()
            metrics = None
            if self.scoring_evaluator is not None:
                metrics = model.evaluate(self.scoring_evaluator, scored=scored)
        path = self._write_scores(scored, params)
        return OpWorkflowRunnerResult(run_type="score", metrics=metrics,
                                      scores_location=path,
                                      n_rows=len(scored))

    def _streaming_score(self, params: OpParams) -> OpWorkflowRunnerResult:
        if self.streaming_score_reader is None:
            raise ValueError("streamingScore requires a streaming score reader")
        model = self._load_model(params)
        raw = model.raw_features()
        # prefetch thread columnarizes batch k+1 while the device scores k
        batches = AsyncBatcher(
            self.streaming_score_reader.stream(raw))
        n_batches = n_rows = 0
        path = None
        try:
            for batch in batches:
                with with_job_group(OpStep.Scoring):
                    scored = model.score(data=batch)
                p = self._write_scores(scored, params,
                                       suffix=f"_{n_batches:05d}")
                path = path or (params.write_location if p else None)
                n_batches += 1
                n_rows += len(scored)
        finally:
            batches.close()  # releases the pump thread on scoring errors
        return OpWorkflowRunnerResult(run_type="streamingScore",
                                      scores_location=path,
                                      n_batches=n_batches, n_rows=n_rows)

    def _features(self, params: OpParams) -> OpWorkflowRunnerResult:
        if self.train_reader is not None:
            self.workflow.set_reader(self.train_reader)
        if self.features_to_compute:
            data = self.workflow.compute_data_up_to(
                self.features_to_compute[-1])
        else:
            with with_job_group(OpStep.DataReadingAndFiltering):
                data = self.workflow.generate_raw_data()
        path = self._write_scores(data, params)
        return OpWorkflowRunnerResult(run_type="features",
                                      scores_location=path, n_rows=len(data))

    def _evaluate(self, params: OpParams) -> OpWorkflowRunnerResult:
        if self.evaluator is None:
            raise ValueError("evaluate requires an evaluator")
        model = self._load_model(params)
        if self.evaluation_reader is not None:
            model.set_reader(self.evaluation_reader)
        with with_job_group(OpStep.Scoring):
            scored, metrics = model.score_and_evaluate(self.evaluator)
        path = self._write_scores(scored, params)
        return OpWorkflowRunnerResult(run_type="evaluate", metrics=metrics,
                                      scores_location=path,
                                      n_rows=len(scored))

    def _write_metrics(self, params: OpParams,
                       result: OpWorkflowRunnerResult) -> None:
        if not params.metrics_location:
            return
        os.makedirs(params.metrics_location, exist_ok=True)
        out = {"runType": result.run_type, "metrics": result.metrics,
               "app": result.app_metrics.to_json()
               if result.app_metrics else None}
        path = os.path.join(params.metrics_location, "op_metrics.json")
        from ..utils.jsonio import write_json_atomic

        write_json_atomic(path, out, indent=2)  # tmp + os.replace (TM050)


def _cells(col) -> list:
    vals = col.values
    if hasattr(vals, "rows"):          # a prediction batch
        return vals.rows()
    return col.to_list()


def _csv_cell(v: Any) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    if isinstance(v, float):
        return repr(v)
    return str(v)


def write_csv(data, path: str) -> None:
    """``data``'s columns as a CSV with a header, as pandas' ``to_csv``
    writes ``to_pandas()`` (a prediction cell holds its dict's text)."""
    names = data.names()
    cols = [_cells(data[n]) for n in names]
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(names)
        for row in zip(*cols):
            w.writerow([_csv_cell(v) for v in row])


class OpApp:
    """Abstract application bootstrap (OpApp.scala:49-213 parity): subclass,
    implement ``runner()``, then ``MyApp().main(argv)``."""

    app_name = "transmogrifai_tpu_app"

    def runner(self) -> OpWorkflowRunner:
        raise NotImplementedError

    def parser(self) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(self.app_name)
        p.add_argument("--run-type", required=True,
                       choices=[r.value for r in RunType])
        p.add_argument("--param-location", default=None,
                       help="JSON/YAML OpParams file")
        p.add_argument("--model-location", default=None)
        p.add_argument("--write-location", default=None)
        p.add_argument("--metrics-location", default=None)
        return p

    def main(self, argv: Optional[Sequence[str]] = None
             ) -> OpWorkflowRunnerResult:
        args = self.parser().parse_args(argv)
        params = (OpParams.from_file(args.param_location)
                  if args.param_location else OpParams())
        for name in ("model_location", "write_location", "metrics_location"):
            v = getattr(args, name)
            if v:
                setattr(params, name, v)
        run_type = next(r for r in RunType if r.value == args.run_type)
        return self.runner().run(run_type, params)
