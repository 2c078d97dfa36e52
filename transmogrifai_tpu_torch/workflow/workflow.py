"""Workflow engine — the user-facing train/score orchestration (counterpart
of ``transmogrifai_tpu.workflow.workflow``).

Ported: ``OpWorkflow.set_result_features / set_input_data / train`` on the
in-core path with the train-time serializability gate
(``allow_non_serializable()`` opts out), ``OpWorkflow.load_model`` and
``OpWorkflowModel.score / evaluate / score_and_evaluate / save / load``
(``workflow/persistence.py``) and ``summary / summary_json /
summary_pretty``.  Every stage that owns a ``device`` runs on
the workflow's device (``OpWorkflow(device=...)``), which defaults to the
package default (``cuda`` unless the caller asked for the CPU).

Not ported yet (ROADMAP Queue A): the static DAG lint that
``train(validate=True)`` runs in the JAX package (so ``validate=True``
raises here and the default is ``False``), workflow CV, raw feature
filtering, meshes, checkpoints and out-of-core streaming.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..evaluators.evaluators import OpEvaluatorBase
from ..features.feature import Feature
from ..models.trees import clear_sweep_caches
from ..readers.base import Reader, reader_for
from ..stages.base import PipelineStage
from ..types.columns import ColumnarDataset
from ..types.feature_types import Prediction
from .dag import compute_dag, fit_and_transform_dag, transform_dag

__all__ = ["OpWorkflow", "OpWorkflowModel"]


class _WorkflowCore:
    def __init__(self):
        self.result_features: List[Feature] = []
        self.reader: Optional[Reader] = None

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
            raise RuntimeError("no reader set — call set_input_data")
        return self.reader.generate_dataset(self.raw_features())


class OpWorkflow(_WorkflowCore):
    def __init__(self, device: DeviceLike = None):
        super().__init__()
        self.device = device
        self._allow_non_serializable = False

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

    def train(self, validate: bool = False) -> "OpWorkflowModel":
        """Fit every stage of the DAG in layer order on the input data.

        The returned model's ``stage_seconds`` maps each stage's class name
        to its fit+transform wall seconds (synchronised with the device).
        The tree fits' sweep memo is cleared at its end."""
        if validate:
            raise NotImplementedError(
                "train(validate=True) runs the DAG lint, which is not "
                "ported yet (ROADMAP Queue A)")
        dev = resolve_device(self.device)
        data = self.generate_raw_data()
        dag = compute_dag(self.result_features)
        _check_unique_uids(dag.all_stages())
        if not self._allow_non_serializable:
            from .persistence import check_serializable

            check_serializable(dag.all_stages())
        seconds: Dict[str, float] = {}

        def on_stage(stage: PipelineStage, dt: float) -> None:
            if dev.type == "cuda":
                t0 = time.perf_counter()
                torch.cuda.synchronize(dev)
                dt += time.perf_counter() - t0
            name = type(stage).__name__
            seconds[name] = seconds.get(name, 0.0) + dt

        placed = [s for s in dag.all_stages()
                  if hasattr(s, "device") and s.device is None]
        for s in placed:
            s.device = str(dev)
        try:
            fitted, transformed = fit_and_transform_dag(dag, data,
                                                        on_stage=on_stage)
        finally:
            for s in placed:
                s.device = None
            # the sweep memo's sketches and binned matrices live no
            # longer than the train
            clear_sweep_caches()
        model = OpWorkflowModel(self.result_features, fitted, transformed)
        model.reader = self.reader
        model.stage_seconds = seconds
        return model


def _check_unique_uids(stages: Sequence[PipelineStage]) -> None:
    seen = set()
    for s in stages:
        if s.uid in seen:
            raise ValueError(f"duplicate stage uid {s.uid}")
        seen.add(s.uid)


class OpWorkflowModel(_WorkflowCore):
    def __init__(self, result_features: Sequence[Feature],
                 stages: Sequence[PipelineStage],
                 train_data: Optional[ColumnarDataset] = None):
        super().__init__()
        self.result_features = list(result_features)
        self.stages = list(stages)
        self.train_data = train_data
        self.stage_seconds: Dict[str, float] = {}
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

    def score(self, data=None) -> ColumnarDataset:
        """Apply the fitted DAG; returns the responses and result features
        (every other intermediate is dropped after its last consumer)."""
        if data is not None:
            self.set_input_data(data)
        keep = [f.name for f in self.raw_features() if f.is_response]
        keep += [f.name for f in self.result_features if f.name not in keep]
        scored = transform_dag(self._scoring_dag(), self.generate_raw_data(),
                               keep=keep)
        return scored.select([k for k in keep if k in scored])

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
