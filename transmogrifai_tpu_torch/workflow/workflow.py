"""Workflow engine — the user-facing train/score orchestration (counterpart
of ``transmogrifai_tpu.workflow.workflow``).

Ported: ``OpWorkflow.set_result_features / set_input_data / train`` on the
in-core path and ``OpWorkflowModel.score / evaluate / score_and_evaluate``.
Every stage that owns a ``device`` runs on the workflow's device
(``OpWorkflow(device=...)``), which defaults to the package default
(``cuda`` unless the caller asked for the CPU).

Not ported yet (ROADMAP Queue A): the static DAG lint that
``train(validate=True)`` runs in the JAX package (so ``validate=True``
raises here and the default is ``False``), workflow CV, raw feature
filtering, meshes, checkpoints, out-of-core streaming and persistence.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch

from ..device import DeviceLike, resolve_device
from ..evaluators.evaluators import OpEvaluatorBase
from ..features.feature import Feature
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

    def set_result_features(self, *features: Feature) -> "OpWorkflow":
        self.result_features = list(features)
        return self

    def train(self, validate: bool = False) -> "OpWorkflowModel":
        """Fit every stage of the DAG in layer order on the input data.

        The returned model's ``stage_seconds`` maps each stage's class name
        to its fit+transform wall seconds (synchronised with the device)."""
        if validate:
            raise NotImplementedError(
                "train(validate=True) runs the DAG lint, which is not "
                "ported yet (ROADMAP Queue A)")
        dev = resolve_device(self.device)
        data = self.generate_raw_data()
        dag = compute_dag(self.result_features)
        _check_unique_uids(dag.all_stages())
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

    def _scoring_dag(self):
        stage_map = {s.uid: s for s in self.stages}
        return compute_dag([f.copy_with_new_stages(stage_map)
                            for f in self.result_features])

    def score(self, data=None) -> ColumnarDataset:
        """Apply the fitted DAG; returns the responses and result features."""
        if data is not None:
            self.set_input_data(data)
        scored = transform_dag(self._scoring_dag(), self.generate_raw_data())
        keep = [f.name for f in self.raw_features() if f.is_response]
        keep += [f.name for f in self.result_features
                 if f.name in scored and f.name not in keep]
        return scored.select(keep)

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
