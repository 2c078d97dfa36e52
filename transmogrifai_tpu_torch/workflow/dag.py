"""Feature-DAG computation and layered execution (counterpart of
``transmogrifai_tpu.workflow.dag``).

``compute_dag`` layers stages by longest path from the raw generators;
``fit_and_transform_dag`` walks the layers in order, fitting estimators and
applying transformers; ``transform_dag`` applies a fitted DAG through the
memoized execution plan (``workflow/plan.py``: column liveness).  The
intra-layer host threads and the workflow-CV cut are not ported.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..features.feature import Feature, FeatureCycleError
from ..stages.base import Estimator, Model, PipelineStage, Transformer
from ..stages.generator import FeatureGeneratorStage
from ..types.columns import ColumnarDataset

__all__ = ["StagesDAG", "compute_dag", "fit_and_transform_dag",
           "transform_dag"]


class StagesDAG:
    """Layers of stages, topologically ordered (layer 0 = raw generators)."""

    def __init__(self, layers: List[List[PipelineStage]]):
        self.layers = layers

    def all_stages(self) -> List[PipelineStage]:
        return [s for layer in self.layers for s in layer]

    def non_generator_layers(self) -> List[List[PipelineStage]]:
        return [[s for s in layer
                 if not isinstance(s, FeatureGeneratorStage)]
                for layer in self.layers]


def compute_dag(result_features: Sequence[Feature]) -> StagesDAG:
    """Layer the stage DAG reachable from ``result_features``: every stage
    lands one layer after the deepest producer of its inputs."""
    stages: Dict[str, PipelineStage] = {}

    def visit(f: Feature):
        if f.origin_stage is None:
            raise ValueError(f"feature {f.name!r} has no origin stage")
        stages[f.origin_stage.uid] = f.origin_stage

    for rf in result_features:
        rf.traverse(visit)

    depth: Dict[str, int] = {}

    def stage_depth(s: PipelineStage, on_path: Tuple[str, ...] = ()) -> int:
        if s.uid in depth:
            return depth[s.uid]
        if s.uid in on_path:
            raise FeatureCycleError(f"cycle through stage {s.uid}")
        d = 0
        for f in s.input_features:
            p = f.origin_stage
            if p is not None:
                stages.setdefault(p.uid, p)
                d = max(d, 1 + stage_depth(p, on_path + (s.uid,)))
        depth[s.uid] = d
        return d

    for s in list(stages.values()):
        stage_depth(s)
    layers: List[List[PipelineStage]] = [
        [] for _ in range(max(depth.values()) + 1 if depth else 0)]
    for uid, s in stages.items():
        layers[depth[uid]].append(s)
    return StagesDAG(layers)


def fit_and_transform_dag(
    dag: StagesDAG, train: ColumnarDataset, on_stage=None,
    fitted_substitutes: Optional[Dict[str, Model]] = None,
) -> Tuple[List[PipelineStage], ColumnarDataset]:
    """Fit estimators layer by layer, transforming as we go.  Returns the
    fitted stages in topological order and the transformed data.
    ``on_stage(stage, seconds)`` is called after each stage.  An estimator
    whose uid is a key of ``fitted_substitutes`` is not fitted: that
    model stands for it (the warm start of
    ``OpWorkflow.with_model_stages``)."""
    fitted_substitutes = fitted_substitutes or {}
    fitted: List[PipelineStage] = []
    data = train
    for layer in dag.non_generator_layers():
        for stage in layer:
            t0 = time.perf_counter()
            if isinstance(stage, Estimator):
                model = fitted_substitutes.get(stage.uid) or stage.fit(data)
            elif isinstance(stage, Transformer):
                model = stage
            else:
                raise TypeError(f"cannot execute stage {stage!r}")
            fitted.append(model)
            data = model.transform(data)
            if on_stage is not None:
                on_stage(stage, time.perf_counter() - t0)
    return fitted, data


def transform_dag(dag: StagesDAG, data: ColumnarDataset,
                  keep: Optional[Sequence[str]] = None,
                  on_stage=None) -> ColumnarDataset:
    """Apply an already-fitted DAG (the scoring path) through its memoized
    plan; ``keep`` names the columns the caller needs, and every other
    intermediate is dropped after its last consumer (``keep=None``: none
    is).  ``on_stage(stage, seconds)`` is called after each stage."""
    from .plan import plan_for

    return plan_for(dag, keep=keep).transform(data, on_stage=on_stage)
