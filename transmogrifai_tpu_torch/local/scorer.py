"""Local scoring of a trained workflow model: plain dict rows in, score
maps out (counterpart of ``transmogrifai_tpu.local.scorer``; the
reference's ``OpWorkflowModelLocal.scoreFunction``).

The columnar stages run on a micro-batch of rows, the same code path as
training and batch scoring, on the device the model was loaded to (or
trained on); a batch is never moved to the CPU to finish.  Only the
results come back to the host, one copy per prediction tensor.  The
serving host rung is this scorer over a CPU copy of the model
(``serving/registry.py``), not a second scoring path.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from ..device import DeviceLike
from ..models.prediction import PredictionBatch
from ..stages.generator import FeatureGeneratorStage
from ..types.columns import ColumnarDataset, FeatureColumn
from ..workflow.dag import transform_dag

__all__ = ["score_function", "score_function_batch", "load_model_local"]


def score_function(model) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """``row -> {result feature name: value}``, a ``Prediction`` value
    expanded to the reserved-key map (``prediction``, ``probability_i``,
    ``rawPrediction_i``)."""
    batch = score_function_batch(model)

    def score_one(row: Dict[str, Any]) -> Dict[str, Any]:
        return batch([row])[0]

    return score_one


def score_function_batch(
    model, on_stage: Optional[Callable[[Any, float], None]] = None,
) -> Callable[[Sequence[Dict[str, Any]]], List[Dict[str, Any]]]:
    """The micro-batch variant: a list of rows in, a list of score maps
    out.  An empty list gives an empty list; a row that is not a dict
    raises ``TypeError``; the response may be absent.  ``on_stage(stage,
    seconds)`` is called after each stage of every batch (as
    ``transform_dag`` calls it)."""
    dag = model._scoring_dag()
    raw_feats = model.raw_features()
    result_names = [f.name for f in model.result_features]

    def score_batch(rows: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        rows = list(rows)
        if not rows:
            return []
        for i, r in enumerate(rows):
            if not isinstance(r, dict):
                raise TypeError(
                    f"score_function_batch expects dict rows (raw feature "
                    f"name -> value); row {i} is {type(r).__name__!r}")
        cols: Dict[str, FeatureColumn] = {}
        for f in raw_feats:
            stage = f.origin_stage
            if not isinstance(stage, FeatureGeneratorStage):
                continue
            if f.is_response:
                cols[f.name] = FeatureColumn.from_values(
                    f.ftype, [r.get(f.name) for r in rows])
            else:
                cols[f.name] = stage.extract_column(rows)
        scored = transform_dag(dag, ColumnarDataset(cols), keep=result_names,
                               on_stage=on_stage)
        out: List[Dict[str, Any]] = [{} for _ in rows]
        for name in result_names:
            if name not in scored:
                continue
            vals = scored[name].values
            if isinstance(vals, PredictionBatch):
                for o, m in zip(out, vals.rows()):
                    o[name] = m
            else:
                host = vals.cpu() if hasattr(vals, "cpu") else vals
                for o, v in zip(out, host.tolist()):
                    o[name] = v
        return out

    return score_batch


def load_model_local(path: str, device: DeviceLike = None):
    """Load a saved model for local scoring, on ``device`` (else the
    default device: ``cuda`` unless the caller asked for the CPU)."""
    from ..workflow.persistence import load_workflow_model

    return load_workflow_model(path, device=device)
