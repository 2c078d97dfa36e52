"""SelectedModelCombiner: one prediction from two model selectors'
(counterpart of ``transmogrifai_tpu.selector.combiner``; reference
``SelectedModelCombiner.scala`` and ``CombinationStrategy.scala``).

Strategies:

* ``best``: all weight on the selector whose winner validated better;
* ``weighted``: weights in proportion to each winner's validation
  metric, direction-corrected as in the JAX package (for a metric to
  minimize the smaller value takes the larger weight, where the
  reference's ``m1/(m1+m2)`` weighs the worse model higher), a negative
  metric clamped at 0;
* ``equal``: 0.5 and 0.5.

The metric is the two selectors' common validation metric; where they
differ, one selector's training metrics must hold the other's, else the
fit raises.  The fitted model blends the two ``PredictionBatch``es on
their device: ``raw = w1 raw1 + w2 raw2``, ``prob = w1 p1 + w2 p2`` in
float64, the prediction the argmax of the blended probabilities (the
weighted predictions where there are none).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..evaluators.metrics import MINIMIZE_METRICS
from ..models.prediction import PredictionBatch
from ..stages.base import TernaryEstimator, TernaryModel
from ..types.columns import FeatureColumn
from ..types.feature_types import OPNumeric, Prediction

__all__ = ["SelectedModelCombiner", "SelectedCombinerModel"]


def _larger_better(metric: str) -> bool:
    return metric not in MINIMIZE_METRICS


def _as_batch(col: FeatureColumn) -> PredictionBatch:
    """A prediction column as a ``PredictionBatch``: as it is, or built
    on the host from a column of reserved-key row maps."""
    v = col.values
    if isinstance(v, PredictionBatch):
        return v
    rows = list(v)
    pred = torch.tensor([0.0 if r is None else r.get("prediction", 0.0)
                         for r in rows], dtype=torch.float64)

    def collect(prefix):
        ks: List[str] = sorted(
            {k for r in rows if r for k in r if k.startswith(prefix)},
            key=lambda k: int(k.rsplit("_", 1)[1]))
        if not ks:
            return None
        return torch.tensor([[0.0 if r is None else r.get(k, 0.0)
                              for k in ks] for r in rows],
                            dtype=torch.float64)

    return PredictionBatch(prediction=pred,
                           raw_prediction=collect("rawPrediction_"),
                           probability=collect("probability_"))


class SelectedModelCombiner(TernaryEstimator):
    """Inputs: the label, and two predictions of fitted model selectors
    (their summaries give the winners' metrics that set the weights)."""

    input_types = (OPNumeric, Prediction, Prediction)
    label_input_positions = (0,)

    def __init__(self, combination_strategy: str = "best",
                 uid: Optional[str] = None):
        super().__init__(operation_name="combineModels",
                         output_type=Prediction, uid=uid)
        if combination_strategy not in ("best", "weighted", "equal"):
            raise ValueError(
                f"unknown combination_strategy {combination_strategy!r} "
                "(expected 'best', 'weighted' or 'equal')")
        self.combination_strategy = combination_strategy

    def output_is_response(self) -> bool:
        return False

    def _selector_summaries(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        out = []
        for feat in self.input_features[1:3]:
            stage = feat.origin_stage
            summ = (stage.metadata or {}).get("model_selector_summary")
            if summ is None:
                raise RuntimeError(
                    "SelectedModelCombiner inputs must be predictions from "
                    f"fitted ModelSelectors; {feat.name!r} (stage "
                    f"{type(stage).__name__}) carries no "
                    "model_selector_summary")
            out.append(summ)
        return out[0], out[1]

    @staticmethod
    def _winning_metric(summ: Dict[str, Any]) -> Tuple[float, str]:
        """The validation metric of a selector's winner, and its name."""
        results = summ.get("validationResults") or []
        metric_name = results[0]["metricName"] if results else ""
        for r in results:
            if (r.get("modelType") == summ.get("bestModelType")
                    and r.get("params") == summ.get("bestModelParams")):
                return float(r["metricValue"]), metric_name
        vals = [float(r["metricValue"]) for r in results
                if np.isfinite(r["metricValue"])]
        if not vals:
            raise RuntimeError("selector summary has no finite validation "
                               "metric for the winning model")
        return (max(vals) if _larger_better(metric_name) else min(vals),
                metric_name)

    @staticmethod
    def _train_metric(summ: Dict[str, Any], name: str) -> Optional[float]:
        metrics = summ.get("trainEvaluationMetrics") or {}
        # the exact key first: a substring alone would take
        # RootMeanSquaredError for MeanSquaredError
        if name in metrics and isinstance(metrics[name], (int, float)):
            return float(metrics[name])
        for k, v in metrics.items():
            if name and (name in k or k in name) and isinstance(
                    v, (int, float)):
                return float(v)
        return None

    def _resolve_metrics(self, s1, s2) -> Tuple[float, float, str]:
        m1, n1 = self._winning_metric(s1)
        m2, n2 = self._winning_metric(s2)
        if n1 == n2:
            return m1, m2, n1
        # different validation metrics: meet through the training metrics
        m2e1 = self._train_metric(s2, n1)
        if m2e1 is not None:
            t1 = self._train_metric(s1, n1)
            return (t1 if t1 is not None else m1), m2e1, n1
        m1e2 = self._train_metric(s1, n2)
        if m1e2 is not None:
            t2 = self._train_metric(s2, n2)
            return m1e2, (t2 if t2 is not None else m2), n2
        raise RuntimeError(
            "evaluation metrics for the two model selectors are "
            f"non-overlapping ({n1!r} vs {n2!r})")

    def fit_columns(self, data, label_col: FeatureColumn,
                    p1_col: FeatureColumn, p2_col: FeatureColumn):
        s1, s2 = self._selector_summaries()
        if s1.get("problemType") not in (None, s2.get("problemType")):
            raise RuntimeError(
                "cannot combine selectors for different problem types: "
                f"{s1.get('problemType')} vs {s2.get('problemType')}")
        m1, m2, metric = self._resolve_metrics(s1, s2)
        strategy = self.combination_strategy
        lb = _larger_better(metric)
        if strategy == "best":
            first_wins = (m1 > m2) if lb else (m1 < m2)
            w1, w2 = (1.0, 0.0) if first_wins else (0.0, 1.0)
        elif strategy == "weighted":
            # a maximized metric can be negative (R2): clamped at 0, the
            # weights interpolate and never extrapolate
            c1, c2 = max(m1, 0.0), max(m2, 0.0)
            tot = c1 + c2
            if tot <= 0 or not np.isfinite(tot):
                w1 = w2 = 0.5
            elif lb:
                w1, w2 = c1 / tot, c2 / tot
            else:  # minimized: the smaller metric takes the larger weight
                w1, w2 = c2 / tot, c1 / tot
        else:
            w1 = w2 = 0.5

        if strategy == "best":
            self.metadata["model_selector_summary"] = dict(
                s1 if w1 > 0.5 else s2)
        else:
            self.metadata["model_selector_summary"] = {
                "validationType": s1.get("validationType"),
                "bestModelType": f"{s1.get('bestModelType')} "
                                 f"{s2.get('bestModelType')}",
                "bestModelParams": {
                    **{f"{k}_1": v for k, v in
                       (s1.get("bestModelParams") or {}).items()},
                    **{f"{k}_2": v for k, v in
                       (s2.get("bestModelParams") or {}).items()}},
                "validationResults": list(s1.get("validationResults") or [])
                + list(s2.get("validationResults") or []),
                "holdoutMetrics": {},
                "trainEvaluationMetrics": {},
                "dataPrepResults": (s1.get("dataPrepResults")
                                    or s2.get("dataPrepResults")),
            }
        self.metadata["combiner"] = {
            "strategy": strategy, "metricName": metric,
            "metricValue1": m1, "metricValue2": m2,
            "weight1": w1, "weight2": w2,
        }
        model = SelectedCombinerModel(weight1=w1, weight2=w2,
                                      strategy=strategy, metric=metric)
        # the blend's own training metrics, where it is a blend
        if strategy != "best" and label_col is not None:
            combined = model.transform_columns(label_col, p1_col, p2_col)
            self.metadata["model_selector_summary"][
                "trainEvaluationMetrics"] = _evaluate_combined(
                    label_col, combined.values)
        return model


def _evaluate_combined(label_col: FeatureColumn,
                       batch: PredictionBatch) -> Dict[str, float]:
    """The problem's metric set of a blended batch against the label."""
    from ..evaluators.metrics import (binary_classification_metrics,
                                      multiclass_metrics, regression_metrics)

    y = np.nan_to_num(np.asarray(label_col.values, np.float64))
    proba = batch.probability
    yt = torch.from_numpy(y).to(batch.prediction.device)
    if proba is not None and proba.shape[1] == 2:
        return binary_classification_metrics(yt, proba[:, 1])
    if proba is not None:
        out = multiclass_metrics(yt.long(), batch.prediction.long(),
                                 proba.shape[1])
        out.pop("confusion", None)
        return out
    return regression_metrics(yt, batch.prediction)


class SelectedCombinerModel(TernaryModel):
    """The fitted blend: the weighted sums of the two batches' raw
    predictions and probabilities, the argmax prediction."""

    input_types = (OPNumeric, Prediction, Prediction)
    label_input_positions = (0,)

    def __init__(self, weight1: float, weight2: float, strategy: str = "best",
                 metric: str = "", uid: Optional[str] = None):
        super().__init__(operation_name="combineModels",
                         output_type=Prediction, uid=uid)
        self.weight1 = float(weight1)
        self.weight2 = float(weight2)
        self.strategy = strategy
        self.metric = metric

    def output_is_response(self) -> bool:
        return False

    def transform_columns(self, label_col, p1_col, p2_col) -> FeatureColumn:
        b1, b2 = _as_batch(p1_col), _as_batch(p2_col)
        w1, w2 = self.weight1, self.weight2
        dev = b1.prediction.device

        def comb(a1, a2):
            if a1 is None or a2 is None:
                return None
            if a1.shape != a2.shape:
                # two heads of different widths cannot be blended, and a
                # blend of class indices names a class neither predicted
                raise ValueError(
                    "cannot combine predictions of different shapes "
                    f"{tuple(a1.shape)} vs {tuple(a2.shape)} (mismatched "
                    "class counts between the two selectors)")
            return (w1 * a1.to(dev, torch.float64)
                    + w2 * a2.to(dev, torch.float64))

        raw = comb(b1.raw_prediction, b2.raw_prediction)
        proba = comb(b1.probability, b2.probability)
        if proba is not None:
            pred = proba.argmax(dim=1).to(torch.float64)
        else:
            pred = comb(b1.prediction, b2.prediction)
        return FeatureColumn(Prediction, PredictionBatch(
            prediction=pred, raw_prediction=raw, probability=proba))
