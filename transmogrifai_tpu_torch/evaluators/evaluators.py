"""Evaluator stages (counterpart of ``transmogrifai_tpu.evaluators.evaluators``).

Ported: the binary classification evaluator with the JAX package's full
metric set (AuROC, AuPR, BrierScore, LogLoss and the counts and rates at
``threshold``, plus the threshold curves when ``n_thresholds`` > 0) and
the ``Evaluators.BinaryClassification.auPR()`` factory; the multiclass
evaluator (F1, Error, Accuracy, Precision, Recall, the confusion matrix,
LogLoss and the top-N threshold counts) and
``Evaluators.MultiClassification.{f1, error}``; the
regression evaluator (RMSE, MSE, MAE, R2) and ``Evaluators.Regression.
{rmse, mse, mae, r2}``.  Other metrics and evaluator families are not
ported yet (ROADMAP Queue A).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..types.columns import ColumnarDataset
from .metrics import (binary_classification_metrics, multiclass_metrics,
                      multiclass_threshold_metrics, regression_metrics,
                      threshold_curves)

__all__ = ["OpEvaluatorBase", "OpBinaryClassificationEvaluator",
           "OpMultiClassificationEvaluator", "OpRegressionEvaluator",
           "Evaluators"]


class OpEvaluatorBase:
    """Computes {metric name -> value} from (label, prediction) columns."""

    default_metric: str = ""
    larger_better: bool = True

    def __init__(self, label_col: Optional[str] = None,
                 prediction_col: Optional[str] = None):
        self.label_col = label_col
        self.prediction_col = prediction_col

    def evaluate(self, data: ColumnarDataset) -> Dict[str, float]:
        raise NotImplementedError


class OpBinaryClassificationEvaluator(OpEvaluatorBase):
    """The binary metric set of the positive class's score: the
    probability, else the raw prediction, else the predicted label; rows
    weighted by ``sample_weight`` when given.  With ``n_thresholds`` > 0
    the precision, recall and F1 curves over that many thresholds in [0, 1]
    come as lists beside them."""

    default_metric = "AuPR"

    def __init__(self, label_col=None, prediction_col=None,
                 threshold: float = 0.5, n_thresholds: int = 0):
        super().__init__(label_col, prediction_col)
        self.threshold = threshold
        self.n_thresholds = n_thresholds

    def evaluate(self, data: ColumnarDataset,
                 sample_weight=None) -> Dict[str, object]:
        batch = data[self.prediction_col].values
        if batch.probability is not None:
            score = batch.probability[:, 1]
        elif batch.raw_prediction is not None:
            score = batch.raw_prediction[:, 1]
        else:
            score = batch.prediction
        y = np.nan_to_num(np.asarray(data[self.label_col].values, np.float64))
        yt = torch.from_numpy(y).to(score.device)
        w = (None if sample_weight is None
             else torch.as_tensor(np.asarray(sample_weight, np.float64)))
        out: Dict[str, object] = dict(binary_classification_metrics(
            yt, score, w, self.threshold))
        if self.n_thresholds:
            curves = threshold_curves(yt, score, self.n_thresholds, w)
            out.update({k: v.tolist() for k, v in curves.items()
                        if k != "thresholds"})
        return out


class OpMultiClassificationEvaluator(OpEvaluatorBase):
    """Multiclass metrics of the ``prediction`` column (weighted by
    ``sample_weight`` when given), the confusion matrix, LogLoss of the
    probabilities and their top-N / threshold counts at the JAX package's
    defaults (top 1 and 3; thresholds 0.00 .. 1.00).  ``num_classes`` is the
    class count when given; else it is inferred from the labels, the
    predictions and the probability width together, never from the
    labels' largest value alone (an evaluation slice missing the top class
    does not shrink the class space)."""

    default_metric = "F1"

    def __init__(self, label_col=None, prediction_col=None,
                 num_classes: Optional[int] = None):
        super().__init__(label_col, prediction_col)
        self.num_classes = num_classes

    def evaluate(self, data: ColumnarDataset,
                 sample_weight=None) -> Dict[str, object]:
        batch = data[self.prediction_col].values
        pred = batch.prediction
        proba = batch.probability
        y = np.nan_to_num(np.asarray(data[self.label_col].values, np.float64))
        n_classes = self.num_classes or int(max(
            float(y.max()) if len(y) else 0.0,
            float(pred.max()) if len(pred) else 0.0,
            (proba.shape[1] - 1) if proba is not None else 0)) + 1
        yi = torch.from_numpy(y.astype(np.int64)).to(pred.device)
        w = (None if sample_weight is None
             else torch.as_tensor(np.asarray(sample_weight, np.float64)))
        out = multiclass_metrics(yi, pred.long(), n_classes, w)
        out["confusionMatrix"] = out.pop("confusion").tolist()
        if proba is not None:
            p = torch.clamp(proba.to(torch.float64), 1e-15, 1.0)
            idx = torch.clamp(yi, 0, p.shape[1] - 1)
            out["LogLoss"] = float(-torch.log(
                p[torch.arange(len(yi), device=p.device), idx]).mean())
            out["ThresholdMetrics"] = multiclass_threshold_metrics(yi, proba)
        return out


class OpRegressionEvaluator(OpEvaluatorBase):
    """RMSE, MSE, MAE and R2 of the ``prediction`` column against the
    label, weighted by ``sample_weight`` when given."""

    default_metric = "RootMeanSquaredError"
    larger_better = False

    def evaluate(self, data: ColumnarDataset,
                 sample_weight=None) -> Dict[str, float]:
        pred = data[self.prediction_col].values.prediction
        y = np.nan_to_num(np.asarray(data[self.label_col].values, np.float64))
        w = (None if sample_weight is None
             else torch.as_tensor(np.asarray(sample_weight, np.float64)))
        return regression_metrics(torch.from_numpy(y).to(pred.device), pred,
                                  w)


def _regression(metric: str, larger_better: bool = False
                ) -> OpRegressionEvaluator:
    ev = OpRegressionEvaluator()
    ev.default_metric = metric
    ev.larger_better = larger_better
    return ev


class Evaluators:
    """Factory catalogue."""

    class BinaryClassification:
        @staticmethod
        def auPR() -> OpBinaryClassificationEvaluator:
            return OpBinaryClassificationEvaluator()

    class MultiClassification:
        @staticmethod
        def f1() -> OpMultiClassificationEvaluator:
            return OpMultiClassificationEvaluator()

        @staticmethod
        def error() -> OpMultiClassificationEvaluator:
            ev = OpMultiClassificationEvaluator()
            ev.default_metric = "Error"
            ev.larger_better = False
            return ev

    class Regression:
        @staticmethod
        def rmse() -> OpRegressionEvaluator:
            return _regression("RootMeanSquaredError")

        @staticmethod
        def mse() -> OpRegressionEvaluator:
            return _regression("MeanSquaredError")

        @staticmethod
        def mae() -> OpRegressionEvaluator:
            return _regression("MeanAbsoluteError")

        @staticmethod
        def r2() -> OpRegressionEvaluator:
            return _regression("R2", larger_better=True)
