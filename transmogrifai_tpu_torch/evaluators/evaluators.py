"""Evaluator stages (counterpart of ``transmogrifai_tpu.evaluators.evaluators``).

The binary classification evaluator with the JAX package's full metric
set (AuROC, AuPR, BrierScore, LogLoss and the counts and rates at
``threshold``, plus the threshold curves when ``n_thresholds`` > 0); the
multiclass evaluator (F1, Error, Accuracy, Precision, Recall, the
confusion matrix, LogLoss and the top-N / threshold counts at its
``top_ns`` and ``thresholds``); the regression evaluator (RMSE, MSE, MAE,
R2); the forecast evaluator (SMAPE, MASE); the calibration-bin evaluator
(``OpBinScoreEvaluator``: Brier score and per-bin counts, mean scores
and conversion rates); and the ``Evaluators`` factories, a custom binary
metric among them.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..types.columns import ColumnarDataset
from .metrics import (binary_classification_metrics, forecast_metrics,
                      multiclass_metrics, multiclass_threshold_metrics,
                      regression_metrics, threshold_curves)

__all__ = ["OpEvaluatorBase", "OpBinaryClassificationEvaluator",
           "OpMultiClassificationEvaluator", "OpRegressionEvaluator",
           "OpForecastEvaluator", "OpBinScoreEvaluator", "Evaluators"]


def _label(data: ColumnarDataset, name: str) -> np.ndarray:
    return np.nan_to_num(np.asarray(data[name].values, np.float64))


def _positive_score(batch) -> torch.Tensor:
    """The positive class's probability, else the prediction."""
    if batch.probability is not None:
        return batch.probability[:, 1]
    return batch.prediction


class OpEvaluatorBase:
    """Computes {metric name -> value} from (label, prediction) columns."""

    default_metric: str = ""
    larger_better: bool = True

    def __init__(self, label_col: Optional[str] = None,
                 prediction_col: Optional[str] = None):
        self.label_col = label_col
        self.prediction_col = prediction_col

    def evaluate(self, data: ColumnarDataset,
                 sample_weight=None) -> Dict[str, float]:
        raise NotImplementedError

    def evaluate_default(self, data: ColumnarDataset,
                         sample_weight=None) -> float:
        """The evaluator's one selection metric."""
        return self.evaluate(data, sample_weight)[self.default_metric]

    @property
    def name(self) -> str:
        return type(self).__name__


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
    probabilities and their top-N / threshold counts at ``top_ns``
    (default 1 and 3) and ``thresholds`` (default 0.00 .. 1.00 by 0.01).
    ``num_classes`` is the class count when given; else it is inferred
    from the labels, the predictions and the probability width together,
    never from the labels' largest value alone (an evaluation slice
    missing the top class does not shrink the class space)."""

    default_metric = "F1"

    def __init__(self, label_col=None, prediction_col=None,
                 top_ns=(1, 3), thresholds=None,
                 num_classes: Optional[int] = None):
        super().__init__(label_col, prediction_col)
        self.top_ns = tuple(top_ns)
        self.thresholds = thresholds
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
            out["ThresholdMetrics"] = multiclass_threshold_metrics(
                yi, proba, top_ns=self.top_ns, thresholds=self.thresholds)
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


class OpForecastEvaluator(OpEvaluatorBase):
    """SMAPE and MASE of the ``prediction`` column against the label (MASE
    scaled by the labels' change over ``seasonal_period`` rows)."""

    default_metric = "SMAPE"
    larger_better = False

    def __init__(self, label_col=None, prediction_col=None,
                 seasonal_period: int = 1):
        super().__init__(label_col, prediction_col)
        self.seasonal_period = seasonal_period

    def evaluate(self, data: ColumnarDataset,
                 sample_weight=None) -> Dict[str, float]:
        pred = data[self.prediction_col].values.prediction
        return forecast_metrics(_label(data, self.label_col), pred,
                                self.seasonal_period)


class OpBinScoreEvaluator(OpEvaluatorBase):
    """Calibration bins (OpBinScoreEvaluator.scala:53): the positive
    score's Brier score, and over ``num_bins`` equal bins of [0, 1] each
    bin's row count, mean score and mean label."""

    default_metric = "BrierScore"
    larger_better = False

    def __init__(self, label_col=None, prediction_col=None,
                 num_bins: int = 100):
        super().__init__(label_col, prediction_col)
        self.num_bins = num_bins

    def evaluate(self, data: ColumnarDataset,
                 sample_weight=None) -> Dict[str, object]:
        score = _positive_score(data[self.prediction_col].values)
        dev = score.device
        k = self.num_bins
        bins = torch.clamp((score * k).to(torch.int64), 0, k - 1)
        s64 = score.to(torch.float64)
        y = torch.from_numpy(_label(data, self.label_col)).to(dev)
        counts = torch.bincount(bins, minlength=k)
        sum_scores = torch.bincount(bins, weights=s64, minlength=k)
        sum_labels = torch.bincount(bins, weights=y, minlength=k)
        nz = torch.clamp(counts, min=1).to(torch.float64)
        return {
            "BrierScore": float(torch.mean((s64 - y) ** 2)),
            "binCenters": ((np.arange(k) + 0.5) / k).tolist(),
            "numberOfDataPoints": counts.cpu().tolist(),
            "averageScore": (sum_scores / nz).cpu().tolist(),
            "averageConversionRate": (sum_labels / nz).cpu().tolist(),
        }


class _CustomBinaryEvaluator(OpEvaluatorBase):
    """One metric ``fn(labels, scores)`` of host float64 labels and the
    positive class's scores (numpy arrays)."""

    def __init__(self, metric_name: str, fn, label_col=None,
                 prediction_col=None):
        super().__init__(label_col, prediction_col)
        self.default_metric = metric_name
        self.fn = fn

    def evaluate(self, data: ColumnarDataset,
                 sample_weight=None) -> Dict[str, float]:
        score = _positive_score(data[self.prediction_col].values)
        return {self.default_metric: float(self.fn(
            _label(data, self.label_col), score.cpu().numpy()))}


def _with_metric(cls, metric: str, larger_better: bool = True,
                 *args) -> OpEvaluatorBase:
    """A ``cls(*args)`` evaluator selecting by ``metric``."""
    ev = cls(*args)
    ev.default_metric = metric
    ev.larger_better = larger_better
    return ev


_BINARY = OpBinaryClassificationEvaluator
_MULTI = OpMultiClassificationEvaluator
_REG = OpRegressionEvaluator


class Evaluators:
    """Factory catalogue (Evaluators.scala:40-240): each factory's
    evaluator returns its family's whole metric set, ``default_metric``
    the one it names."""

    class BinaryClassification:
        @staticmethod
        def auPR() -> OpBinaryClassificationEvaluator:
            return _with_metric(_BINARY, "AuPR")

        @staticmethod
        def auROC() -> OpBinaryClassificationEvaluator:
            return _with_metric(_BINARY, "AuROC")

        @staticmethod
        def precision() -> OpBinaryClassificationEvaluator:
            return _with_metric(_BINARY, "Precision")

        @staticmethod
        def recall() -> OpBinaryClassificationEvaluator:
            return _with_metric(_BINARY, "Recall")

        @staticmethod
        def f1() -> OpBinaryClassificationEvaluator:
            return _with_metric(_BINARY, "F1")

        @staticmethod
        def error() -> OpBinaryClassificationEvaluator:
            return _with_metric(_BINARY, "Error", False)

        @staticmethod
        def brierScore() -> OpBinaryClassificationEvaluator:
            return _with_metric(_BINARY, "BrierScore", False)

        @staticmethod
        def custom(metric_name: str, larger_better: bool,
                   fn: Callable[[np.ndarray, np.ndarray], float]
                   ) -> OpEvaluatorBase:
            return _with_metric(_CustomBinaryEvaluator, metric_name,
                                larger_better, metric_name, fn)

    class MultiClassification:
        @staticmethod
        def f1() -> OpMultiClassificationEvaluator:
            return _with_metric(_MULTI, "F1")

        @staticmethod
        def precision() -> OpMultiClassificationEvaluator:
            return _with_metric(_MULTI, "Precision")

        @staticmethod
        def recall() -> OpMultiClassificationEvaluator:
            return _with_metric(_MULTI, "Recall")

        @staticmethod
        def error() -> OpMultiClassificationEvaluator:
            return _with_metric(_MULTI, "Error", False)

    class Regression:
        @staticmethod
        def rmse() -> OpRegressionEvaluator:
            return _with_metric(_REG, "RootMeanSquaredError", False)

        @staticmethod
        def mse() -> OpRegressionEvaluator:
            return _with_metric(_REG, "MeanSquaredError", False)

        @staticmethod
        def mae() -> OpRegressionEvaluator:
            return _with_metric(_REG, "MeanAbsoluteError", False)

        @staticmethod
        def r2() -> OpRegressionEvaluator:
            return _with_metric(_REG, "R2")
