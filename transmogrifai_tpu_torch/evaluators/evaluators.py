"""Evaluator stages (counterpart of ``transmogrifai_tpu.evaluators.evaluators``).

Ported: the binary classification evaluator with its AuPR metric and the
``Evaluators.BinaryClassification.auPR()`` factory; the regression
evaluator (RMSE, MSE, MAE, R2) and ``Evaluators.Regression.{rmse, mse,
mae, r2}``.  Other metrics and evaluator families are not ported yet
(ROADMAP Queue A).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..types.columns import ColumnarDataset
from .metrics import aupr, regression_metrics

__all__ = ["OpEvaluatorBase", "OpBinaryClassificationEvaluator",
           "OpRegressionEvaluator", "Evaluators"]


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
    default_metric = "AuPR"

    def evaluate(self, data: ColumnarDataset) -> Dict[str, float]:
        batch = data[self.prediction_col].values
        score = (batch.probability[:, 1] if batch.probability is not None
                 else batch.prediction)
        y = np.nan_to_num(np.asarray(data[self.label_col].values, np.float64))
        return {"AuPR": aupr(torch.from_numpy(y).to(score.device), score)}


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
