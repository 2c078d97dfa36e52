"""Evaluator stages (counterpart of ``transmogrifai_tpu.evaluators.evaluators``).

Ported: the binary classification evaluator with its AuPR metric and the
``Evaluators.BinaryClassification.auPR()`` factory.  Other metrics and
evaluator families are not ported yet (ROADMAP Queue A).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..types.columns import ColumnarDataset
from .metrics import aupr

__all__ = ["OpEvaluatorBase", "OpBinaryClassificationEvaluator", "Evaluators"]


class OpEvaluatorBase:
    """Computes {metric name -> value} from (label, prediction) columns."""

    default_metric: str = ""

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


class Evaluators:
    """Factory catalogue."""

    class BinaryClassification:
        @staticmethod
        def auPR() -> OpBinaryClassificationEvaluator:
            return OpBinaryClassificationEvaluator()
