"""Prediction column batch + shared predictor stage bases (counterpart of
``transmogrifai_tpu.models.prediction``).

A ``PredictionBatch`` holds the whole batch's predictions as tensors on the
model's device: prediction (N,), optional raw prediction and probability
(N, K).  ``row(i)`` / ``rows()`` give the reference's per-row reserved-key
map (``prediction``, ``rawPrediction_k``, ``probability_k``;
Maps.scala:339-394) as Python floats.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..stages.base import BinaryEstimator, BinaryModel
from ..types.columns import FeatureColumn
from ..types.feature_types import OPNumeric, OPVector, Prediction

__all__ = ["PredictionBatch", "PredictorEstimator", "PredictorModel"]


@dataclasses.dataclass
class PredictionBatch:
    """Columnar predictions: prediction (N,), optional raw/proba (N, K)."""

    prediction: torch.Tensor
    raw_prediction: Optional[torch.Tensor] = None
    probability: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return len(self.prediction)

    def row(self, i: int) -> Dict[str, float]:
        """Row ``i``'s reserved-key map.  One row costs a device read per
        tensor; take ``rows()`` for a whole batch."""
        return _row_map(*(None if t is None else _host(t[i:i + 1])
                          for t in (self.prediction, self.raw_prediction,
                                    self.probability)), 0)

    def rows(self) -> List[Dict[str, float]]:
        """Every row's reserved-key map, from one host copy per tensor."""
        host = [None if t is None else _host(t)
                for t in (self.prediction, self.raw_prediction,
                          self.probability)]
        return [_row_map(*host, i) for i in range(len(self))]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _row_map(pred, raw, proba, i: int) -> Dict[str, float]:
    out = {"prediction": float(pred[i])}
    if raw is not None:
        for k, v in enumerate(np.atleast_1d(raw[i])):
            out[f"rawPrediction_{k}"] = float(v)
    if proba is not None:
        for k, v in enumerate(np.atleast_1d(proba[i])):
            out[f"probability_{k}"] = float(v)
    return out


class PredictorEstimator(BinaryEstimator):
    """Base for model estimators: inputs (response RealNN, features OPVector)."""

    input_types = (OPNumeric, OPVector)
    label_input_positions = (0,)

    def __init__(self, operation_name: str, uid: Optional[str] = None):
        super().__init__(operation_name=operation_name,
                         output_type=Prediction, uid=uid)

    def output_is_response(self) -> bool:
        return False  # the Prediction output is never the workflow response


class PredictorModel(BinaryModel):
    """Base for fitted predictors; subclasses implement ``predict_batch``."""

    input_types = (OPNumeric, OPVector)
    label_input_positions = (0,)

    def __init__(self, operation_name: str, uid: Optional[str] = None):
        super().__init__(operation_name=operation_name,
                         output_type=Prediction, uid=uid)

    def output_is_response(self) -> bool:
        return False

    def predict_batch(self, X: torch.Tensor) -> PredictionBatch:
        raise NotImplementedError

    def transform_columns(self, label_col, features_col) -> FeatureColumn:
        return FeatureColumn(Prediction, self.predict_batch(features_col.values))
