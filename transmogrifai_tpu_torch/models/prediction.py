"""Prediction column batch + shared predictor stage bases (counterpart of
``transmogrifai_tpu.models.prediction``).

A ``PredictionBatch`` holds the whole batch's predictions as tensors on the
model's device: prediction (N,), optional raw prediction and probability
(N, K).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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


class PredictorEstimator(BinaryEstimator):
    """Base for model estimators: inputs (response RealNN, features OPVector)."""

    input_types = (OPNumeric, OPVector)

    def __init__(self, operation_name: str, uid: Optional[str] = None):
        super().__init__(operation_name=operation_name,
                         output_type=Prediction, uid=uid)

    def output_is_response(self) -> bool:
        return False  # the Prediction output is never the workflow response


class PredictorModel(BinaryModel):
    """Base for fitted predictors; subclasses implement ``predict_batch``."""

    input_types = (OPNumeric, OPVector)

    def __init__(self, operation_name: str, uid: Optional[str] = None):
        super().__init__(operation_name=operation_name,
                         output_type=Prediction, uid=uid)

    def output_is_response(self) -> bool:
        return False

    def predict_batch(self, X: torch.Tensor) -> PredictionBatch:
        raise NotImplementedError

    def transform_columns(self, label_col, features_col) -> FeatureColumn:
        return FeatureColumn(Prediction, self.predict_batch(features_col.values))
