"""Prediction column batch + shared predictor stage bases (counterpart of
``transmogrifai_tpu.models.prediction``).

A ``PredictionBatch`` holds the whole batch's predictions as tensors on the
model's device: prediction (N,), optional raw prediction and probability
(N, K).  ``row(i)`` / ``rows()`` give the reference's per-row reserved-key
map (``prediction``, ``rawPrediction_k``, ``probability_k``;
Maps.scala:339-394) as Python floats.

``AOTScoringSpec`` is a linear predictor's scoring as one pure torch
function of a fixed-shape matrix and its parameters, the form the serving
plane exports and captures once per shape bucket (``serving/aot.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import device_vector
from ..stages.base import BinaryEstimator, BinaryModel
from ..types.columns import FeatureColumn
from ..types.feature_types import OPNumeric, OPVector, Prediction

__all__ = ["PredictionBatch", "PredictorEstimator", "PredictorModel",
           "AOTScoringSpec"]


@dataclasses.dataclass(frozen=True)
class AOTScoringSpec:
    """A model's scoring program in exportable form (the JAX package's
    spec): ``fn(X, *params)`` is a pure torch function of a fixed-shape
    ``(N, D)`` float32 matrix and the model's parameter tensors, returning
    the tensors named by ``outputs`` in that order (of ``("prediction",
    "rawPrediction", "probability")``, the JAX package's order).  The
    parameters are runtime arguments, not constants baked into the
    program, and live on the model's device; the program store keys a
    program on a digest of their bytes anyway."""

    name: str                 # program family, e.g. "logreg.binary"
    fn: Any                   # callable (X, *params) -> tuple of tensors
    params: tuple             # float32 tensors, fixed order
    outputs: tuple            # names of fn's outputs, in order
    #: the width D of the input matrix (NaiveBayes' params[0] is its (K,)
    #: prior, so D cannot be read from the first parameter)
    n_features: Optional[int] = None


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

    device_heavy = True
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

    def aot_scoring_spec(self) -> Optional[AOTScoringSpec]:
        """The scoring as an :class:`AOTScoringSpec`, or None where the
        family has no single-program form (trees, isotonic, the MLP, GLM:
        as in the JAX package); serving then keeps ``predict_batch``."""
        return None

    def transform_columns(self, label_col, features_col) -> FeatureColumn:
        X = device_vector(features_col, getattr(self, "device", None)).values
        # the serving executor's path: per-bucket programs installed on
        # this stage (serving/aot.py) run only inside device_scoring(),
        # which the host rung and offline scoring never enter
        programs = getattr(self, "_serving_programs", None)
        if programs is not None:
            from ..serving.aot import device_scoring_active

            if device_scoring_active():
                batch = programs.predict(X)
                if batch is not None:
                    return FeatureColumn(Prediction, batch)
        return FeatureColumn(Prediction, self.predict_batch(X))
