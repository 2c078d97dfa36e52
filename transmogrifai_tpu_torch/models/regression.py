"""Regression model stages (counterpart of
``transmogrifai_tpu.models.regression``): ``OpLinearRegression`` and its
fitted ``LinearRegressionModel``.  The tree regressors live in
``models.trees``.

Not ported yet (ROADMAP Queue A): ``OpGeneralizedLinearRegression``, the
isotonic calibrator and the AOT scoring specs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import as_device_tensor, resolve_device
from ..types.columns import ColumnarDataset
from .classification import _standardize_stats
from .linear import fit_linear_regression, linear_predict
from .prediction import PredictionBatch, PredictorEstimator, PredictorModel

__all__ = ["OpLinearRegression", "LinearRegressionModel"]


class OpLinearRegression(PredictorEstimator):
    """Ridge / elastic-net linear regression (Spark's regParam,
    elasticNetParam, maxIter, tol, fitIntercept, standardization), fitted
    by ``linear.fit_linear_regression`` on the standardized matrix."""

    def __init__(self, reg_param: float = 0.0, elastic_net_param: float = 0.0,
                 max_iter: int = 200, tol: float = 1e-7,
                 fit_intercept: bool = True, standardization: bool = True,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="linreg", uid=uid)
        self.reg_param = reg_param
        self.elastic_net_param = elastic_net_param
        self.max_iter = max_iter
        self.tol = tol
        self.fit_intercept = fit_intercept
        self.standardization = standardization
        self.device = device

    def fit_columns(self, data: ColumnarDataset, label_col, features_col):
        y = np.nan_to_num(np.asarray(label_col.values, dtype=np.float32))
        return self.fit_raw(features_col.values, y)

    def fit_raw(self, X, y, w=None, device=None) -> "LinearRegressionModel":
        """Fit on a (N, D) matrix and real labels, on ``device`` (else the
        stage's, else the default device)."""
        dev = resolve_device(device if device is not None else self.device)
        X = torch.as_tensor(X, dtype=torch.float32).to(dev)
        y = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
        wt = None if w is None else torch.as_tensor(
            np.asarray(w, np.float32)).to(dev)
        mu = sigma = None
        if self.standardization:
            mu, sigma = _standardize_stats(X, wt)
            X = (X - mu) / sigma
        fit = fit_linear_regression(
            X, y, sample_weight=wt, reg_param=self.reg_param,
            elastic_net_param=self.elastic_net_param, max_iter=self.max_iter,
            tol=self.tol, fit_intercept=self.fit_intercept)
        coef, icpt = fit.coef, float(fit.intercept)
        if mu is not None:
            # back to raw feature space
            coef = coef / sigma
            icpt = icpt - float(torch.dot(coef, mu))
        return LinearRegressionModel(coef=coef, intercept=icpt)


class LinearRegressionModel(PredictorModel):
    """``coef`` (D,) float32 tensor and ``intercept``; the batch holds the
    prediction only.  An array ``coef`` (a loaded artifact's) goes to
    ``device`` (else the default device); a tensor stays where it is."""

    def __init__(self, coef, intercept: float,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="linreg", uid=uid)
        self.coef = as_device_tensor(coef, torch.float32, device)
        self.intercept = float(intercept)
        self.device = device

    def predict_batch(self, X: torch.Tensor) -> PredictionBatch:
        pred = linear_predict(self.coef, float(np.float32(self.intercept)), X)
        return PredictionBatch(prediction=pred.to(torch.float64))
