"""Linear classification stages (counterpart of
``transmogrifai_tpu.models.classification``): binary
``OpLogisticRegression`` and its fitted ``LogisticRegressionModel``.

Not ported yet (ROADMAP Queue A): the multinomial fit, OpLinearSVC,
OpNaiveBayes, the sharded fit and the AOT scoring specs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..types.columns import ColumnarDataset
from .linear import fit_logistic_regression, logreg_predict_proba
from .prediction import PredictionBatch, PredictorEstimator, PredictorModel

__all__ = ["OpLogisticRegression", "LogisticRegressionModel"]


class OpLogisticRegression(PredictorEstimator):
    """L2/elastic-net binary logistic regression (Spark's regParam,
    elasticNetParam, maxIter, tol, fitIntercept, standardization), fitted
    by ``linear.fit_logistic_regression`` on the standardized matrix."""

    def __init__(self, reg_param: float = 0.0, elastic_net_param: float = 0.0,
                 max_iter: int = 50, tol: float = 1e-6,
                 fit_intercept: bool = True, standardization: bool = True,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="logreg", uid=uid)
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

    def fit_raw(self, X, y, w=None, device=None) -> "LogisticRegressionModel":
        """Fit on a (N, D) matrix and labels in {0, 1}, on ``device`` (else
        the stage's, else the default device)."""
        dev = resolve_device(device if device is not None else self.device)
        X = torch.as_tensor(X, dtype=torch.float32).to(dev)
        y = np.asarray(y, np.float32)
        if len(y) and float(np.nanmax(y)) > 1:
            raise NotImplementedError(
                "multinomial logistic regression is not ported yet "
                "(ROADMAP Queue A)")
        wt = None if w is None else torch.as_tensor(
            np.asarray(w, np.float32)).to(dev)
        mu = sigma = None
        if self.standardization:
            mu, sigma = _standardize_stats(X, wt)
            X = (X - mu) / sigma
        fit = fit_logistic_regression(
            X, torch.from_numpy(y).to(dev), sample_weight=wt,
            reg_param=self.reg_param,
            elastic_net_param=self.elastic_net_param, max_iter=self.max_iter,
            tol=self.tol, fit_intercept=self.fit_intercept)
        coef, icpt = fit.coef, float(fit.intercept)
        if mu is not None:
            # back to raw feature space
            coef = coef / sigma
            icpt = icpt - float(torch.dot(coef, mu))
        return LogisticRegressionModel(coef=coef, intercept=icpt)


def _standardize_stats(X: torch.Tensor, w: Optional[torch.Tensor]):
    """(Weighted) column mean and population standard deviation, float32;
    a deviation below 1e-12 becomes 1."""
    Xd = X.to(torch.float64)
    if w is None:
        mu = Xd.mean(0)
        sigma = Xd.std(0, unbiased=False)
    else:
        wd = w.to(torch.float64)
        ws = torch.clamp(wd.sum(), min=1e-12)
        mu = (wd[:, None] * Xd).sum(0) / ws
        sigma = torch.sqrt((wd[:, None] * (Xd - mu) ** 2).sum(0) / ws)
    sigma = torch.where(sigma < 1e-12, 1.0, sigma)
    return mu.to(torch.float32), sigma.to(torch.float32)


class LogisticRegressionModel(PredictorModel):
    """Binary model: ``coef`` (D,) float32 tensor and ``intercept``."""

    def __init__(self, coef: torch.Tensor, intercept: float,
                 uid: Optional[str] = None):
        super().__init__(operation_name="logreg", uid=uid)
        self.coef = coef
        self.intercept = float(intercept)

    def predict_batch(self, X: torch.Tensor) -> PredictionBatch:
        proba, raw = logreg_predict_proba(self.coef, self.intercept, X)
        return PredictionBatch(
            prediction=(proba[:, 1] >= 0.5).to(torch.float64),
            raw_prediction=raw, probability=proba)
