"""Linear classification stages (counterpart of
``transmogrifai_tpu.models.classification``): ``OpLogisticRegression``,
binary or multinomial, and its fitted ``LogisticRegressionModel``.

Not ported yet (ROADMAP Queue A): OpLinearSVC, OpNaiveBayes, the sharded
fit and the AOT scoring specs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import as_device_tensor, resolve_device
from ..types.columns import ColumnarDataset
from .linear import (fit_logistic_regression, fit_multinomial_logreg,
                     logreg_predict_proba, softmax_predict_proba)
from .prediction import PredictionBatch, PredictorEstimator, PredictorModel

__all__ = ["OpLogisticRegression", "LogisticRegressionModel"]


class OpLogisticRegression(PredictorEstimator):
    """L2/elastic-net logistic regression (Spark's regParam,
    elasticNetParam, maxIter, tol, fitIntercept, standardization), fitted
    on the standardized matrix by ``linear.fit_logistic_regression`` for
    labels in {0, 1}, by ``linear.fit_multinomial_logreg`` for K > 2
    classes (K = the largest label + 1)."""

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
        """Fit on a (N, D) matrix and labels in {0, .., K-1}, on
        ``device`` (else the stage's, else the default device).  The
        coefficients come back in raw feature space, per class for K >
        2."""
        dev = resolve_device(device if device is not None else self.device)
        X = torch.as_tensor(X, dtype=torch.float32).to(dev)
        y = np.asarray(y, np.float32)
        finite = y[~np.isnan(y)]
        n_classes = max(int(finite.max()) + 1 if len(finite) else 2, 2)
        wt = None if w is None else torch.as_tensor(
            np.asarray(w, np.float32)).to(dev)
        mu = sigma = None
        if self.standardization:
            mu, sigma = _standardize_stats(X, wt)
            X = (X - mu) / sigma
        kw = dict(sample_weight=wt, reg_param=self.reg_param,
                  elastic_net_param=self.elastic_net_param,
                  max_iter=self.max_iter, tol=self.tol,
                  fit_intercept=self.fit_intercept)
        if n_classes > 2:
            fit = fit_multinomial_logreg(
                X, torch.from_numpy(y.astype(np.int64)).to(dev),
                n_classes=n_classes, **kw)
            coef, icpt = fit.coef, fit.intercept
            if mu is not None:
                # back to raw feature space, class by class
                coef = coef / sigma
                icpt = icpt - coef @ mu
            return LogisticRegressionModel(coef=coef, intercept=icpt)
        fit = fit_logistic_regression(X, torch.from_numpy(y).to(dev), **kw)
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
    """Binary: ``coef`` (D,) float32 tensor and the float ``intercept``;
    multinomial: ``coef`` (K, D) and ``intercept`` a list of K floats (the
    artifact's form), also kept as a (K,) tensor on ``coef``'s device for
    scoring.  An array ``coef`` (a loaded artifact's) goes to ``device``
    (else the default device); a tensor stays where it is."""

    def __init__(self, coef, intercept, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="logreg", uid=uid)
        self.coef = as_device_tensor(coef, torch.float32, device)
        if self.coef.dim() == 1:
            self.intercept = float(intercept)
        else:
            self.intercept = [float(v) for v in torch.as_tensor(
                intercept).reshape(-1).tolist()]
            self._intercept = torch.tensor(
                self.intercept, dtype=torch.float32, device=self.coef.device)
        self.device = device

    def predict_batch(self, X: torch.Tensor) -> PredictionBatch:
        if self.coef.dim() == 1:
            proba, raw = logreg_predict_proba(self.coef, self.intercept, X)
            return PredictionBatch(
                prediction=(proba[:, 1] >= 0.5).to(torch.float64),
                raw_prediction=raw, probability=proba)
        proba, raw = softmax_predict_proba(self.coef, self._intercept, X)
        return PredictionBatch(
            prediction=proba.argmax(dim=1).to(torch.float64),
            raw_prediction=raw, probability=proba)
