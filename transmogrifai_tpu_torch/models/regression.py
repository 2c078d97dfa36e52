"""Regression model stages (counterpart of
``transmogrifai_tpu.models.regression``): ``OpLinearRegression`` and its
fitted ``LinearRegressionModel``; ``OpGeneralizedLinearRegression`` (IRLS
on the card) and ``GLMModel``; ``IsotonicRegressionCalibrator``
(pool-adjacent-violators) and ``IsotonicRegressionModel`` (interpolation
on the card).  The tree regressors live in ``models.trees``.
``LinearRegressionModel.aot_scoring_spec`` gives its prediction as the
serving plane's exportable program (``serving/aot.py``); GLM and
isotonic have none, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import as_device_tensor, resolve_device
from ..types.columns import ColumnarDataset, FeatureColumn
from .classification import _scalar_param, _standardize_stats
from .linear import (_damped_solve, _finite_or, fit_linear_regression,
                     linear_predict)
from .prediction import (AOTScoringSpec, PredictionBatch, PredictorEstimator,
                         PredictorModel)

__all__ = ["OpLinearRegression", "LinearRegressionModel",
           "OpGeneralizedLinearRegression", "GLMModel",
           "IsotonicRegressionCalibrator", "IsotonicRegressionModel"]


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


def _aot_linear(X, coef, intercept):
    # the exportable scoring program: the prediction only
    return (linear_predict(coef, intercept, X),)


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

    def aot_scoring_spec(self) -> AOTScoringSpec:
        """The prediction-only program (``serving/aot.py``)."""
        return AOTScoringSpec(
            name="linreg", fn=_aot_linear,
            params=(self.coef, _scalar_param(self.intercept, self.coef)),
            outputs=("prediction",), n_features=int(self.coef.shape[-1]))


#: each GLM family's canonical link (the JAX package's table)
GLM_LINKS = {"gaussian": "identity", "poisson": "log", "gamma": "log",
             "binomial": "logit"}


class OpGeneralizedLinearRegression(PredictorEstimator):
    """Generalized linear regression (Spark's GLR parameters: family,
    link, regParam, maxIter, tol, fitIntercept).  Gaussian with the
    identity link is ``fit_linear_regression``'s ridge solve on the raw
    matrix; poisson, gamma and binomial run IRLS (``fit_glm_irls``) on the
    card.  Row weights are not used, as in the JAX package."""

    def __init__(self, family: str = "gaussian", link: Optional[str] = None,
                 reg_param: float = 0.0, max_iter: int = 50,
                 tol: float = 1e-6, fit_intercept: bool = True,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="glm", uid=uid)
        self.family = family
        self.link = link or GLM_LINKS[family]
        self.reg_param = reg_param
        self.max_iter = max_iter
        self.tol = tol
        self.fit_intercept = fit_intercept
        self.device = device

    def fit_columns(self, data: ColumnarDataset, label_col, features_col):
        y = np.nan_to_num(np.asarray(label_col.values, dtype=np.float32))
        return self.fit_raw(features_col.values, y)

    def fit_raw(self, X, y, w=None, device=None) -> "GLMModel":
        """Fit on a (N, D) matrix and labels, on ``device`` (else the
        stage's, else the default device).  ``metadata["n_iter"]`` holds
        the IRLS iterations (1 for the gaussian solve)."""
        dev = resolve_device(device if device is not None else self.device)
        X = torch.as_tensor(X, dtype=torch.float32).to(dev)
        y = torch.as_tensor(np.asarray(y, np.float32)).to(dev)
        if self.family == "gaussian" and self.link == "identity":
            fit = fit_linear_regression(
                X, y, reg_param=self.reg_param, max_iter=self.max_iter,
                tol=self.tol, fit_intercept=self.fit_intercept)
            coef, icpt, it = fit.coef, float(fit.intercept), 1
        else:
            coef, icpt, it = fit_glm_irls(
                X, y, self.family, self.link, self.reg_param, self.max_iter,
                self.tol, self.fit_intercept)
        self.metadata["n_iter"] = it
        return GLMModel(coef=coef, intercept=icpt, link=self.link)


def _glm_inv_link(link: str, eta: torch.Tensor) -> torch.Tensor:
    if link == "log":
        return torch.exp(torch.clamp(eta, -30, 30))
    if link == "logit":
        return torch.sigmoid(eta)
    return eta


def fit_glm_irls(X: torch.Tensor, y: torch.Tensor, family: str, link: str,
                 reg: float, max_iter: int, tol: float,
                 fit_intercept: bool):
    """The JAX package's IRLS: from zero coefficients, each step solves
    the weighted normal equations (A + reg I on the features) b / n with
    working weights (dmu/deta)^2 / V(mu) and working response eta + (y -
    mu) / (dmu/deta), by the damped Cholesky solve, keeping the last
    finite iterate, until the largest coefficient move is at most ``tol``
    or ``max_iter`` steps.  Variances and derivatives are floored at
    1e-8, log-link margins clipped to [-30, 30].  Returns (coef (D,) tensor,
    intercept float, iterations)."""
    n, d = X.shape
    dev = X.device
    Xa = (torch.cat([X, torch.ones((n, 1), dtype=X.dtype, device=dev)], 1)
          if fit_intercept else X)
    diag = torch.arange(d, device=dev)

    def variance(mu):
        if family == "poisson":
            return torch.clamp(mu, min=1e-8)
        if family == "gamma":
            return torch.clamp(mu * mu, min=1e-8)
        if family == "binomial":
            return torch.clamp(mu * (1 - mu), min=1e-8)
        return torch.ones_like(mu)

    def dmu_deta(eta, mu):
        if link == "log":
            return torch.clamp(mu, min=1e-8)
        if link == "logit":
            return torch.clamp(mu * (1 - mu), min=1e-8)
        return torch.ones_like(eta)

    beta = torch.zeros(Xa.shape[1], dtype=torch.float32, device=dev)
    dn, it = float("inf"), 0
    while dn > tol and it < max_iter:
        eta = Xa @ beta
        mu = _glm_inv_link(link, eta)
        gp = dmu_deta(eta, mu)
        wirls = gp * gp / variance(mu)
        z = eta + (y - mu) / gp
        Xw = Xa * wirls[:, None]
        A = Xw.T @ Xa / n
        A[diag, diag] += reg
        b = Xw.T @ z / n
        del Xw
        nb = _finite_or(_damped_solve(A, b), beta)
        dn = float(torch.max(torch.abs(nb - beta)))
        beta, it = nb, it + 1
    icpt = float(beta[d]) if fit_intercept else 0.0
    return beta[:d].clone(), icpt, it


class GLMModel(PredictorModel):
    """A fitted GLM: ``coef`` (D,) float32 on the model's device (an array
    or list, a loaded artifact's, goes to ``device``), ``intercept`` and
    ``link``; the prediction is the inverse link of X coef + intercept."""

    def __init__(self, coef, intercept: float, link: str = "identity",
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="glm", uid=uid)
        self.coef = as_device_tensor(coef, torch.float32, device)
        self.intercept = float(intercept)
        self.link = link
        self.device = device

    def predict_batch(self, X: torch.Tensor) -> PredictionBatch:
        eta = X.to(torch.float32) @ self.coef.to(X.device) + self.intercept
        if self.link == "log":
            pred = torch.exp(eta)
        elif self.link == "logit":
            pred = 1 / (1 + torch.exp(-eta))
        else:
            pred = eta
        return PredictionBatch(prediction=pred.to(torch.float64))


def _score_values(score_col) -> np.ndarray:
    """A score column's values as float64: a prediction's class-1
    probability, else the numbers with missing entries as 0."""
    vals = score_col.values
    proba = getattr(vals, "probability", None)
    if proba is not None:
        return np.asarray(torch.as_tensor(proba[:, 1]).cpu(), np.float64)
    v = np.asarray(vals, np.float64)
    mask = (np.ones(len(v), bool) if score_col.mask is None
            else np.asarray(score_col.mask))
    return np.where(mask, np.nan_to_num(v), 0.0)


class IsotonicRegressionCalibrator(PredictorEstimator):
    """Isotonic (or, with ``isotonic=False``, antitonic) calibration of a
    score against the label by pool-adjacent-violators: the JAX package's
    blocks and values (its sort order and its pooling arithmetic), with a
    stack of contiguous blocks in place of its list slicing (O(N) after
    the sort).  Inputs: the label and the score (a prediction's class-1
    probability, or a number)."""

    def __init__(self, isotonic: bool = True, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="isoreg", uid=uid)
        self.isotonic = isotonic
        self.device = device

    def fit_columns(self, data: ColumnarDataset, label_col, score_col):
        y = np.nan_to_num(np.asarray(label_col.values, np.float64))
        return self.fit_raw(_score_values(score_col), y)

    def fit_raw(self, x, y, w=None, device=None) -> "IsotonicRegressionModel":
        """Fit on scores ``x`` (N,) and labels ``y`` (N,) (host arrays or
        tensors); the model lives on ``device`` (else the stage's, else the
        default device).  ``metadata["blocks"]`` counts the blocks."""
        x = np.asarray(torch.as_tensor(x).cpu(), np.float64).reshape(-1)
        y = np.asarray(torch.as_tensor(y).cpu(), np.float64).reshape(-1)
        sign = 1.0 if self.isotonic else -1.0
        order = np.argsort(x)
        xs, ys = x[order], sign * y[order]
        # blocks as [start, end) ranges of the sorted rows, pooled as the
        # JAX package pools them: (v1 w1 + v2 w2) / (w1 + w2), left to right
        vals, wts, starts = [], [], []
        for i, yi in enumerate(ys.tolist()):
            vals.append(yi)
            wts.append(1.0)
            starts.append(i)
            while len(vals) > 1 and vals[-2] > vals[-1]:
                v = ((vals[-2] * wts[-2] + vals[-1] * wts[-1])
                     / (wts[-2] + wts[-1]))
                w = wts[-2] + wts[-1]
                vals.pop()
                wts.pop()
                starts.pop()
                vals[-1], wts[-1] = v, w
        ends = starts[1:] + [len(xs)]
        bx = [float(np.mean(xs[a:b])) for a, b in zip(starts, ends)]
        by = [sign * v for v in vals]
        self.metadata["blocks"] = len(bx)
        dev = resolve_device(device if device is not None else self.device)
        return IsotonicRegressionModel(boundaries=bx, predictions=by,
                                       device=str(dev))


class IsotonicRegressionModel(PredictorModel):
    """Piecewise-linear interpolation through (``boundaries``,
    ``predictions``), float64 tensors on the model's device, with
    ``np.interp``'s rule and arithmetic: constant past the ends, the
    prediction itself at a boundary, else slope x (x - x_j) + y_j from
    the last boundary x_j at or below x."""

    def __init__(self, boundaries, predictions, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="isoreg", uid=uid)
        self.boundaries = as_device_tensor(boundaries, torch.float64, device)
        self.predictions = as_device_tensor(predictions, torch.float64,
                                            device)
        self.device = device

    def interpolate(self, x: torch.Tensor) -> torch.Tensor:
        """(N,) float64 calibrated values of the scores ``x`` (N,)."""
        xp = self.boundaries.to(x.device)
        fp = self.predictions.to(x.device)
        x = x.to(torch.float64).contiguous()
        m = xp.shape[0]
        j = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0,
                        max(m - 2, 0))
        x0, y0 = xp[j], fp[j]
        if m > 1:
            x1, y1 = xp[j + 1], fp[j + 1]
            mid = (y1 - y0) / (x1 - x0) * (x - x0) + y0
        else:
            mid = y0.expand_as(x)
        out = torch.where(x == x0, y0, mid)
        out = torch.where(x < xp[0], fp[0], out)
        return torch.where(x >= xp[-1], fp[-1], out)

    def predict_batch(self, X: torch.Tensor) -> PredictionBatch:
        x = torch.as_tensor(X).reshape(len(X), -1)[:, 0]
        return PredictionBatch(prediction=self.interpolate(x))

    def transform_columns(self, label_col, score_col) -> FeatureColumn:
        x = torch.from_numpy(_score_values(score_col)).to(
            self.boundaries.device)
        return FeatureColumn(self.output_type, self.predict_batch(x[:, None]))
