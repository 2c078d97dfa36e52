"""Linear classification stages (counterpart of
``transmogrifai_tpu.models.classification``): ``OpLogisticRegression``,
binary or multinomial, ``OpLinearSVC`` and ``OpNaiveBayes``, and their
fitted models.  Each fit and predict is a few plain torch operations on
the device (no hand-written kernel: the JAX package computes them outside
any Pallas kernel).

Naive Bayes also fits streaming (``begin_fit``..``finish_fit``): its
sufficient statistics, class counts and per-class feature sums, add up
chunk by chunk on the card, so an out-of-core train never holds its
matrix.  Each fitted model also gives its scoring as an
``AOTScoringSpec`` (``aot_scoring_spec``), the program the serving plane
exports and captures once per shape bucket: the helpers its
``predict_batch`` calls, in the JAX package's output order.  Not ported
yet: the sharded fit (ROADMAP Queue A item 6.7).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import as_device_tensor, resolve_device
from ..types.columns import ColumnarDataset
from .linear import (fit_linear_svc, fit_logistic_regression,
                     fit_multinomial_logreg, fit_naive_bayes,
                     logreg_predict_proba, naive_bayes_predict_log_proba,
                     softmax_predict_proba, svc_decision)
from .prediction import (AOTScoringSpec, PredictionBatch, PredictorEstimator,
                         PredictorModel)

__all__ = ["OpLogisticRegression", "LogisticRegressionModel", "OpLinearSVC",
           "LinearSVCModel", "OpNaiveBayes", "NaiveBayesModel"]


def _labels(label_col) -> np.ndarray:
    return np.nan_to_num(np.asarray(label_col.values, dtype=np.float32))


def _weights(w, dev) -> Optional[torch.Tensor]:
    return None if w is None else torch.as_tensor(
        np.asarray(w, np.float32)).to(dev)


# -- scoring programs (serving/aot.py) ---------------------------------------
# Pure functions of (X, *params) at fixed shapes over the helpers that
# predict_batch calls, so that a captured program scores as the eager path
# does; they return the JAX package's outputs in its order, the prediction
# float32 as in the JAX programs.

def _aot_logreg_binary(X, coef, intercept):
    proba, raw = logreg_predict_proba(coef, intercept, X)
    return (proba[:, 1] >= 0.5).to(torch.float32), raw, proba


def _aot_softmax(X, coef, intercept):
    proba, raw = softmax_predict_proba(coef, intercept, X)
    return proba.argmax(dim=1).to(torch.float32), raw, proba


def _aot_svc(X, coef, intercept):
    z = svc_decision(coef, intercept, X)
    return (z >= 0).to(torch.float32), torch.stack([-z, z], 1)


def _aot_naive_bayes(X, log_prior, log_lik):
    logp = naive_bayes_predict_log_proba(log_prior, log_lik, X)
    proba = torch.exp(logp)
    return proba.argmax(dim=1).to(torch.float32), logp, proba


def _scalar_param(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float intercept as a 0-dim float32 parameter beside ``like``."""
    return torch.tensor(np.float32(value), device=like.device)


class OpLogisticRegression(PredictorEstimator):
    """L2/elastic-net logistic regression (Spark's regParam,
    elasticNetParam, maxIter, tol, fitIntercept, standardization), fitted
    on the standardized matrix by ``linear.fit_logistic_regression`` for
    labels in {0, 1}, by ``linear.fit_multinomial_logreg`` for K > 2
    classes (K = the largest label + 1).  ``sample_weight_col`` names a
    numeric column of the dataset whose values weight the rows of a
    workflow fit."""

    def __init__(self, reg_param: float = 0.0, elastic_net_param: float = 0.0,
                 max_iter: int = 50, tol: float = 1e-6,
                 fit_intercept: bool = True, standardization: bool = True,
                 sample_weight_col: Optional[str] = None,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="logreg", uid=uid)
        self.reg_param = reg_param
        self.elastic_net_param = elastic_net_param
        self.max_iter = max_iter
        self.tol = tol
        self.fit_intercept = fit_intercept
        self.standardization = standardization
        self.sample_weight_col = sample_weight_col
        self.device = device

    def fit_columns(self, data: ColumnarDataset, label_col, features_col):
        w = None
        if self.sample_weight_col and self.sample_weight_col in data:
            w = np.asarray(data[self.sample_weight_col].values, np.float32)
        return self.fit_raw(features_col.values, _labels(label_col), w)

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
        wt = _weights(w, dev)
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

    def aot_scoring_spec(self) -> AOTScoringSpec:
        outputs = ("prediction", "rawPrediction", "probability")
        if self.coef.dim() == 1:
            return AOTScoringSpec(
                name="logreg.binary", fn=_aot_logreg_binary,
                params=(self.coef, _scalar_param(self.intercept, self.coef)),
                outputs=outputs, n_features=int(self.coef.shape[-1]))
        return AOTScoringSpec(
            name="logreg.softmax", fn=_aot_softmax,
            params=(self.coef, self._intercept), outputs=outputs,
            n_features=int(self.coef.shape[-1]))


class OpLinearSVC(PredictorEstimator):
    """Squared-hinge linear SVM (Spark's regParam, maxIter, tol,
    fitIntercept, standardization), fitted on the standardized matrix by
    ``linear.fit_linear_svc``; labels in {0, 1}.  ``metadata["n_iter"]``
    counts its Newton steps."""

    def __init__(self, reg_param: float = 1e-4, max_iter: int = 100,
                 tol: float = 1e-6, fit_intercept: bool = True,
                 standardization: bool = True,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="linsvc", uid=uid)
        self.reg_param = reg_param
        self.max_iter = max_iter
        self.tol = tol
        self.fit_intercept = fit_intercept
        self.standardization = standardization
        self.device = device

    def fit_columns(self, data: ColumnarDataset, label_col, features_col):
        return self.fit_raw(features_col.values, _labels(label_col))

    def fit_raw(self, X, y, w=None, device=None) -> "LinearSVCModel":
        """Fit on a (N, D) matrix and labels in {0, 1}, on ``device``
        (else the stage's, else the default device); the coefficients
        come back in raw feature space."""
        dev = resolve_device(device if device is not None else self.device)
        X = torch.as_tensor(X, dtype=torch.float32).to(dev)
        wt = _weights(w, dev)
        mu = sigma = None
        if self.standardization:
            mu, sigma = _standardize_stats(X, wt)
            X = (X - mu) / sigma
        fit = fit_linear_svc(
            X, torch.as_tensor(np.asarray(y, np.float32)).to(dev),
            sample_weight=wt, reg_param=self.reg_param,
            max_iter=self.max_iter, tol=self.tol,
            fit_intercept=self.fit_intercept)
        self.metadata["n_iter"] = fit.n_iter
        coef, icpt = fit.coef, float(fit.intercept)
        if mu is not None:
            coef = coef / sigma
            icpt = icpt - float(torch.dot(coef, mu))
        return LinearSVCModel(coef=coef, intercept=icpt)


class LinearSVCModel(PredictorModel):
    """``coef`` (D,) float32 tensor and the float ``intercept``; a row's
    raw prediction is (-z, z) of its margin z, its prediction z >= 0.  An
    array ``coef`` (a loaded artifact's) goes to ``device`` (else the
    default device)."""

    def __init__(self, coef, intercept: float, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="linsvc", uid=uid)
        self.coef = as_device_tensor(coef, torch.float32, device)
        self.intercept = float(intercept)
        self.device = device

    def predict_batch(self, X: torch.Tensor) -> PredictionBatch:
        z = svc_decision(self.coef, self.intercept, X)
        return PredictionBatch(prediction=(z >= 0).to(torch.float64),
                               raw_prediction=torch.stack([-z, z], 1))

    def aot_scoring_spec(self) -> AOTScoringSpec:
        return AOTScoringSpec(
            name="linsvc", fn=_aot_svc,
            params=(self.coef, _scalar_param(self.intercept, self.coef)),
            outputs=("prediction", "rawPrediction"),
            n_features=int(self.coef.shape[-1]))


class OpNaiveBayes(PredictorEstimator):
    """Multinomial naive Bayes (Spark's OpNaiveBayes, ``smoothing`` 1.0)
    on the feature matrix clipped at 0; K = the largest label + 1, at
    least 2.

    The streaming state maps each label value to [its row count, its
    float64 (D,) feature sums on the chunk's device]; a chunk adds one
    float32 product a class, summed in another order than the JAX
    package's host product (log likelihoods within 1e-5 on indicator
    columns, within 1e-4 with real-valued ones)."""

    supports_streaming_fit = True

    def __init__(self, smoothing: float = 1.0,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="naivebayes", uid=uid)
        self.smoothing = smoothing
        self.device = device

    def fit_columns(self, data: ColumnarDataset, label_col, features_col):
        return self.fit_raw(features_col.values, _labels(label_col))

    def fit_raw(self, X, y, w=None, device=None) -> "NaiveBayesModel":
        dev = resolve_device(device if device is not None else self.device)
        X = torch.as_tensor(X, dtype=torch.float32).to(dev)
        y = np.asarray(y)
        n_classes = max(int(y.max()) + 1 if len(y) else 2, 2)
        log_prior, log_lik = fit_naive_bayes(
            X, torch.from_numpy(y.astype(np.int64)).to(dev),
            n_classes=n_classes, sample_weight=_weights(w, dev),
            smoothing=self.smoothing)
        return NaiveBayesModel(log_prior=log_prior, log_lik=log_lik)

    def begin_fit(self):
        return {}

    def update_chunk(self, state, data, label_col, features_col):
        y = _labels(label_col)
        X = as_device_tensor(features_col.values, torch.float32,
                             self.device)
        Xc = torch.clamp(X.to(torch.float32), min=0.0)
        yt = torch.from_numpy(y).to(Xc.device)
        for uv in np.unique(y):
            sums = ((yt == float(uv)).to(torch.float32) @ Xc).to(
                torch.float64)
            cnt = int((y == uv).sum())
            ent = state.get(float(uv))
            if ent is None:
                state[float(uv)] = [cnt, sums]
            else:
                ent[0] += cnt
                ent[1] = ent[1] + sums
        return state

    def merge_states(self, a, b):
        for k, (cnt, sums) in b.items():
            ent = a.get(k)
            if ent is None:
                a[k] = [cnt, sums]
            else:
                ent[0] += cnt
                ent[1] = ent[1] + sums
        return a

    def export_fit_state(self, state):
        """The state as the JAX package keeps it: each class's sums as a
        host float64 array, so that a saved state reads in either
        package."""
        return {k: [cnt, sums.detach().cpu().numpy()]
                for k, (cnt, sums) in state.items()}

    def import_fit_state(self, payload):
        """A JAX-form state (host arrays) with the sums back on this
        estimator's device."""
        dev = resolve_device(self.device)
        return {float(k): [int(cnt), torch.as_tensor(
                    np.asarray(sums, np.float64)).to(dev)]
                for k, (cnt, sums) in payload.items()}

    def finish_fit(self, state) -> "NaiveBayesModel":
        if not state:
            raise ValueError("NaiveBayes streaming fit saw no rows")
        n_classes = max(int(max(state)) + 1, 2)
        first = next(iter(state.values()))[1]
        d, dev = first.shape[0], first.device
        class_count = torch.zeros(n_classes, dtype=torch.float64, device=dev)
        feat_count = torch.zeros((n_classes, d), dtype=torch.float64,
                                 device=dev)
        for k, (cnt, sums) in state.items():
            class_count[int(k)] = cnt
            feat_count[int(k)] = sums
        log_prior = (torch.log(class_count + 1e-12)
                     - torch.log(torch.clamp(class_count.sum(), min=1e-12)))
        log_lik = (torch.log(feat_count + self.smoothing)
                   - torch.log(feat_count.sum(1, keepdim=True)
                               + self.smoothing * d))
        return NaiveBayesModel(log_prior=log_prior.to(torch.float32),
                               log_lik=log_lik.to(torch.float32))


class NaiveBayesModel(PredictorModel):
    """``log_prior`` (K,) and ``log_lik`` (K, D) float32 tensors; a row's
    raw prediction is its log posteriors, its probability their exp, its
    prediction the argmax."""

    def __init__(self, log_prior, log_lik, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="naivebayes", uid=uid)
        self.log_prior = as_device_tensor(log_prior, torch.float32, device)
        self.log_lik = as_device_tensor(log_lik, torch.float32, device)
        self.device = device

    def predict_batch(self, X: torch.Tensor) -> PredictionBatch:
        logp = naive_bayes_predict_log_proba(self.log_prior, self.log_lik, X)
        proba = torch.exp(logp)
        return PredictionBatch(
            prediction=proba.argmax(dim=1).to(torch.float64),
            raw_prediction=logp, probability=proba)

    def aot_scoring_spec(self) -> AOTScoringSpec:
        return AOTScoringSpec(
            name="naivebayes", fn=_aot_naive_bayes,
            params=(self.log_prior, self.log_lik),
            outputs=("prediction", "rawPrediction", "probability"),
            n_features=int(self.log_lik.shape[-1]))
