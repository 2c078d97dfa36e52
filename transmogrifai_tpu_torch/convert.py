"""Carry fitted state of the JAX package's slice stages into the port.

Each function takes the port's (unfitted) estimator — already wired into
the port's feature DAG — plus the fitted state of the matching JAX stage
as numpy arrays and plain Python values, and returns the port's fitted
model answering for that estimator's output feature.  ``workflow_model``
assembles the fitted stages into a scorable ``OpWorkflowModel``.  This
module never imports the JAX package: callers extract the arrays.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .device import resolve_device
from .features.feature import Feature
from .models.classification import (LinearSVCModel,
                                     LogisticRegressionModel,
                                     NaiveBayesModel)
from .models.mlp import MLPClassificationModel
from .models.prediction import PredictorModel
from .models.regression import LinearRegressionModel
from .models.trees import TreeEnsembleModel
from .ops.vectorizers import (IntegralVectorizer, OneHotVectorizer,
                              OneHotVectorizerModel, RealVectorizer,
                              RealVectorizerModel)
from .preparators.sanity_checker import SanityChecker, SanityCheckerModel
from .selector.combiner import SelectedCombinerModel, SelectedModelCombiner
from .selector.model_selector import ModelSelector, SelectedModel
from .stages.base import Estimator, Model, PipelineStage
from .workflow.dag import compute_dag
from .workflow.workflow import OpWorkflowModel

__all__ = ["real_vectorizer", "one_hot_vectorizer", "sanity_checker",
           "tree_ensemble_model", "tree_ensemble",
           "logistic_regression_model", "mlp_model",
           "linear_regression_model", "linear_svc_model",
           "naive_bayes_model", "selected_model", "selected_combiner",
           "workflow_model"]


def real_vectorizer(est: Union[RealVectorizer, IntegralVectorizer],
                    fills: Sequence[float],
                    track_nulls: bool = True) -> RealVectorizerModel:
    """Fill values per input feature (``RealVectorizerModel.fills``), for
    a ``RealVectorizer`` or an ``IntegralVectorizer`` (whose fitted stage
    is a ``RealVectorizerModel`` in both packages)."""
    return est.adopt_model(RealVectorizerModel(
        fills=[float(v) for v in fills], track_nulls=track_nulls,
        device=est.device))


def one_hot_vectorizer(est: OneHotVectorizer, vocabs: Sequence[Sequence[str]],
                       track_nulls: bool = True,
                       unseen_to_other: bool = True) -> OneHotVectorizerModel:
    """Pivot vocabularies per input feature (``OneHotVectorizerModel.vocabs``)."""
    return est.adopt_model(OneHotVectorizerModel(
        vocabs=[list(v) for v in vocabs], track_nulls=track_nulls,
        unseen_to_other=unseen_to_other, device=est.device))


def sanity_checker(est: SanityChecker, keep_indices: Sequence[int],
                   dropped: Sequence[str] = ()) -> SanityCheckerModel:
    """Kept column indices; ``dropped`` (the summary's dropped column
    names) is carried into the estimator's metadata."""
    est.metadata["summary"] = {"dropped": list(dropped)}
    return est.adopt_model(SanityCheckerModel(
        keep_indices=[int(i) for i in keep_indices]))


def tree_ensemble_model(mode: str, edges: np.ndarray, feat: np.ndarray,
                        thresh: np.ndarray, leaf: np.ndarray,
                        base_score: float = 0.0, n_classes: int = 2,
                        device=None) -> TreeEnsembleModel:
    """A ``TreeEnsembleModel`` (``gbdt_binary``, ``gbdt_multi`` — leaf
    (T, 2^d, K) of K class margins —, ``gbdt_reg``, ``rf_cls`` — leaf (T,
    2^d, K) of K class shares — or ``rf_reg``) from its
    edges/feat/thresh/leaf arrays, its trees on ``device`` (else the
    default device)."""
    dev = resolve_device(device)
    return TreeEnsembleModel(
        mode=mode, edges=np.asarray(edges, np.float32),
        feat=torch.tensor(np.asarray(feat, np.int32), device=dev),
        thresh=torch.tensor(np.asarray(thresh, np.int32), device=dev),
        leaf=torch.tensor(np.asarray(leaf, np.float32), device=dev),
        base_score=float(base_score), n_classes=n_classes)


def tree_ensemble(est: Estimator, mode: str, edges: np.ndarray,
                  feat: np.ndarray, thresh: np.ndarray, leaf: np.ndarray,
                  base_score: float, n_classes: int = 2
                  ) -> TreeEnsembleModel:
    """A tree estimator's fitted ensemble, on the estimator's device."""
    return est.adopt_model(tree_ensemble_model(
        mode, edges, feat, thresh, leaf, base_score, n_classes,
        device=getattr(est, "device", None)))


def logistic_regression_model(coef: np.ndarray, intercept,
                              device=None) -> LogisticRegressionModel:
    """A ``LogisticRegressionModel`` from its coefficients and intercept,
    on ``device`` (else the default device): binary, (D,) and a float;
    multinomial, (K, D) and K intercepts."""
    coef = np.asarray(coef, np.float32)
    return LogisticRegressionModel(
        torch.tensor(coef, device=resolve_device(device)),
        float(intercept) if coef.ndim == 1
        else [float(v) for v in np.asarray(intercept).reshape(-1)])


def mlp_model(weights, mu: np.ndarray, sigma: np.ndarray,
              device=None) -> MLPClassificationModel:
    """An ``MLPClassificationModel`` from its layer list ``[[W (fan_in,
    fan_out), b (fan_out,)], ...]`` and input standardization, on
    ``device`` (else the default device)."""
    dev = resolve_device(device)
    return MLPClassificationModel(
        weights=[[torch.tensor(np.asarray(W, np.float32), device=dev),
                  torch.tensor(np.asarray(b, np.float32), device=dev)]
                 for W, b in weights],
        mu=torch.tensor(np.asarray(mu, np.float32), device=dev),
        sigma=torch.tensor(np.asarray(sigma, np.float32), device=dev))


def linear_regression_model(coef: np.ndarray, intercept: float,
                            device=None) -> LinearRegressionModel:
    """A ``LinearRegressionModel`` from its (D,) coefficients and
    intercept, on ``device`` (else the default device)."""
    return LinearRegressionModel(
        torch.tensor(np.asarray(coef, np.float32),
                     device=resolve_device(device)), float(intercept))


def linear_svc_model(coef: np.ndarray, intercept: float,
                     device=None) -> LinearSVCModel:
    """A ``LinearSVCModel`` from its (D,) coefficients and intercept, on
    ``device`` (else the default device)."""
    return LinearSVCModel(
        torch.tensor(np.asarray(coef, np.float32),
                     device=resolve_device(device)), float(intercept))


def naive_bayes_model(log_prior: np.ndarray, log_lik: np.ndarray,
                      device=None) -> NaiveBayesModel:
    """A ``NaiveBayesModel`` from its (K,) log priors and (K, D) log
    likelihoods, on ``device`` (else the default device)."""
    dev = resolve_device(device)
    return NaiveBayesModel(
        torch.tensor(np.asarray(log_prior, np.float32), device=dev),
        torch.tensor(np.asarray(log_lik, np.float32), device=dev))


def selected_model(est: ModelSelector, inner: PredictorModel,
                   best_name: str, best_params: dict,
                   summary: Optional[dict] = None) -> SelectedModel:
    """A fitted selector: the winner ``inner`` (built by
    ``logistic_regression_model``, ``linear_regression_model``,
    ``linear_svc_model``, ``naive_bayes_model``, ``mlp_model`` or
    ``tree_ensemble_model``) with its
    name and params; ``summary`` (the JAX selector's
    ``model_selector_summary``) is carried into the estimator's
    metadata."""
    if summary is not None:
        est.metadata["model_selector_summary"] = summary
    return est.adopt_model(SelectedModel(inner=inner, best_name=best_name,
                                         best_params=dict(best_params)))


def selected_combiner(est: SelectedModelCombiner, weight1: float,
                      weight2: float, strategy: str, metric: str,
                      combiner: Optional[dict] = None
                      ) -> SelectedCombinerModel:
    """A fitted combiner: its two weights, strategy and metric name;
    ``combiner`` (the JAX stage's ``metadata["combiner"]``) is carried
    into the estimator's metadata."""
    if combiner is not None:
        est.metadata["combiner"] = dict(combiner)
    return est.adopt_model(SelectedCombinerModel(
        weight1=weight1, weight2=weight2, strategy=strategy, metric=metric))


def workflow_model(result_features: Sequence[Feature],
                   fitted: Sequence[Model]) -> OpWorkflowModel:
    """A scorable workflow model: the fitted models stand in for their
    estimators; stateless transformers of the DAG are kept as they are."""
    by_uid = {m.uid: m for m in fitted}
    stages: List[PipelineStage] = []
    for s in compute_dag(result_features).all_stages():
        if isinstance(s, Estimator) and s.uid not in by_uid:
            raise ValueError(f"no fitted state given for estimator {s.uid}")
        stages.append(by_uid.get(s.uid, s))
    return OpWorkflowModel(result_features, stages)
