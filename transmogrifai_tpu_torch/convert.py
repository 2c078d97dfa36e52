"""Carry fitted state of the JAX package's slice stages into the port.

Each function takes the port's (unfitted) estimator — already wired into
the port's feature DAG — plus the fitted state of the matching JAX stage
as numpy arrays and plain Python values, and returns the port's fitted
model answering for that estimator's output feature.  ``workflow_model``
assembles the fitted stages into a scorable ``OpWorkflowModel``.  This
module never imports the JAX package: callers extract the arrays.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .device import resolve_device
from .features.feature import Feature
from .models.trees import TreeEnsembleModel
from .ops.vectorizers import (OneHotVectorizer, OneHotVectorizerModel,
                              RealVectorizer, RealVectorizerModel)
from .preparators.sanity_checker import SanityChecker, SanityCheckerModel
from .stages.base import Estimator, Model, PipelineStage
from .workflow.dag import compute_dag
from .workflow.workflow import OpWorkflowModel

__all__ = ["real_vectorizer", "one_hot_vectorizer", "sanity_checker",
           "tree_ensemble", "workflow_model"]


def real_vectorizer(est: RealVectorizer, fills: Sequence[float],
                    track_nulls: bool = True) -> RealVectorizerModel:
    """Fill values per input feature (``RealVectorizerModel.fills``)."""
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


def tree_ensemble(est: Estimator, mode: str, edges: np.ndarray,
                  feat: np.ndarray, thresh: np.ndarray, leaf: np.ndarray,
                  base_score: float) -> TreeEnsembleModel:
    """A boosted ensemble (``TreeEnsembleModel`` edges/feat/thresh/leaf/
    base_score/mode), its trees placed on the estimator's device."""
    dev = resolve_device(getattr(est, "device", None))
    return est.adopt_model(TreeEnsembleModel(
        mode=mode, edges=np.asarray(edges, np.float32),
        feat=torch.tensor(np.asarray(feat, np.int32), device=dev),
        thresh=torch.tensor(np.asarray(thresh, np.int32), device=dev),
        leaf=torch.tensor(np.asarray(leaf, np.float32), device=dev),
        base_score=float(base_score)))


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
