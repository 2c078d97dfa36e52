"""ModelSelector — automated model selection with validation (counterpart of
``transmogrifai_tpu.selector.model_selector``), binary problems.

Flow: the splitter reserves a holdout and computes training weights; the
validator scores every (model, params) candidate on weight-masked CV folds
of the one device-resident matrix, family grids batched by their grid
groups; the best candidate is refit on the full training split (from its
group's full-train row where the group solved one); holdout and training
metrics are evaluated; everything lands in
``metadata["model_selector_summary"]`` with the JAX package's keys.

Not ported yet (ROADMAP Queue A): multiclass and regression selectors, the
train/validation-split validator, successive halving, the sweep mesh
(``parallel=``, ``with_mesh``), the straggler watchdog, sweep checkpoints,
workflow-level CV and the tree-prep prefetch thread.
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..evaluators.metrics import (MINIMIZE_METRICS, aupr_device,
                                  auroc_device,
                                  binary_classification_metrics)
from ..models.classification import OpLogisticRegression
from ..models.prediction import (PredictionBatch, PredictorEstimator,
                                 PredictorModel)
from ..models.trees import OpRandomForestClassifier
from ..types.columns import ColumnarDataset, FeatureColumn
from .grid_groups import TreeGridGroup, make_grid_group
from .splitters import DataBalancer
from .validators import OpCrossValidation, ValidationResult

__all__ = ["ModelSelector", "SelectedModel", "ModelSelectorSummary",
           "BinaryClassificationModelSelector", "DefaultSelectorParams",
           "grid"]


class DefaultSelectorParams:
    """Default grid values (DefaultSelectorParams.scala:36-75)."""

    MAX_DEPTH = [3, 6, 12]
    MAX_BIN = [32]
    MIN_INSTANCES_PER_NODE = [10, 100]
    MIN_INFO_GAIN = [0.001, 0.01, 0.1]
    REGULARIZATION = [0.001, 0.01, 0.1, 0.2]
    MAX_ITER_LIN = [50]
    MAX_ITER_TREE = [20]
    STEP_SIZE = [0.1]
    ELASTIC_NET = [0.1, 0.5]
    MAX_TREES = [50]
    TOL = [1e-6]
    NB_SMOOTHING = [1.0]
    NUM_ROUND_XGB = [200]
    ETA_XGB = [0.02]
    MIN_CHILD_WEIGHT_XGB = [1.0, 10.0]
    MAX_DEPTH_XGB = [10]
    EARLY_STOPPING_XGB = [20]
    GAMMA_XGB = [0.8]


def grid(**axes) -> List[Dict[str, Any]]:
    """Cartesian parameter grid."""
    keys = list(axes)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(axes[k] for k in keys))]


class ModelSelectorSummary:
    """Validation results, the winner and its metrics."""

    def __init__(self, validation_results: List[ValidationResult],
                 best_model_name: str, best_params: Dict[str, Any],
                 validation_type: str, holdout_metrics: Dict[str, float],
                 train_metrics: Dict[str, float],
                 splitter_summary: Optional[dict],
                 problem_type: Optional[str] = None):
        self.validation_results = validation_results
        self.best_model_name = best_model_name
        self.best_params = best_params
        self.validation_type = validation_type
        self.holdout_metrics = holdout_metrics
        self.train_metrics = train_metrics
        self.splitter_summary = splitter_summary
        self.problem_type = problem_type

    def to_json(self):
        return {
            "validationType": self.validation_type,
            "problemType": self.problem_type,
            "validationResults": [r.to_json()
                                  for r in self.validation_results],
            "bestModelType": self.best_model_name,
            "bestModelParams": self.best_params,
            "holdoutMetrics": self.holdout_metrics,
            "trainEvaluationMetrics": self.train_metrics,
            "dataPrepResults": self.splitter_summary,
        }


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A)")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ModelSelector(PredictorEstimator):
    """Selector over (estimator prototype, param grid) candidates of a
    binary problem, on the workflow's device.

    After a fit, ``metadata`` holds the summary and the sweep's own
    numbers: ``sweep_seconds`` (each grid group's wall, and the rest of
    the sweep's: fold set-up and sequential fits), ``group_errors`` (the
    exception of each group whose members fell back to sequential fits),
    ``tree_phase_seconds``
    (the tree groups' binning, growth and candidate scoring),
    ``refit_seconds``, ``metrics_seconds``, ``hist_levels`` (tree-level
    histograms built) and ``rf_trees``."""

    def __init__(self,
                 models_and_params: Sequence[Tuple[PredictorEstimator,
                                                   List[Dict[str, Any]]]],
                 problem_type: str, validator=None, splitter=None,
                 validation_metric: Optional[str] = None,
                 strategy: str = "full", halving=None, parallel=None,
                 watchdog: Optional[float] = None,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="modelSelector", uid=uid)
        if problem_type != "binary":
            raise _not_ported(f"the {problem_type} model selector")
        if strategy not in ("full", "halving"):
            raise ValueError(f"unknown selector strategy {strategy!r}; "
                             f"expected 'full' or 'halving'")
        if strategy == "halving" or halving is not None:
            raise _not_ported("successive halving")
        if parallel is not None:
            raise _not_ported("the sweep mesh (parallel=)")
        if watchdog is not None:
            raise _not_ported("the straggler watchdog")
        self.models_and_params = list(models_and_params)
        self.problem_type = problem_type
        self.validator = validator or OpCrossValidation(num_folds=3,
                                                        stratify=True)
        self.splitter = splitter
        self.validation_metric = validation_metric or "AuPR"
        self.device = device

    def with_mesh(self, mesh) -> "ModelSelector":
        raise _not_ported("the sweep mesh")

    def with_watchdog(self, factor: float,
                      cost_model=None) -> "ModelSelector":
        raise _not_ported("the straggler watchdog")

    def with_sweep_checkpoint(self, directory: str,
                              every_units: int = 1) -> "ModelSelector":
        raise _not_ported("sweep checkpoints")

    @property
    def larger_better(self) -> bool:
        return self.validation_metric not in MINIMIZE_METRICS

    # -- validation plumbing -------------------------------------------------

    @staticmethod
    def _score_fn(model: PredictorModel, X: torch.Tensor) -> torch.Tensor:
        return model.predict_batch(X).probability[:, 1]

    def _metric(self, y, scores: torch.Tensor, w):
        """A fold metric: a device scalar for AuPR/AuROC, else a float."""
        m = self.validation_metric
        fn = {"AuPR": aupr_device, "AuROC": auroc_device}.get(m)
        if fn is not None:
            return fn(y, scores, w)
        return binary_classification_metrics(y, scores, w)[m]

    def _candidates(self):
        out = []
        for proto, grid_points in self.models_and_params:
            group = make_grid_group(proto, grid_points, self.problem_type,
                                    self.validation_metric)
            for params in grid_points:
                def fitter(X, y, w, p, proto=proto):
                    est = proto.copy(**p)
                    model = est.fit_raw(X, y, w, device=X.device)
                    self._note_sequential_fit(est)
                    return lambda Xe: self._score_fn(model, Xe)
                out.append((type(proto).__name__, params, fitter, group))
        return out

    def _note_sequential_fit(self, est) -> None:
        self._seq_levels += est.metadata.get("hist_levels", 0)
        if isinstance(est, OpRandomForestClassifier):
            self._seq_trees += est.num_trees

    # -- fit -----------------------------------------------------------------

    def fit_columns(self, data: ColumnarDataset, label_col: FeatureColumn,
                    features_col: FeatureColumn):
        X = features_col.values
        dev = X.device
        y = np.nan_to_num(np.asarray(label_col.values, dtype=np.float32))
        n = len(y)
        if n and float(y.max()) > 1:
            raise _not_ported("multiclass selection")
        splitter = (self.splitter if self.splitter is not None
                    else DataBalancer())
        train_idx, holdout_idx = splitter.split_indices(n, y)
        train_mask = np.zeros(n, dtype=bool)
        train_mask[train_idx] = True
        base_w = splitter.train_weights(y, train_mask)

        self._seq_levels, self._seq_trees = 0, 0
        candidates = self._candidates()
        t0 = time.perf_counter()
        best_i, results = self.validator.validate(
            candidates, X, y, base_w, eval_fn=self._metric,
            metric_name=self.validation_metric,
            larger_better=self.larger_better)
        _sync(dev)
        sweep_s = time.perf_counter() - t0
        best_name, best_params, _, best_group = candidates[best_i]
        groups = list({id(c[3]): c[3] for c in candidates
                       if c[3] is not None}.values())
        seconds = {type(g).__name__: g.seconds for g in groups
                   if g.seconds is not None}
        seconds["rest"] = sweep_s - sum(seconds.values())

        # refit on the full training split: the winner's group row where
        # its group solved one, else a fresh fit of the winner
        t0 = time.perf_counter()
        best_model = None
        if best_group is not None:
            best_model = best_group.refit_model(
                best_group.grid_points.index(best_params))
        if best_model is None:
            proto = next(p for p, _ in self.models_and_params
                         if type(p).__name__ == best_name)
            est = proto.copy(**best_params)
            best_model = est.fit_raw(X, y, base_w, device=dev)
            self._note_sequential_fit(est)
        _sync(dev)
        refit_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        full_batch = best_model.predict_batch(X)
        train_metrics = self._full_metrics(full_batch, y, train_mask)
        holdout_metrics = (self._full_metrics(full_batch, y, ~train_mask)
                           if len(holdout_idx) else {})
        metrics_s = time.perf_counter() - t0

        tree_groups = [g for g in groups if isinstance(g, TreeGridGroup)]
        self.metadata.update(
            sweep_seconds=seconds,
            group_errors={type(g).__name__: g.error for g in groups
                          if g.error is not None},
            tree_phase_seconds={type(g).__name__: dict(g.phase_seconds)
                                for g in tree_groups},
            refit_seconds=refit_s,
            metrics_seconds=metrics_s,
            hist_levels=self._seq_levels + sum(g.hist_levels
                                               for g in tree_groups),
            rf_trees=self._seq_trees + sum(g.trees_grown
                                           for g in tree_groups))
        summary = ModelSelectorSummary(
            validation_results=results, best_model_name=best_name,
            best_params=best_params,
            validation_type=type(self.validator).__name__,
            holdout_metrics=holdout_metrics, train_metrics=train_metrics,
            splitter_summary=(splitter.summary.to_json()
                              if splitter.summary else None),
            problem_type=self.problem_type)
        self.metadata["model_selector_summary"] = summary.to_json()
        return SelectedModel(inner=best_model, best_name=best_name,
                             best_params=best_params)

    @staticmethod
    def _full_metrics(full_batch: PredictionBatch, y: np.ndarray,
                      mask: np.ndarray) -> Dict[str, float]:
        """Binary metrics over the masked rows of a full-matrix batch."""
        idx = np.flatnonzero(mask)
        if not len(idx):
            return {}
        score = full_batch.probability[:, 1]
        rows = torch.from_numpy(idx).to(score.device)
        return binary_classification_metrics(
            torch.from_numpy(y[idx]), score.index_select(0, rows))


class SelectedModel(PredictorModel):
    """The winning fitted model."""

    def __init__(self, inner: PredictorModel, best_name: str = "",
                 best_params: Optional[Dict[str, Any]] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="modelSelector", uid=uid)
        self.inner = inner
        self.best_name = best_name
        self.best_params = best_params or {}

    def predict_batch(self, X: torch.Tensor) -> PredictionBatch:
        return self.inner.predict_batch(X)


def _binary_defaults() -> List[Tuple[PredictorEstimator,
                                     List[Dict[str, Any]]]]:
    """Default binary models: LR over 4 x 2 regularisations, RF over
    3 depths x 2 min-instances x 3 min-info-gains at 50 trees
    (BinaryClassificationModelSelector.scala:54-108)."""
    D = DefaultSelectorParams
    return [
        (OpLogisticRegression(), grid(
            reg_param=D.REGULARIZATION, elastic_net_param=D.ELASTIC_NET,
            max_iter=D.MAX_ITER_LIN)),
        (OpRandomForestClassifier(), grid(
            max_depth=D.MAX_DEPTH,
            min_instances_per_node=D.MIN_INSTANCES_PER_NODE,
            min_info_gain=D.MIN_INFO_GAIN, num_trees=D.MAX_TREES)),
    ]


class BinaryClassificationModelSelector:
    @staticmethod
    def with_cross_validation(
        num_folds: int = 3, validation_metric: str = "AuPR",
        splitter=None, seed: int = 42, models_and_parameters=None,
        parallelism: Optional[int] = None, max_wait: Optional[float] = None,
        strategy: str = "full", halving=None, parallel=None,
        watchdog: Optional[float] = None,
    ) -> ModelSelector:
        return ModelSelector(
            models_and_params=models_and_parameters or _binary_defaults(),
            problem_type="binary",
            validator=OpCrossValidation(num_folds=num_folds, seed=seed,
                                        stratify=True,
                                        parallelism=parallelism,
                                        max_wait=max_wait),
            splitter=(splitter if splitter is not None
                      else DataBalancer(seed=seed)),
            validation_metric=validation_metric, strategy=strategy,
            halving=halving, parallel=parallel, watchdog=watchdog)
