"""ModelSelector — automated model selection with validation (counterpart of
``transmogrifai_tpu.selector.model_selector``), binary, multiclass and
regression problems.

Flow: the splitter reserves a holdout and computes training weights; the
validator scores every (model, params) candidate on weight-masked CV folds
of the one device-resident matrix, family grids batched by their grid
groups; the best candidate is refit on the full training split (from its
group's full-train row where the group solved one); holdout and training
metrics are evaluated; everything lands in
``metadata["model_selector_summary"]`` with the JAX package's keys.
``holdout_evaluators`` add their metric sets on the holdout rows under
``holdoutEvaluation`` (the JAX package keeps the evaluators and evaluates
none of them).  ``RandomParamBuilder`` draws random-search grids.

The selector's options: ``strategy="halving"`` (``tuning/halving.py``,
with ``metadata["halving_schedule"]``), ``with_sweep_checkpoint`` (a
mid-sweep cursor, ``workflow/checkpoint.py``), ``with_watchdog`` (the
straggler watchdog over a fitted ``CostModel``), the device-loss retry
ladder on every fit (``metadata["elastic"]``), ``parallel=1`` and
``find_best_estimator`` (workflow-level CV; ``find_best_estimator_prefold``
for the streaming workflow CV).  ``parallel="auto"`` asks the cost
planner (``tuning/planner.py::advise_mesh``) and records its advice; on
one card that is the single-card sweep.  A full sweep over a matrix
of at least 2^24 elements builds the tree families' sketch and binning
on a thread of its own, on its own CUDA stream, while the linear groups
run (the sweep memo hands its result to the tree group).  Not ported
yet: a sweep mesh (``parallel=k`` or advice over several cards,
``with_mesh``: ROADMAP Queue A item 6.7).
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import device_vector, resolve_device
from ..evaluators.metrics import (MINIMIZE_METRICS, MULTICLASS_METRICS,
                                  aupr_device, auroc_device,
                                  binary_classification_metrics,
                                  multiclass_metric_device,
                                  multiclass_metrics,
                                  regression_metric_device,
                                  regression_metrics)
from ..models.classification import OpLogisticRegression
from ..models.prediction import (PredictionBatch, PredictorEstimator,
                                 PredictorModel)
from ..models.regression import OpLinearRegression
from ..models.trees import (MEMO_STATS, OpGBTRegressor,
                            OpRandomForestClassifier,
                            OpRandomForestRegressor, _GBTBase,
                            _RandomForestBase, prep_tree_inputs)
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import Prediction, RealNN
from ..utils.profiling import backend_name, count_drain
from .grid_groups import TreeGridGroup, make_grid_group
from .splitters import DataBalancer, DataCutter, DataSplitter
from .validators import (OpCrossValidation, OpTrainValidationSplit,
                         ValidationResult)

__all__ = ["ModelSelector", "SelectedModel", "ModelSelectorSummary",
           "BinaryClassificationModelSelector",
           "MultiClassificationModelSelector", "RegressionModelSelector",
           "DefaultSelectorParams", "RandomParamBuilder", "grid"]

#: the problem types the port selects for, with their default metric
_DEFAULT_METRIC = {"binary": "AuPR", "multiclass": "F1",
                   "regression": "RootMeanSquaredError"}


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


class RandomParamBuilder:
    """Random-search grids (RandomParamBuilder.scala:52,169): each axis
    draws from one ``np.random.default_rng(seed)`` in the order the axes
    were added, point by point, as the JAX package draws them."""

    def __init__(self, seed: int = 42):
        self._rng = np.random.default_rng(seed)
        self._axes: Dict[str, Callable[[], Any]] = {}

    def uniform(self, name: str, lo: float, hi: float
                ) -> "RandomParamBuilder":
        self._axes[name] = lambda: float(self._rng.uniform(lo, hi))
        return self

    def log_uniform(self, name: str, lo: float, hi: float
                    ) -> "RandomParamBuilder":
        self._axes[name] = lambda: float(np.exp(
            self._rng.uniform(np.log(lo), np.log(hi))))
        return self

    def choice(self, name: str, options: Sequence[Any]
               ) -> "RandomParamBuilder":
        opts = list(options)
        self._axes[name] = lambda: opts[int(self._rng.integers(len(opts)))]
        return self

    def build(self, n: int) -> List[Dict[str, Any]]:
        return [{k: fn() for k, fn in self._axes.items()} for _ in range(n)]


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


def _not_ported(what: str, item: str = "") -> NotImplementedError:
    where = f"ROADMAP Queue A item {item}" if item else "ROADMAP Queue A"
    return NotImplementedError(f"{what} is not ported yet ({where})")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ModelSelector(PredictorEstimator):
    """Selector over (estimator prototype, param grid) candidates of a
    binary, multiclass or regression problem, on the workflow's device.
    A multiclass selector takes its class count from the full labels
    before any split (``_class_count``), so a fold missing the top class
    never shrinks the class space.

    After a fit, ``metadata`` holds the summary and the sweep's own
    numbers: ``sweep_seconds`` (each grid group's wall, and the rest of
    the sweep's: fold set-up and sequential fits), ``group_errors`` (the
    exception of each group whose members fell back to sequential fits),
    ``tree_phase_seconds``
    (the tree groups' binning, growth and candidate scoring),
    ``refit_seconds``, ``metrics_seconds``, ``hist_levels`` (tree-level
    histograms built), ``rf_trees`` (trees grown: forests' and boosted
    chains'), ``group_trees`` / ``group_hist_levels`` (the trees and
    levels of each tree group), and ``sequential_fits`` (each fit outside
    a group, the winner's refit last where it had none: model, params,
    the host seconds of the call, with no device synchronisation — a fit
    that reads its loss back every step, as the MLP does, has ended on
    the device by then —, and, for an iterative fit that counts them,
    ``n_iter``)."""

    def __init__(self,
                 models_and_params: Sequence[Tuple[PredictorEstimator,
                                                   List[Dict[str, Any]]]],
                 problem_type: str, validator=None, splitter=None,
                 validation_metric: Optional[str] = None,
                 holdout_evaluators: Sequence = (),
                 strategy: str = "full", halving=None, parallel=None,
                 watchdog: Optional[float] = None,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="modelSelector", uid=uid)
        if problem_type not in _DEFAULT_METRIC:
            raise _not_ported(f"the {problem_type} model selector")
        if strategy not in ("full", "halving"):
            raise ValueError(f"unknown selector strategy {strategy!r}; "
                             f"expected 'full' or 'halving'")
        self.models_and_params = list(models_and_params)
        self.problem_type = problem_type
        self.validator = validator or OpCrossValidation(
            num_folds=3, stratify=problem_type != "regression")
        self.splitter = splitter
        self.validation_metric = (validation_metric
                                  or _DEFAULT_METRIC[problem_type])
        self.holdout_evaluators = list(holdout_evaluators)
        self.device = device
        #: "full" fits every candidate; "halving" runs successive halving
        #: (``halving``: a ``tuning.HalvingConfig``)
        self.strategy = strategy
        self.halving = halving
        #: None, or a card count (``_resolve_parallel``)
        self.parallel = parallel
        self._resolve_parallel()
        #: the straggler watchdog's deadline factor over the cost model's
        #: prediction (None: off), and the model (None: the history's)
        self.watchdog = watchdog
        self.watchdog_cost_model = None
        #: device-loss retries of a unit before it is quarantined
        self.elastic_max_retries: int = 2
        self.sweep_checkpoint_dir: Optional[str] = None
        self.sweep_checkpoint_every: int = 1
        #: the workflow-CV winner (``find_best_estimator``): the next fit
        #: refits it without validating, and consumes it
        self.best_estimator: Optional[Tuple[str, Dict[str, Any],
                                            List[ValidationResult]]] = None
        self._prep_thread: Optional[threading.Thread] = None
        self._seq_levels, self._seq_trees, self._seq_fits = 0, 0, []

    def with_mesh(self, mesh) -> "ModelSelector":
        raise _not_ported("the sweep mesh", "6.7")

    def with_watchdog(self, factor: float,
                      cost_model=None) -> "ModelSelector":
        """Arm the straggler watchdog: each sweep unit gets a deadline of
        ``factor`` x the cost model's prediction of the sweep over the
        queue width.  A unit past it is re-run with twice the deadline,
        then quarantined as ``failed: straggler``.  Only a fitted tier
        arms it (``cost_model``: the model to read; None: the history's
        at ``TMOG_COST_HISTORY``)."""
        self.watchdog = float(factor)
        self.watchdog_cost_model = cost_model
        return self

    def with_sweep_checkpoint(self, directory: str,
                              every_units: int = 1) -> "ModelSelector":
        """Mid-sweep checkpoint and resume: the finished units' fold
        metrics (and the halving rung state) persist atomically under
        ``directory`` as the sweep advances; a re-run on the same
        directory restores them and fits only the rest."""
        self.sweep_checkpoint_dir = directory
        self.sweep_checkpoint_every = int(every_units)
        return self

    def _resolve_parallel(self, n_rows: Optional[int] = None,
                          n_cols: int = 0, queue_width: int = 0,
                          device=None) -> None:
        """``parallel``: None, a card count clamped to the visible cards,
        or "auto"; one card (or none) is the single-card sweep, and more
        need a sweep mesh (ROADMAP Queue A item 6.7).  "auto" asks the
        cost planner (``tuning/planner.py::advise_mesh``) at fit time
        (``n_rows`` given), over the cards of the fit's device, and
        records its advice in ``metadata["mesh_advice"]``."""
        p = self.parallel
        if p is None:
            return
        if p == "auto":
            if n_rows is None:
                return
            from ..tuning.planner import advise_mesh

            dev = torch.device(device) if device is not None \
                else resolve_device()
            adv = advise_mesh(
                n_rows, n_cols, queue_width=queue_width,
                devices_available=(torch.cuda.device_count()
                                   if dev.type == "cuda" else 1))
            self.metadata["mesh_advice"] = adv.to_json()
            if adv.n_devices > 1:
                raise _not_ported(
                    f"a sweep over {adv.n_devices} cards (parallel="
                    f"'auto' advised it)", "6.7")
            return
        if not isinstance(p, int):
            raise _not_ported("a prebuilt sweep mesh (parallel=)", "6.7")
        n = min(int(p), torch.cuda.device_count())
        if n > 1:
            raise _not_ported(f"a sweep over {n} cards (parallel={p})",
                              "6.7")

    # -- elastic execution ---------------------------------------------------

    def _elastic_context(self, n_rows: int, n_cols: int, queue_width: int,
                         backend: str = "gpu"):
        """The fit's elastic policy: device-loss retries always, the
        watchdog where armed.  Its shrink hook joins the tree-prep
        prefetch thread and changes nothing else (one card, no mesh)."""
        from ..parallel.elastic import ElasticContext

        def shrink() -> bool:
            self._drain_tree_prefetch()
            return False

        return ElasticContext(
            shrink=shrink, max_unit_retries=self.elastic_max_retries,
            unit_deadline_s=self._watchdog_deadline(n_rows, n_cols,
                                                    queue_width, backend))

    def _watchdog_deadline(self, n_rows: int, n_cols: int,
                           queue_width: int,
                           backend: str = "gpu") -> Optional[float]:
        """``factor`` x the predicted sweep wall / the queue width, or None
        where the watchdog is off or every cost tier it reads is cold."""
        if not self.watchdog:
            return None
        from ..parallel.elastic import mesh_device_count
        from ..tuning.costmodel import CostModel

        cm = self.watchdog_cost_model or CostModel.from_history()
        kind = ("ModelSelector:fit-halving" if self.strategy == "halving"
                else "ModelSelector:fit")
        fitted = [k for k in [kind] + self._tree_grid_kinds()
                  if cm.source(k, backend) == "fitted"]
        if not fitted:
            return None
        total = sum(cm.predict(k, n_rows, n_cols, backend=backend,
                               n_devices=mesh_device_count(None))
                    for k in fitted)
        return max(float(self.watchdog) * total / max(queue_width, 1),
                   1e-3)

    def _tree_grid_kinds(self) -> List[str]:
        """The tree-grid cost kinds of this grid."""
        kinds = []
        for proto, _ in self.models_and_params:
            if isinstance(proto, _RandomForestBase):
                kinds.append("RandomForest:fit-grid")
            elif isinstance(proto, _GBTBase):
                kinds.append("GBT:fit-grid")
        return sorted(set(kinds))

    def _sweep_checkpoint(self, candidates, n_rows: int):
        """This fit's sweep cursor, primed from disk, or None.  A
        checkpoint of another sweep raises ``CheckpointMismatchError``."""
        if self.sweep_checkpoint_dir is None:
            return None
        from ..workflow.checkpoint import (SweepCheckpointManager,
                                           sweep_fingerprint)

        v = self.validator
        vdesc = (f"{type(v).__name__}("
                 f"folds={getattr(v, 'num_folds', None)},"
                 f"ratio={getattr(v, 'train_ratio', None)},"
                 f"seed={getattr(v, 'seed', None)},"
                 f"stratify={getattr(v, 'stratify', None)})")
        manager = SweepCheckpointManager(
            self.sweep_checkpoint_dir,
            sweep_fingerprint(candidates, self.validation_metric, vdesc,
                              strategy=self.strategy, n_rows=n_rows),
            every_units=self.sweep_checkpoint_every)
        manager.load()
        self.metadata["sweep_checkpoint"] = {
            "restoredUnits": manager.restored_units,
            "restoredRung": (manager.rung_state() or {}).get("nextRung")}
        return manager

    # -- the tree-prep prefetch thread ---------------------------------------

    #: below this many elements the prep is too short to overlap
    _PREFETCH_MIN_ELEMS = 1 << 24

    def _start_tree_prep_prefetch(self, X: torch.Tensor,
                                  row_weight: np.ndarray):
        """Build the tree groups' sketch and binning of ``X`` (at their
        ``max_bins``, on the sketch rows ``row_weight`` gives, as the
        groups will ask for them) on a daemon thread while the sweep's
        linear groups run.  On the card the thread works on a CUDA stream
        of its own that first waits for the work queued so far; the memo
        hands each built entry to the tree group with an event it waits
        on (``trees.memo_get``), or makes the group wait for the build in
        flight.  Records ``prefetchTreePrepSecs`` in the current metrics
        collector's custom tags."""
        from ..utils.profiling import current_collector

        if X.numel() < self._PREFETCH_MIN_ELEMS:
            return None
        bins = sorted({int(p.max_bins) for p, _ in self.models_and_params
                       if isinstance(p, (_RandomForestBase, _GBTBase))})
        if not bins:
            return None
        coll = current_collector()   # thread-local: captured here
        cancel = threading.Event()
        stream = None
        if X.device.type == "cuda":
            stream = torch.cuda.Stream(device=X.device)
            stream.wait_stream(torch.cuda.current_stream(X.device))
        box: Dict[str, float] = {}

        def work():
            t0 = time.perf_counter()
            ctx = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
            with ctx:
                for mb in bins:
                    if cancel.is_set():   # drained: stop between bins
                        return
                    try:
                        prep_tree_inputs(X, mb, row_weight=row_weight)
                    except Exception:   # the sweep's own prep raises it
                        return
                if stream is not None:
                    stream.synchronize()
            box["seconds"] = time.perf_counter() - t0
            if coll is not None:
                coll.metrics.custom_tags["prefetchTreePrepSecs"] = round(
                    box["seconds"], 3)

        t = threading.Thread(target=work, name="tree-prep-prefetch",
                             daemon=True)
        self._prep_thread, self._prep_cancel, self._prep_box = t, cancel, box
        t.start()
        return t

    def _drain_tree_prefetch(self, timeout_s: float = 30.0) -> None:
        """Cancel and join the prefetch thread (no-op when none runs);
        called at the end of every fit and by the elastic shrink hook, so
        that no prep outlives the sweep that started it.  Records
        ``metadata["tree_prefetch"]``: its seconds and whether it was
        joined; a join that found the thread running books its wait as
        a drain under ``tree_prefetch.join``."""
        t = self._prep_thread
        if t is None:
            return
        self._prep_cancel.set()
        alive = t.is_alive()
        t0 = time.perf_counter()
        t.join(timeout_s)
        wait = time.perf_counter() - t0
        if alive:
            count_drain(wait, tag="tree_prefetch.join")
        self.metadata["tree_prefetch"] = {
            "seconds": self._prep_box.get("seconds"),
            "join_wait_seconds": wait,
            "joined": not t.is_alive()}
        self._prep_thread = None

    @property
    def larger_better(self) -> bool:
        return self.validation_metric not in MINIMIZE_METRICS

    # -- validation plumbing -------------------------------------------------

    def _score_fn(self, model: PredictorModel, X: torch.Tensor
                  ) -> torch.Tensor:
        batch = model.predict_batch(X)
        if self.problem_type == "binary":
            if batch.probability is not None:
                return batch.probability[:, 1]
            return batch.raw_prediction[:, 1]   # a margin (linear SVC)
        return batch.prediction

    def _capture_class_space(self, y: np.ndarray) -> None:
        """Keep a multiclass problem's class count from the full labels,
        before any split, so that a fold missing the top class never
        shrinks the class space."""
        self._n_classes = (max(int(y.max()) + 1, 2)
                           if self.problem_type == "multiclass" and len(y)
                           else 0)

    def _class_count(self, y=None, pred=None) -> int:
        """The class count: the one captured from the full labels at fit
        time, raised by ``y`` or ``pred`` where they hold a larger class,
        at least 2."""
        n = getattr(self, "_n_classes", 0)
        for v in (y, pred):
            if v is not None and len(v):
                n = max(n, int(torch.as_tensor(v).max()) + 1)
        return max(n, 2)

    def _metric(self, y, scores: torch.Tensor, w):
        """A fold metric: a device scalar for AuPR/AuROC and the regression
        and multiclass sets, else a float."""
        m = self.validation_metric
        if self.problem_type == "regression":
            return regression_metric_device(y, scores, w, m)
        if self.problem_type == "multiclass":
            if m in MULTICLASS_METRICS:
                return multiclass_metric_device(
                    y, scores, w, self._class_count(y), m)
            return multiclass_metrics(y, scores, self._class_count(y, scores),
                                      w)[m]
        fn = {"AuPR": aupr_device, "AuROC": auroc_device}.get(m)
        if fn is not None:
            return fn(y, scores, w)
        return binary_classification_metrics(y, scores, w)[m]

    def _candidates(self, with_groups: bool = True):
        """(name, params, fitter, group) a grid point; ``with_groups=False``
        (halving, workflow CV) leaves every candidate to its own fit."""
        out = []
        for proto, grid_points in self.models_and_params:
            group = (make_grid_group(proto, grid_points, self.problem_type,
                                     self.validation_metric,
                                     n_classes=self._class_count())
                     if with_groups else None)
            for params in grid_points:
                def fitter(X, y, w, p, proto=proto):
                    est = proto.copy(**p)
                    t0 = time.perf_counter()
                    built = MEMO_STATS["binnings"]
                    model = est.fit_raw(X, y, w, device=X.device)
                    self._note_sequential_fit(
                        est, p, time.perf_counter() - t0,
                        MEMO_STATS["binnings"] - built)
                    return lambda Xe: self._score_fn(model, Xe)
                out.append((type(proto).__name__, params, fitter, group))
        return out

    def _note_sequential_fit(self, est, params=None,
                             seconds: Optional[float] = None,
                             binnings: int = 0) -> None:
        """Record a fit outside a group: its seconds, the binnings it
        built (0 where the sweep memo served its binned matrix) and its
        solver's iterations."""
        fit = {"model": type(est).__name__, "params": params,
               "seconds": seconds, "binnings_built": binnings}
        if "n_iter" in est.metadata:
            fit["n_iter"] = est.metadata["n_iter"]
        self._seq_fits.append(fit)
        self._seq_levels += est.metadata.get("hist_levels", 0)
        if isinstance(est, _RandomForestBase):
            self._seq_trees += est.num_trees
        elif isinstance(est, _GBTBase):
            self._seq_trees += est.metadata.get("rounds_grown", 0)

    # -- fit -----------------------------------------------------------------

    def _split(self, y: np.ndarray):
        """(splitter, train mask, holdout indices, base training weights):
        the set splitter, else a fresh one of the problem's default."""
        splitter = (self.splitter if self.splitter is not None
                    else {"binary": DataBalancer, "multiclass": DataCutter,
                          "regression": DataSplitter}[self.problem_type]())
        train_idx, holdout_idx = splitter.split_indices(len(y), y)
        train_mask = np.zeros(len(y), dtype=bool)
        train_mask[train_idx] = True
        return (splitter, train_mask, holdout_idx,
                splitter.train_weights(y, train_mask))

    def find_best_estimator(self, data: ColumnarDataset,
                            during_dag) -> Tuple[str, Dict[str, Any]]:
        """Workflow-level CV (ModelSelector.findBestEstimator): validate
        the candidates with ``during_dag`` refit inside every fold of the
        training split, and keep the winner for the next fit, which then
        skips validation.  ``metadata["workflow_cv_results"]`` keeps the
        fold-refit results."""
        label_name = self.input_features[0].name
        if label_name not in data:
            raise RuntimeError(
                f"label column {label_name!r} not materialized before the "
                f"CV cut — it must be produced by the before-DAG")
        y = np.nan_to_num(np.asarray(data[label_name].values,
                                     dtype=np.float32))
        self._capture_class_space(y)
        _, train_mask, _, base_w = self._split(y)
        train_idx = np.flatnonzero(train_mask)
        self._seq_levels, self._seq_trees, self._seq_fits = 0, 0, []
        candidates = self._candidates(with_groups=False)
        best_i, results = self.validator.validate_with_dag(
            candidates, data.take(train_idx), during_dag,
            label_name=label_name,
            features_name=self.input_features[1].name,
            y=y[train_idx], base_weights=base_w[train_idx],
            eval_fn=self._metric, metric_name=self.validation_metric,
            larger_better=self.larger_better,
            device=resolve_device(self.device))
        best_name, best_params = candidates[best_i][:2]
        self.best_estimator = (best_name, best_params, results)
        self.metadata["workflow_cv_results"] = [r.to_json() for r in results]
        return best_name, best_params

    def find_best_estimator_prefold(self, per_fold, y=None, n_rows: int = 0
                                    ) -> Tuple[str, Dict[str, Any]]:
        """Workflow-level CV over prebuilt fold matrices, each context
        ``(X_tr, y_tr, w_tr, X_ev, y_ev, w_ev)``: the streaming workflow
        CV's ``find_best_estimator`` (``workflow/streaming_cv.py`` builds
        the matrices from merged fold states).  The winner is kept for
        the next fit and the results land in
        ``metadata["workflow_cv_results"]``, as there; the sweep runs
        through the work queue with ``parallel=`` resolved, the sweep
        checkpoint (``with_sweep_checkpoint``) and the retry ladder, its
        counters in ``metadata["workflow_cv_elastic"]``."""
        if y is not None:
            self._capture_class_space(np.asarray(y, np.float32))
        n_cols = int(per_fold[0][0].shape[1]) if per_fold else 0
        queue_width = sum(len(g) for _, g in self.models_and_params)
        dev = resolve_device(self.device)
        self._resolve_parallel(n_rows, n_cols, queue_width, dev)
        self._seq_levels, self._seq_trees, self._seq_fits = 0, 0, []
        try:
            elastic = self._elastic_context(n_rows, n_cols, queue_width,
                                            backend_name(dev))
            candidates = self._candidates(with_groups=False)
            ckpt = self._sweep_checkpoint(candidates, n_rows)
            best_i, results = self.validator.validate_prefold(
                candidates, per_fold, eval_fn=self._metric,
                metric_name=self.validation_metric,
                larger_better=self.larger_better, checkpoint=ckpt,
                elastic=elastic)
            if ckpt is not None:
                ckpt.finish()
            self.metadata["workflow_cv_elastic"] = elastic.counters.to_json()
        finally:
            self._drain_tree_prefetch()
        best_name, best_params = candidates[best_i][:2]
        self.best_estimator = (best_name, best_params, results)
        self.metadata["workflow_cv_results"] = [r.to_json() for r in results]
        return best_name, best_params

    def fit_columns(self, data: ColumnarDataset, label_col: FeatureColumn,
                    features_col: FeatureColumn):
        try:
            return self._fit_columns(label_col, features_col)
        finally:
            # no prefetch thread outlives the fit, whether the sweep
            # finished or raised
            self._drain_tree_prefetch()

    def _sweep(self, X: torch.Tensor, y: np.ndarray, base_w: np.ndarray,
               elastic):
        """(winner's name, params, group or None, results, grid groups)
        of the configured strategy; a workflow-CV winner is consumed."""
        if self.best_estimator is not None:
            best_name, best_params, results = self.best_estimator
            self.best_estimator = None
            return best_name, best_params, None, results, []
        if self.strategy == "halving":
            from ..tuning.halving import halving_validate

            candidates = self._candidates(with_groups=False)
            ckpt = self._sweep_checkpoint(candidates, len(y))
            best_i, results, schedule = halving_validate(
                self.validator, candidates, X, y, base_w,
                eval_fn=self._metric, metric_name=self.validation_metric,
                larger_better=self.larger_better, config=self.halving,
                stratify=self.problem_type != "regression",
                checkpoint=ckpt, elastic=elastic)
            self.metadata["halving_schedule"] = schedule
        else:
            self._start_tree_prep_prefetch(X, base_w)
            candidates = self._candidates()
            ckpt = self._sweep_checkpoint(candidates, len(y))
            best_i, results = self.validator.validate(
                candidates, X, y, base_w, eval_fn=self._metric,
                metric_name=self.validation_metric,
                larger_better=self.larger_better, checkpoint=ckpt,
                elastic=elastic)
        if ckpt is not None:
            ckpt.finish()
        best_name, best_params, _, best_group = candidates[best_i]
        groups = list({id(c[3]): c[3] for c in candidates
                       if c[3] is not None}.values())
        return best_name, best_params, best_group, results, groups

    def _fit_columns(self, label_col: FeatureColumn,
                     features_col: FeatureColumn):
        X = device_vector(features_col, self.device).values
        dev = X.device
        y = np.nan_to_num(np.asarray(label_col.values, dtype=np.float32))
        n = len(y)
        self._capture_class_space(y)
        queue_width = sum(len(g) for _, g in self.models_and_params)
        self._resolve_parallel(n, int(X.shape[1]), queue_width, dev)
        splitter, train_mask, holdout_idx, base_w = self._split(y)

        self._seq_levels, self._seq_trees, self._seq_fits = 0, 0, []
        memo0 = dict(MEMO_STATS)
        elastic = self._elastic_context(n, int(X.shape[1]), queue_width,
                                        backend_name(dev))
        t0 = time.perf_counter()
        best_name, best_params, best_group, results, groups = self._sweep(
            X, y, base_w, elastic)
        _sync(dev)
        sweep_s = time.perf_counter() - t0
        self._drain_tree_prefetch()
        self.metadata["elastic"] = elastic.counters.to_json()
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
            t1 = time.perf_counter()
            built = MEMO_STATS["binnings"]
            best_model = est.fit_raw(X, y, base_w, device=dev)
            _sync(dev)
            self._note_sequential_fit(est, best_params,
                                      time.perf_counter() - t1,
                                      MEMO_STATS["binnings"] - built)
        _sync(dev)
        refit_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        full_batch = best_model.predict_batch(X)
        train_metrics = self._full_metrics(full_batch, y, train_mask)
        holdout_metrics = (self._full_metrics(full_batch, y, ~train_mask)
                           if len(holdout_idx) else {})
        holdout_evals = (self._holdout_evaluations(full_batch, y, holdout_idx)
                         if len(holdout_idx) and self.holdout_evaluators
                         else None)
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
                                           for g in tree_groups),
            group_trees={type(g).__name__: g.trees_grown
                         for g in tree_groups},
            group_hist_levels={type(g).__name__: g.hist_levels
                               for g in tree_groups},
            sequential_fits=self._seq_fits,
            tree_binnings={k: MEMO_STATS[k] - memo0[k] for k in memo0},
            group_efb_width={type(g).__name__: g.efb_width
                             for g in tree_groups
                             if hasattr(g, "efb_width")})
        summary = ModelSelectorSummary(
            validation_results=results, best_model_name=best_name,
            best_params=best_params,
            validation_type=type(self.validator).__name__,
            holdout_metrics=holdout_metrics, train_metrics=train_metrics,
            splitter_summary=(splitter.summary.to_json()
                              if splitter.summary else None),
            problem_type=self.problem_type)
        self.metadata["model_selector_summary"] = summary.to_json()
        if holdout_evals is not None:
            self.metadata["model_selector_summary"][
                "holdoutEvaluation"] = holdout_evals
        return SelectedModel(inner=best_model, best_name=best_name,
                             best_params=best_params)

    def _holdout_evaluations(self, full_batch: PredictionBatch,
                             y: np.ndarray, holdout_idx) -> List[dict]:
        """Each holdout evaluator's metric set on the holdout rows: its
        name, its selection metric and the set."""
        idx = np.sort(np.asarray(holdout_idx))
        rows = torch.from_numpy(idx).to(full_batch.prediction.device)
        batch = PredictionBatch(*(None if t is None else
                                  t.index_select(0, rows) for t in (
                                      full_batch.prediction,
                                      full_batch.raw_prediction,
                                      full_batch.probability)))
        data = ColumnarDataset({
            "label": FeatureColumn.from_values(RealNN, y[idx]),
            "prediction": FeatureColumn(Prediction, batch)})
        out = []
        for ev in self.holdout_evaluators:
            ev = copy.copy(ev)
            ev.label_col, ev.prediction_col = "label", "prediction"
            out.append({"evaluator": ev.name,
                        "metricName": ev.default_metric,
                        "metrics": ev.evaluate(data)})
        return out

    def _full_metrics(self, full_batch: PredictionBatch, y: np.ndarray,
                      mask: np.ndarray) -> Dict[str, float]:
        """The problem's metric set over the masked rows of a full-matrix
        batch."""
        idx = np.flatnonzero(mask)
        if not len(idx):
            return {}
        if self.problem_type == "multiclass":
            pred = full_batch.prediction.index_select(
                0, torch.from_numpy(idx).to(full_batch.prediction.device))
            out = multiclass_metrics(torch.from_numpy(y[idx]), pred,
                                     self._class_count(y[idx], pred))
            out.pop("confusion")
            return out
        score = (full_batch.probability[:, 1]
                 if self.problem_type == "binary"
                 and full_batch.probability is not None
                 else full_batch.prediction)
        rows = torch.from_numpy(idx).to(score.device)
        fn = (binary_classification_metrics if self.problem_type == "binary"
              else regression_metrics)
        return fn(torch.from_numpy(y[idx]), score.index_select(0, rows))


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
        parallelism: int = 8, max_wait: Optional[float] = None,
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

    @staticmethod
    def with_train_validation_split(
        train_ratio: float = 0.75, validation_metric: str = "AuPR",
        splitter=None, seed: int = 42, models_and_parameters=None,
        parallelism: int = 8, max_wait: Optional[float] = None,
        strategy: str = "full", halving=None, parallel=None,
        watchdog: Optional[float] = None,
    ) -> ModelSelector:
        return ModelSelector(
            models_and_params=models_and_parameters or _binary_defaults(),
            problem_type="binary",
            validator=OpTrainValidationSplit(train_ratio=train_ratio,
                                             seed=seed, stratify=True,
                                             parallelism=parallelism,
                                             max_wait=max_wait),
            splitter=(splitter if splitter is not None
                      else DataBalancer(seed=seed)),
            validation_metric=validation_metric, strategy=strategy,
            halving=halving, parallel=parallel, watchdog=watchdog)


def _multiclass_defaults() -> List[Tuple[PredictorEstimator,
                                         List[Dict[str, Any]]]]:
    """Default multiclass models: LR over 4 x 2 regularisations (softmax),
    RF over 3 depths x 2 min-instances x 3 min-info-gains at 50 trees
    (MultiClassificationModelSelector.scala)."""
    return _binary_defaults()


class MultiClassificationModelSelector:
    @staticmethod
    def with_cross_validation(
        num_folds: int = 3, validation_metric: str = "F1",
        splitter=None, seed: int = 42, models_and_parameters=None,
        parallelism: int = 8, max_wait: Optional[float] = None,
        strategy: str = "full", halving=None, parallel=None,
        watchdog: Optional[float] = None,
    ) -> ModelSelector:
        return ModelSelector(
            models_and_params=(models_and_parameters
                               or _multiclass_defaults()),
            problem_type="multiclass",
            validator=OpCrossValidation(num_folds=num_folds, seed=seed,
                                        stratify=True,
                                        parallelism=parallelism,
                                        max_wait=max_wait),
            splitter=(splitter if splitter is not None
                      else DataCutter(seed=seed)),
            validation_metric=validation_metric, strategy=strategy,
            halving=halving, parallel=parallel, watchdog=watchdog)

    @staticmethod
    def with_train_validation_split(
        train_ratio: float = 0.75, validation_metric: str = "F1",
        splitter=None, seed: int = 42, models_and_parameters=None,
        parallelism: int = 8, max_wait: Optional[float] = None,
        strategy: str = "full", halving=None, parallel=None,
        watchdog: Optional[float] = None,
    ) -> ModelSelector:
        return ModelSelector(
            models_and_params=(models_and_parameters
                               or _multiclass_defaults()),
            problem_type="multiclass",
            validator=OpTrainValidationSplit(train_ratio=train_ratio,
                                             seed=seed, stratify=True,
                                             parallelism=parallelism,
                                             max_wait=max_wait),
            splitter=(splitter if splitter is not None
                      else DataCutter(seed=seed)),
            validation_metric=validation_metric, strategy=strategy,
            halving=halving, parallel=parallel, watchdog=watchdog)


def _regression_defaults() -> List[Tuple[PredictorEstimator,
                                         List[Dict[str, Any]]]]:
    """Default regression models: linear regression over 4 x 2
    regularisations, RF over 3 depths x 2 min-instances x 3
    min-info-gains at 50 trees, GBT over 3 depths at 20 rounds of step
    0.1 (RegressionModelSelector.scala:49-110)."""
    D = DefaultSelectorParams
    return [
        (OpLinearRegression(), grid(
            reg_param=D.REGULARIZATION, elastic_net_param=D.ELASTIC_NET,
            max_iter=[200])),
        (OpRandomForestRegressor(), grid(
            max_depth=D.MAX_DEPTH,
            min_instances_per_node=D.MIN_INSTANCES_PER_NODE,
            min_info_gain=D.MIN_INFO_GAIN, num_trees=D.MAX_TREES)),
        (OpGBTRegressor(), grid(
            max_depth=D.MAX_DEPTH, max_iter=D.MAX_ITER_TREE,
            step_size=D.STEP_SIZE)),
    ]


class RegressionModelSelector:
    @staticmethod
    def with_cross_validation(
        num_folds: int = 3, validation_metric: str = "RootMeanSquaredError",
        splitter=None, seed: int = 42, models_and_parameters=None,
        parallelism: int = 8, max_wait: Optional[float] = None,
        strategy: str = "full", halving=None, parallel=None,
        watchdog: Optional[float] = None,
    ) -> ModelSelector:
        return ModelSelector(
            models_and_params=models_and_parameters or _regression_defaults(),
            problem_type="regression",
            validator=OpCrossValidation(num_folds=num_folds, seed=seed,
                                        parallelism=parallelism,
                                        max_wait=max_wait),
            splitter=(splitter if splitter is not None
                      else DataSplitter(seed=seed)),
            validation_metric=validation_metric, strategy=strategy,
            halving=halving, parallel=parallel, watchdog=watchdog)

    @staticmethod
    def with_train_validation_split(
        train_ratio: float = 0.75,
        validation_metric: str = "RootMeanSquaredError",
        splitter=None, seed: int = 42, models_and_parameters=None,
        parallelism: int = 8, max_wait: Optional[float] = None,
        strategy: str = "full", halving=None, parallel=None,
        watchdog: Optional[float] = None,
    ) -> ModelSelector:
        return ModelSelector(
            models_and_params=models_and_parameters or _regression_defaults(),
            problem_type="regression",
            validator=OpTrainValidationSplit(train_ratio=train_ratio,
                                             seed=seed,
                                             parallelism=parallelism,
                                             max_wait=max_wait),
            splitter=(splitter if splitter is not None
                      else DataSplitter(seed=seed)),
            validation_metric=validation_metric, strategy=strategy,
            halving=halving, parallel=parallel, watchdog=watchdog)
