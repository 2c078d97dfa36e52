"""Tree model stages (counterpart of ``transmogrifai_tpu.models.trees``).

Ported: ``OpGBTClassifier`` and ``OpXGBoostClassifier`` for the binary
objective, fitted by ``_fit_scan_chunks`` semantics — rounds run in chunks
of ``es_chunk``, the early-stopping metric (validation AuPR) of each chunk
is read one chunk late so the device never waits on the host, and the
ensemble is trimmed to the best round count.  A Python loop over rounds
takes the place of ``lax.scan``.  ``OpRandomForestClassifier`` for binary
labels: Poisson bags, square-root feature subsets, count-gated growth
(``gbdt_kernels.grow_forest_rf``).  ``TreeEnsembleModel`` scores the
``gbdt_binary`` and ``rf_cls`` modes.

Not ported yet (ROADMAP Queue A): decision trees, regression and
multiclass objectives and forests, GBT row/column subsampling and
fractional sample weights (the count channel), GOSS, EFB, the sparse path
and the upload/binning memo caches.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..evaluators.metrics import aupr_device
from ..types.columns import ColumnarDataset
from .gbdt_kernels import (
    apply_bins, default_dir_mask, goss_plan, grow_forest_rf, grow_tree,
    predict_ensemble, predict_tree, quantile_bins,
)
from .prediction import PredictionBatch, PredictorEstimator, PredictorModel

__all__ = ["OpGBTClassifier", "OpXGBoostClassifier",
           "OpRandomForestClassifier", "TreeEnsembleModel",
           "es_patience_vec"]

_MODES = ("gbdt_binary", "rf_cls")


class TreeEnsembleModel(PredictorModel):
    """Fitted tree ensemble.  ``gbdt_binary``: raw margin = base_score +
    sum of trees, probability = sigmoid.  ``rf_cls``: the leaves are class
    probabilities, averaged over the trees.  ``edges`` (D, B-1) is a host
    array; ``feat``/``thresh`` (T, 2^d-1) int32 and ``leaf`` (T, 2^d, K)
    float32 are tensors on the model's device."""

    def __init__(self, mode: str, edges, feat, thresh, leaf,
                 base_score: float = 0.0, n_classes: int = 2,
                 uid: Optional[str] = None):
        super().__init__(operation_name="treeEnsemble", uid=uid)
        if mode not in _MODES:
            raise NotImplementedError(
                f"tree ensemble mode {mode!r} is not ported yet "
                f"(ROADMAP Queue A)")
        self.mode = mode
        self.edges = np.asarray(edges, np.float32)
        self.feat = feat
        self.thresh = thresh
        self.leaf = leaf
        self.base_score = base_score
        self.n_classes = n_classes

    def raw_margin(self, X: torch.Tensor) -> torch.Tensor:
        depth = int(np.log2(self.feat.shape[1] + 1))
        binned = apply_bins(X, self.edges)
        dev = binned.device
        return predict_ensemble(binned, self.feat.to(dev),
                                self.thresh.to(dev), self.leaf.to(dev), depth)

    def predict_batch(self, X: torch.Tensor) -> PredictionBatch:
        if self.mode == "rf_cls":
            raw = self.raw_margin(X)
            proba = rf_probability(raw, self.feat.shape[0])
            return PredictionBatch(
                prediction=proba.argmax(dim=1).to(torch.float64),
                raw_prediction=raw, probability=proba)
        z = self.raw_margin(X)[:, 0] + self.base_score
        p1 = 1.0 / (1.0 + torch.exp(-z))
        return PredictionBatch(
            prediction=(p1 >= 0.5).to(torch.float64),
            raw_prediction=torch.stack([-z, z], dim=1),
            probability=torch.stack([1 - p1, p1], dim=1))


def rf_probability(raw: torch.Tensor, n_trees: int) -> torch.Tensor:
    """Class probabilities of a forest from its summed leaves (N, K): the
    mean over trees, floored at 1e-9 and renormalised."""
    proba = torch.clamp(raw / n_trees, 1e-9, 1.0)
    return proba / proba.sum(dim=1, keepdim=True)


def es_patience_vec(rows, stopped, best_metric, best_len, stall,
                    patience: int) -> bool:
    """THE early-stopping patience rule (improve/stall/stop), vectorized
    over chains; ``rows`` is a list of (round, metric-vector) pairs and the
    state arrays mutate in place.  Returns True when every chain stopped."""
    for n_at, mrow in rows:
        live = ~stopped
        better = live & (mrow > best_metric + 1e-9)
        best_metric[better] = mrow[better]
        best_len[better] = n_at
        stall[better] = 0
        stall[live & ~better] += 1
        stopped |= stall >= patience
    return bool(stopped.all())


def _materialize_es(chunk_rows):
    """Fetch a chunk of (round, device-metric) pairs in one copy."""
    if not chunk_rows:
        return []
    vals = torch.stack([m for _, m in chunk_rows]).cpu().numpy()
    return [(n_at, np.asarray([m])) for (n_at, _), m in zip(chunk_rows, vals)]


class _GBTBase(PredictorEstimator):
    """Gradient-boosted trees, binary logistic objective: Spark-GBT
    parameterisation (max_iter, step_size, max_depth) with XGBoost extras
    (reg_lambda, min_child_weight, gamma as ``min_split_gain_raw``, early
    stopping on a validation slice scored by AuPR)."""

    _op_name = "gbt"
    _objective = "binary"

    def __init__(self, max_iter: int = 20, max_depth: int = 5,
                 step_size: float = 0.1, max_bins: int = 32,
                 reg_lambda: float = 1.0, min_child_weight: float = 1.0,
                 min_info_gain: float = 0.0, subsample_rate: float = 1.0,
                 colsample: float = 1.0, early_stopping_rounds: int = 0,
                 validation_fraction: float = 0.2,
                 min_instances_per_node: int = 1,
                 min_split_gain_raw: float = 0.0, seed: int = 42,
                 sparse_default_direction: bool = False,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name=self._op_name, uid=uid)
        self.max_iter = max_iter
        self.max_depth = max_depth
        self.step_size = step_size
        self.max_bins = max_bins
        self.reg_lambda = reg_lambda
        self.min_child_weight = min_child_weight
        self.min_info_gain = min_info_gain
        self.subsample_rate = subsample_rate
        self.colsample = colsample
        self.early_stopping_rounds = early_stopping_rounds
        self.validation_fraction = validation_fraction
        self.min_instances_per_node = min_instances_per_node
        self.min_split_gain_raw = min_split_gain_raw
        self.seed = seed
        self.sparse_default_direction = sparse_default_direction
        self.device = device

    def fit_columns(self, data: ColumnarDataset, label_col, features_col):
        y = np.nan_to_num(np.asarray(label_col.values, dtype=np.float32))
        return self.fit_raw(features_col.values, y)

    def _check_supported(self, n: int, w) -> None:
        if self._objective != "binary":
            raise NotImplementedError(
                f"objective {self._objective!r} is not ported yet "
                f"(ROADMAP Queue A)")
        if self.subsample_rate < 1.0 or self.colsample < 1.0:
            raise NotImplementedError(
                "row/column subsampling is not ported yet (ROADMAP Queue A)")
        if (float(self.min_instances_per_node) > 1
                or float(self.min_info_gain) != 0.0
                or (w is not None
                    and not bool((w == np.floor(w)).all()))):
            raise NotImplementedError(
                "count-gated growth (min_instances_per_node > 1, "
                "min_info_gain != 0 or fractional weights) is not ported "
                "yet (ROADMAP Queue A)")
        if goss_plan(n, self.max_depth) is not None:
            raise NotImplementedError(
                "GOSS row sampling (max_depth >= 8 at >= 20000 rows) is not "
                "ported yet (ROADMAP Queue A)")

    def fit_raw(self, X, y, w=None, device=None) -> TreeEnsembleModel:
        """Fit on a (N, D) matrix (tensor or array) and labels in {0, 1}.
        Runs on ``device`` (else the stage's, else the default device)."""
        dev = resolve_device(device if device is not None else self.device)
        X = torch.as_tensor(X, dtype=torch.float32).to(dev)
        y = np.asarray(y, np.float32)
        n, d = X.shape
        w = None if w is None else np.asarray(w, np.float32)
        self._check_supported(n, w)
        # fit_timing and the profiler ranges below split the fit into its
        # host-heavy binning and its device-heavy boosting
        timing = {}
        with torch.profiler.record_function("tmog.binning"):
            t0 = time.perf_counter()
            edges = quantile_bins(X, self.max_bins)
            binned = apply_bins(X, edges)
            _sync(dev)
            timing["binning_s"] = time.perf_counter() - t0

        rng = np.random.default_rng(self.seed)
        base_w = np.ones(n, np.float32) if w is None else w
        use_es = self.early_stopping_rounds > 0
        if use_es:
            val = rng.random(n) < self.validation_fraction
            train_w = base_w * (~val)
        else:
            val = np.zeros(n, bool)
            train_w = base_w
        pos = float((base_w * y).sum())
        tot = float(base_w.sum())
        p0 = min(max(pos / max(tot, 1e-9), 1e-6), 1 - 1e-6)
        base = float(np.float32(np.log(p0 / (1 - p0))))

        with torch.profiler.record_function("tmog.boosting"):
            t0 = time.perf_counter()
            model = self._fit_scan_chunks(
                binned, edges, torch.from_numpy(y).to(dev),
                torch.from_numpy(train_w).to(dev), base, use_es,
                np.where(val)[0])
            _sync(dev)
            timing["boosting_s"] = time.perf_counter() - t0
        self.metadata["fit_timing"] = timing
        return model

    def _fit_scan_chunks(self, binned, edges, y, W, base: float,
                         use_es: bool, val_idx) -> TreeEnsembleModel:
        """Chunked boosting with lagged early stopping — the JAX package's
        ``_fit_scan_chunks``: ``es_chunk`` rounds per chunk; after chunk c
        is enqueued, chunk c-1's metrics are read and the patience rule
        replayed, so at most one extra chunk is grown past the stop."""
        dev = binned.device
        n = binned.shape[0]
        dd = (torch.from_numpy(default_dir_mask(edges)).to(dev)
              if self.sparse_default_direction else None)
        es_chunk = max(1, min(8, self.early_stopping_rounds or 8))
        run_es = use_es and len(val_idx) > 0
        vi = torch.from_numpy(np.asarray(val_idx, np.int64)).to(dev)
        y_val = y[vi]
        F = torch.full((n,), base, dtype=torch.float32, device=dev)
        lagged: list = []
        best_metric = np.full(1, -np.inf)
        best_len_a = np.zeros(1, np.int32)
        stall_a = np.zeros(1, np.int32)
        stopped = np.zeros(1, bool)
        feats: List[torch.Tensor] = []
        threshs: List[torch.Tensor] = []
        leaves: List[torch.Tensor] = []
        n_rounds = 0
        for _ in range(-(-self.max_iter // es_chunk)):
            pending = []
            for j in range(es_chunk):
                P = torch.sigmoid(F)
                G = W * (P - y)
                H = W * torch.clamp(P * (1 - P), min=1e-6)
                tree = grow_tree(
                    binned, G[:, None], H[:, None], self.max_depth,
                    self.max_bins, lam=self.reg_lambda,
                    min_child_weight=self.min_child_weight,
                    min_gain_raw=self.min_split_gain_raw,
                    learning_rate=self.step_size,
                    default_dir=self.sparse_default_direction, dd_mask=dd)
                F = F + predict_tree(binned, tree.feat, tree.thresh,
                                     tree.leaf, self.max_depth)[:, 0]
                feats.append(tree.feat)
                threshs.append(tree.thresh)
                leaves.append(tree.leaf)
                if run_es and n_rounds + j + 1 <= self.max_iter:
                    pending.append((n_rounds + j + 1,
                                    aupr_device(y_val, torch.sigmoid(F[vi]))))
            n_rounds += es_chunk
            if run_es:
                if es_patience_vec(_materialize_es(lagged), stopped,
                                   best_metric, best_len_a, stall_a,
                                   self.early_stopping_rounds):
                    break
                lagged = pending
        if run_es and not stopped.all():
            es_patience_vec(_materialize_es(lagged), stopped, best_metric,
                            best_len_a, stall_a, self.early_stopping_rounds)
        best_len = (int(best_len_a[0]) if run_es and best_len_a[0]
                    else n_rounds)
        best_len = min(best_len, self.max_iter)
        self.metadata["rounds_grown"] = n_rounds
        self.metadata["best_len"] = best_len
        return TreeEnsembleModel(
            mode="gbdt_binary", edges=edges,
            feat=torch.stack(feats[:best_len]),
            thresh=torch.stack(threshs[:best_len]),
            leaf=torch.stack(leaves[:best_len]), base_score=base,
            n_classes=2)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class OpGBTClassifier(_GBTBase):
    """Binary GBT (OpGBTClassifier parity)."""
    _op_name = "gbtCls"
    _objective = "binary"


class OpXGBoostClassifier(_GBTBase):
    """XGBoost-parameterised boosted classifier, binary objective.

    Defaults follow the reference's XGB defaults for binary selection
    (NumRound=200, Eta=0.02, MaxDepth=10, MinChildWeight=1, Gamma=0.8,
    aucpr early stopping after 20 rounds, 32 bins)."""

    _op_name = "xgbCls"
    _objective = "binary"

    def __init__(self, num_round: int = 200, eta: float = 0.02,
                 max_depth: int = 10, min_child_weight: float = 1.0,
                 gamma: float = 0.8, reg_lambda: float = 1.0,
                 subsample: float = 1.0, colsample_bytree: float = 1.0,
                 max_bins: int = 32, early_stopping_rounds: int = 20,
                 num_class: int = 0, seed: int = 42,
                 sparse_default_direction: bool = True,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(
            max_iter=num_round, max_depth=max_depth, step_size=eta,
            max_bins=max_bins, reg_lambda=reg_lambda,
            min_child_weight=min_child_weight, min_split_gain_raw=gamma,
            subsample_rate=subsample, colsample=colsample_bytree,
            early_stopping_rounds=early_stopping_rounds, seed=seed,
            sparse_default_direction=sparse_default_direction,
            device=device, uid=uid)
        self.num_round = num_round
        self.eta = eta
        self.gamma = gamma
        self.subsample = subsample
        self.colsample_bytree = colsample_bytree
        self.num_class = num_class

    def fit_raw(self, X, y, w=None, device=None):
        if self.num_class > 2 or (self.num_class == 0
                                  and float(np.max(y)) > 1):
            raise NotImplementedError(
                "multiclass XGBoost is not ported yet (ROADMAP Queue A)")
        return super().fit_raw(X, y, w, device=device)


#: the JAX package's sparse-path rule: a matrix of at least this many
#: elements whose sampled zero fraction reaches _SPARSE_ZERO_FRAC takes a
#: nonzero-aware sketch, which is not ported
_SPARSE_MIN_ELEMS = 1 << 24
_SPARSE_ZERO_FRAC = 0.75


def prep_tree_inputs(X: torch.Tensor, max_bins: int, row_weight=None):
    """Bin edges and the binned matrix of a forest fit: the quantile
    sketch over the rows up to the last one of positive ``row_weight``
    (a trailing block of zero-weight rows never moves the edges; interior
    ones stay in the sketch, as in the JAX package's weighted sketch),
    binning over every row.  Raises where the JAX package would take its
    nonzero-aware sketch of a wide, mostly zero matrix."""
    Xm = X
    if row_weight is not None:
        nz = np.flatnonzero(np.asarray(row_weight) > 0)
        if len(nz):
            Xm = X[:nz[-1] + 1]
    step = max(1, Xm.shape[0] // 4096)
    if (Xm.numel() >= _SPARSE_MIN_ELEMS
            and float((Xm[::step] == 0).to(torch.float32).mean())
            >= _SPARSE_ZERO_FRAC):
        raise NotImplementedError(
            "the nonzero-aware sketch of mostly zero matrices is not ported "
            "yet (ROADMAP Queue A)")
    edges = quantile_bins(Xm, max_bins)
    return edges, apply_bins(X, edges)


def _feature_subset_size(strategy: str, d: int) -> int:
    """A classifier's per-tree feature count (``auto`` is ``sqrt``)."""
    if strategy in ("auto", "sqrt"):
        return max(1, int(np.sqrt(d)))
    if strategy == "onethird":
        return max(1, d // 3)
    return d


class OpRandomForestClassifier(PredictorEstimator):
    """Bagged binary random forest (Spark's parameters): ``num_trees``
    trees on Poisson(``subsample_rate``) bags, each over a
    ``feature_subset_strategy`` subset of the features, grown to
    ``max_depth`` with splits gated by ``min_instances_per_node`` bag
    weight per child and ``min_info_gain`` gain per unit of node weight."""

    def __init__(self, num_trees: int = 20, max_depth: int = 5,
                 max_bins: int = 32, min_instances_per_node: int = 1,
                 min_info_gain: float = 0.0, subsample_rate: float = 1.0,
                 feature_subset_strategy: str = "auto", seed: int = 42,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="randomForestCls", uid=uid)
        self.num_trees = num_trees
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.min_instances_per_node = min_instances_per_node
        self.min_info_gain = min_info_gain
        self.subsample_rate = subsample_rate
        self.feature_subset_strategy = feature_subset_strategy
        self.seed = seed
        self.device = device

    def fit_columns(self, data: ColumnarDataset, label_col, features_col):
        y = np.nan_to_num(np.asarray(label_col.values, dtype=np.float32))
        return self.fit_raw(features_col.values, y)

    def fit_raw(self, X, y, w=None, device=None) -> TreeEnsembleModel:
        """Fit on a (N, D) matrix and labels in {0, 1}, on ``device`` (else
        the stage's, else the default device).  ``metadata["hist_levels"]``
        counts the per-level histograms built."""
        dev = resolve_device(device if device is not None else self.device)
        X = torch.as_tensor(X, dtype=torch.float32).to(dev)
        y = np.asarray(y, np.float32)
        if len(y) and float(y.max()) > 1:
            raise NotImplementedError(
                "multiclass forests are not ported yet (ROADMAP Queue A)")
        n, d = X.shape
        edges, binned = prep_tree_inputs(X, self.max_bins)
        base_w = (torch.ones(n, dtype=torch.float32, device=dev) if w is None
                  else torch.as_tensor(np.asarray(w, np.float32)).to(dev))
        msub = _feature_subset_size(self.feature_subset_strategy, d)
        forest = grow_forest_rf(
            binned, torch.from_numpy(y).to(dev), base_w, seed=self.seed,
            n_trees=self.num_trees, msub=msub,
            subsample_rate=self.subsample_rate, max_depth=self.max_depth,
            n_bins=self.max_bins, min_info_gain=self.min_info_gain,
            min_instances=float(self.min_instances_per_node))
        self.metadata["hist_levels"] = forest.levels
        return TreeEnsembleModel(mode="rf_cls", edges=edges, feat=forest.feat,
                                 thresh=forest.thresh, leaf=forest.leaf,
                                 n_classes=2)
