"""Tree model stages (counterpart of ``transmogrifai_tpu.models.trees``).

Ported: ``OpGBTClassifier``, ``OpXGBoostClassifier``, ``OpGBTRegressor``
and ``OpXGBoostRegressor`` for the binary logistic and the squared-error
objectives: a fit is one chain of ``boost_chains``, the boosting loop
that the lockstep grid group runs over many — rounds run in chunks of
``es_chunk``, the early-stopping metric (validation AuPR, or minus the
validation MSE) of each chunk is read one chunk late so the device never
waits on the host, and the ensemble is trimmed to the best round count;
deep fits on many rows grow each round on a GOSS row sample
(``gbdt_kernels.goss_plan``).  A Python loop over rounds takes the place
of ``lax.scan``.  ``OpRandomForestClassifier`` (K classes) and
``OpRandomForestRegressor``: Poisson bags, square-root (classification)
or one-third (regression) feature subsets, count-gated growth
(``gbdt_kernels.grow_forest_rf``).  ``TreeEnsembleModel`` scores the
``gbdt_binary``, ``gbdt_reg``, ``rf_cls`` and ``rf_reg`` modes.

Every tree fit bins through ``prep_tree_inputs``, which takes the
nonzero-aware sketch for a wide, mostly zero matrix as the JAX package
does.  Not ported yet (ROADMAP Queue A): decision trees, the multiclass
boosting objective, GBT row/column subsampling and fractional sample
weights (the count channel), EFB, the CSR histogram path and the
upload/binning memo caches.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import as_device_tensor, resolve_device
from ..evaluators.metrics import aupr_device
from ..types.columns import ColumnarDataset
from . import gbdt_kernels
from .gbdt_kernels import (
    HistFn, TreeArrays, apply_bins, default_dir_mask, goss_plan, goss_rows,
    grow_forest_rf, grow_tree, predict_ensemble, predict_tree,
    quantile_bins, quantile_bins_sparse_aware, seg_level_hists,
)
from .prediction import PredictionBatch, PredictorEstimator, PredictorModel

__all__ = ["OpGBTClassifier", "OpXGBoostClassifier", "OpGBTRegressor",
           "OpXGBoostRegressor", "OpRandomForestClassifier",
           "OpRandomForestRegressor", "TreeEnsembleModel",
           "BoostedChains", "boost_chains", "es_patience_vec"]

_MODES = ("gbdt_binary", "gbdt_reg", "rf_cls", "rf_reg")


class TreeEnsembleModel(PredictorModel):
    """Fitted tree ensemble.  ``gbdt_binary``: raw margin = base_score +
    sum of trees, probability = sigmoid.  ``gbdt_reg``: the prediction is
    base_score + sum of trees.  ``rf_cls``: the leaves are class
    probabilities, averaged over the trees.  ``rf_reg``: the prediction is
    the mean of the trees' leaves (+ base_score).  Regression batches hold
    the prediction only.  ``edges`` (D, B-1) is a host
    array; ``feat``/``thresh`` (T, 2^d-1) int32 and ``leaf`` (T, 2^d, K)
    float32 are tensors on the model's device: arrays (a loaded artifact's)
    go to ``device`` (else the default device), tensors stay where they
    are."""

    def __init__(self, mode: str, edges, feat, thresh, leaf,
                 base_score: float = 0.0, n_classes: int = 2,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="treeEnsemble", uid=uid)
        if mode not in _MODES:
            raise NotImplementedError(
                f"tree ensemble mode {mode!r} is not ported yet "
                f"(ROADMAP Queue A)")
        self.mode = mode
        self.edges = np.asarray(edges, np.float32)
        self.feat = as_device_tensor(feat, torch.int32, device)
        self.thresh = as_device_tensor(thresh, torch.int32, device)
        self.leaf = as_device_tensor(leaf, torch.float32, device)
        self.base_score = float(base_score)
        self.n_classes = int(n_classes)
        self.device = device

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
        if self.mode in ("rf_reg", "gbdt_reg"):
            return PredictionBatch(prediction=self.predict_values(X).to(
                torch.float64))
        z = self.raw_margin(X)[:, 0] + self.base_score
        p1 = 1.0 / (1.0 + torch.exp(-z))
        return PredictionBatch(
            prediction=(p1 >= 0.5).to(torch.float64),
            raw_prediction=torch.stack([-z, z], dim=1),
            probability=torch.stack([1 - p1, p1], dim=1))


    def predict_values(self, X: torch.Tensor) -> torch.Tensor:
        """(N,) float32 regression predictions: the mean of the trees
        (``rf_reg``) or their sum (``gbdt_reg``), plus base_score."""
        raw = self.raw_margin(X)[:, 0]
        base = float(np.float32(self.base_score))
        if self.mode == "rf_reg":
            return raw / self.feat.shape[0] + base
        return raw + base


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


def replay_es(chunk_rows, stopped, best_metric, best_len, stall,
              patience: int) -> bool:
    """Replay one fetched chunk of (round, per-chain device metrics (S,))
    pairs (one host copy) against the patience state, in place; True when
    every chain has stopped."""
    if not chunk_rows:
        return bool(stopped.all())
    vals = torch.stack([m for _, m in chunk_rows]).cpu().numpy()
    return es_patience_vec([(r, v) for (r, _), v in zip(chunk_rows, vals)],
                           stopped, best_metric, best_len, stall, patience)


class BoostedChains(NamedTuple):
    """What ``boost_chains`` grew: each chain's trees of every round it
    grew, the rounds each chain keeps (S,), the per-level histograms built
    and the GOSS budget (None when off)."""
    trees: List[List[TreeArrays]]
    best_len: np.ndarray
    levels: int
    goss: Optional[Tuple[int, int]]


def boost_chains(ests, binned: torch.Tensor, edges, y: torch.Tensor,
                 W: torch.Tensor, base: torch.Tensor, val_idx,
                 hist_fn: HistFn = seg_level_hists) -> BoostedChains:
    """THE boosting loop: S chains advanced in lockstep one round at a
    time — the JAX package's sequential ``_fit_scan_chunks`` is one chain,
    its ``GBTGridGroup`` one chain per (candidate x fold).

    Chain s boosts from the margin ``base[s]`` on the gradient weights
    ``W[s]`` (N,) with ``ests[s]``'s depth, step, lambda, min_child_weight
    and gamma; ``ests[0]`` gives what the chains share (objective,
    max_iter, max_bins, early stopping, seed, default-direction splits).
    Rounds run in chunks of ``es_chunk``: after chunk c is grown, chunk
    c-1's per-chain metrics on the rows ``val_idx`` are fetched in one copy
    and the patience rule replayed (``replay_es``), so the device never
    waits on the host; a stopped chain grows no more trees, and rounds past
    max_iter are not grown.  GOSS engages when every chain is deep
    (``goss_plan`` over the shallowest depth): chain s's tree of round r
    then grows on ``gbdt_kernels.goss_select(|g|, seed, r, s)``'s rows.
    ``hist_fn`` builds every level's histograms (the kernel wrapper by
    default)."""
    e0 = ests[0]
    obj = e0._objective
    dev = binned.device
    S, n = len(ests), binned.shape[0]
    max_iter, mb = int(e0.max_iter), int(e0.max_bins)
    patience = int(e0.early_stopping_rounds)
    dd = (torch.from_numpy(default_dir_mask(edges)).to(dev)
          if e0.sparse_default_direction else None)
    goss = goss_plan(n, min(int(e.max_depth) for e in ests))
    es_chunk = max(1, min(8, patience or 8))
    run_es = patience > 0 and len(val_idx) > 0
    vi = torch.from_numpy(np.asarray(val_idx, np.int64)).to(dev)
    y_val = y[vi]
    Fm = base.to(dev, torch.float32)[:, None].repeat(1, n)
    best_metric = np.full(S, -np.inf)
    best_len = np.zeros(S, np.int32)
    stall = np.zeros(S, np.int32)
    stopped = np.zeros(S, bool)
    trees: List[List[TreeArrays]] = [[] for _ in range(S)]
    levels = 0
    lagged: list = []
    no_metric = torch.zeros((), dtype=torch.float64, device=dev)
    n_rounds = 0
    while n_rounds < max_iter:
        pending = []
        for rid in range(n_rounds, min(n_rounds + es_chunk, max_iter)):
            ms = []
            for s in range(S):
                if stopped[s]:
                    ms.append(no_metric)
                    continue
                e = ests[s]
                depth = int(e.max_depth)
                G, H = gbt_grad_hess(obj, Fm[s], y, W[s])
                tb = binned
                if goss is not None:
                    idx, mult = gbdt_kernels.goss_select(
                        G.abs(), int(e0.seed), rid, s, *goss)
                    tb = goss_rows(binned, idx)
                    G, H = G[idx] * mult, H[idx] * mult
                tree = grow_tree(
                    tb, G[:, None], H[:, None], depth, mb,
                    lam=float(e.reg_lambda),
                    min_child_weight=float(e.min_child_weight),
                    min_gain_raw=float(e.min_split_gain_raw),
                    learning_rate=float(e.step_size),
                    default_dir=bool(e0.sparse_default_direction),
                    dd_mask=dd, hist_fn=hist_fn)
                del tb
                levels += depth
                Fm[s] += predict_tree(binned, *tree, depth)[:, 0]
                trees[s].append(tree)
                if run_es:
                    ms.append(gbt_es_metric(obj, Fm[s][vi], y_val).to(
                        torch.float64))
            if run_es:
                pending.append((rid + 1, torch.stack(ms)))
        n_rounds = min(n_rounds + es_chunk, max_iter)
        if run_es:
            if replay_es(lagged, stopped, best_metric, best_len, stall,
                         patience):
                break
            lagged = pending
    if run_es and not stopped.all():
        replay_es(lagged, stopped, best_metric, best_len, stall, patience)
    # a chain that never improved (or ran without early stopping) keeps
    # every round grown
    best_len[best_len == 0] = n_rounds
    return BoostedChains(trees, best_len, levels, goss)


class _GBTBase(PredictorEstimator):
    """Gradient-boosted trees, binary logistic or squared-error objective:
    Spark-GBT parameterisation (max_iter, step_size, max_depth) with
    XGBoost extras (reg_lambda, min_child_weight, gamma as
    ``min_split_gain_raw``, early stopping on a validation slice scored by
    AuPR, or by minus the MSE for regression)."""

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

    def fit_raw(self, X, y, w=None, device=None) -> TreeEnsembleModel:
        """Fit on a (N, D) matrix (tensor or array) and labels (in {0, 1}
        for the binary objective).  Runs on ``device`` (else the stage's,
        else the default device)."""
        dev = resolve_device(device if device is not None else self.device)
        X = torch.as_tensor(X, dtype=torch.float32).to(dev)
        y = np.asarray(y, np.float32)
        n, d = X.shape
        w = None if w is None else np.asarray(w, np.float32)
        check_gbt_supported(self._objective, self.subsample_rate,
                            self.colsample, [self.min_instances_per_node],
                            [self.min_info_gain], w)
        # fit_timing and the profiler ranges below split the fit into its
        # host-heavy binning and its device-heavy boosting
        timing = {}
        with torch.profiler.record_function("tmog.binning"):
            t0 = time.perf_counter()
            edges, binned = prep_tree_inputs(X, self.max_bins)
            _sync(dev)
            timing["binning_s"] = time.perf_counter() - t0

        rng = np.random.default_rng(self.seed)
        base_w = np.ones(n, np.float32) if w is None else w
        val = (rng.random(n) < self.validation_fraction
               if self.early_stopping_rounds > 0 else np.zeros(n, bool))
        train_w = base_w * (~val)
        base = gbt_base_score(self._objective, base_w, y)

        with torch.profiler.record_function("tmog.boosting"):
            t0 = time.perf_counter()
            out = boost_chains(
                [self], binned, edges, torch.from_numpy(y).to(dev),
                torch.from_numpy(train_w).to(dev)[None],
                torch.tensor([float(base)]), np.where(val)[0])
            kept = out.trees[0][:int(out.best_len[0])]
            model = TreeEnsembleModel(
                mode="gbdt_binary" if self._objective == "binary"
                else "gbdt_reg", edges=edges,
                feat=torch.stack([t.feat for t in kept]),
                thresh=torch.stack([t.thresh for t in kept]),
                leaf=torch.stack([t.leaf for t in kept]),
                base_score=base, n_classes=2)
            _sync(dev)
            timing["boosting_s"] = time.perf_counter() - t0
        self.metadata["fit_timing"] = timing
        self.metadata["rounds_grown"] = len(out.trees[0])
        self.metadata["best_len"] = len(kept)
        self.metadata["hist_levels"] = out.levels
        self.metadata["goss"] = (list(out.goss) if out.goss is not None
                                 else None)
        return model


def check_gbt_supported(objective: str, subsample_rate: float,
                        colsample: float, min_instances, min_info_gains,
                        w) -> None:
    """Raise for what the port's boosting leaves out: objectives other
    than binary and regression, row/column subsampling, and count-gated
    growth (the count histogram channel the kernel is not built for)."""
    if objective not in ("binary", "regression"):
        raise NotImplementedError(
            f"objective {objective!r} is not ported yet (ROADMAP Queue A)")
    if subsample_rate < 1.0 or colsample < 1.0:
        raise NotImplementedError(
            "row/column subsampling is not ported yet (ROADMAP Queue A)")
    if (any(float(m) > 1 for m in min_instances)
            or any(float(g) != 0.0 for g in min_info_gains)
            or (w is not None and not bool((w == np.floor(w)).all()))):
        raise NotImplementedError(
            "count-gated growth (min_instances_per_node > 1, "
            "min_info_gain != 0 or fractional weights) is not ported "
            "yet (ROADMAP Queue A)")


def gbt_base_score(objective: str, W: np.ndarray, y: np.ndarray):
    """Starting margins: the log-odds of the weighted positive share
    (clipped to [1e-6, 1 - 1e-6]) for the binary objective, the weighted
    mean label for regression.  ``W`` (N,) is one fit's weights and gives
    a float32 scalar in the JAX package's sequential-fit arithmetic; (S,
    N) chains' weights give (S,) float32 in its grid group's arithmetic
    (float32 sums and quotient), so either path starts where the JAX one
    does, bit for bit."""
    W = np.asarray(W, np.float32)
    if W.ndim == 1:
        if objective == "binary":
            pos, tot = float((W * y).sum()), float(W.sum())
            p0 = min(max(pos / max(tot, 1e-9), 1e-6), 1 - 1e-6)
            return np.float32(np.log(p0 / (1 - p0)))
        return np.float32((W @ y) / max(W.sum(), 1e-9))
    if objective == "binary":
        pos = (W * y[None, :]).sum(axis=1)
        p0 = np.clip(pos / np.maximum(W.sum(axis=1), 1e-9), 1e-6, 1 - 1e-6)
        return np.log(p0 / (1 - p0)).astype(np.float32)
    return ((W @ y) / np.maximum(W.sum(axis=1), 1e-9)).astype(np.float32)


def gbt_grad_hess(objective: str, F: torch.Tensor, y: torch.Tensor,
                  W: torch.Tensor):
    """Per-row gradient and hessian (N,) of one chain's margins ``F``:
    binary logistic (w (p - y), w max(p (1 - p), 1e-6)) or squared error
    (w (F - y), w)."""
    if objective == "binary":
        P = torch.sigmoid(F)
        return W * (P - y), W * torch.clamp(P * (1 - P), min=1e-6)
    return W * (F - y), W


def gbt_es_metric(objective: str, F_val: torch.Tensor, y_val: torch.Tensor
                  ) -> torch.Tensor:
    """The early-stopping metric of one chain's validation margins, larger
    better: AuPR of the sigmoid, or minus the unweighted mean squared
    error."""
    if objective == "binary":
        return aupr_device(y_val, torch.sigmoid(F_val))
    return -torch.mean((F_val - y_val) ** 2)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class OpGBTClassifier(_GBTBase):
    """Binary GBT (OpGBTClassifier parity)."""
    _op_name = "gbtCls"
    _objective = "binary"


class OpGBTRegressor(_GBTBase):
    """Squared-error GBT (OpGBTRegressor parity)."""
    _op_name = "gbtReg"
    _objective = "regression"


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


class OpXGBoostRegressor(OpXGBoostClassifier):
    """XGBoost-parameterised boosted regressor (squared error)."""

    _op_name = "xgbReg"
    _objective = "regression"

    def fit_raw(self, X, y, w=None, device=None):
        return _GBTBase.fit_raw(self, X, y, w, device=device)


#: the JAX package's sparse rule: a matrix of at least this many elements
#: whose sampled zero fraction reaches _SPARSE_ZERO_FRAC takes the
#: nonzero-aware sketch
_SPARSE_MIN_ELEMS = 1 << 24
_SPARSE_ZERO_FRAC = 0.75

#: how many times ``prep_tree_inputs`` took each sketch, by kind
SKETCH_KINDS = {"dense": 0, "sparse_aware": 0}


def sketch_kind(X: torch.Tensor) -> str:
    """``"sparse_aware"`` for a matrix of at least ``_SPARSE_MIN_ELEMS``
    elements whose every (n // 4096)-th row is at least
    ``_SPARSE_ZERO_FRAC`` zero, else ``"dense"``.  The zeros are counted
    as an integer and divided in float64, as the JAX package's host mean
    of booleans is, so a fraction at the threshold decides the same."""
    if X.numel() < _SPARSE_MIN_ELEMS:
        return "dense"
    sample = X[::max(1, X.shape[0] // 4096)]
    zeros = int((sample == 0).sum())
    return ("sparse_aware" if zeros / sample.numel() >= _SPARSE_ZERO_FRAC
            else "dense")


def prep_tree_inputs(X: torch.Tensor, max_bins: int, row_weight=None):
    """Bin edges and the binned matrix of a tree fit: the quantile sketch
    (``sketch_kind``'s choice) over the rows up to the last one of
    positive ``row_weight`` (a trailing block of zero-weight rows never
    moves the edges; interior ones stay in the sketch, as in the JAX
    package's weighted sketch), binning over every row."""
    Xm = X
    if row_weight is not None:
        nz = np.flatnonzero(np.asarray(row_weight) > 0)
        if len(nz):
            Xm = X[:nz[-1] + 1]
    kind = sketch_kind(Xm)
    SKETCH_KINDS[kind] += 1
    edges = (quantile_bins_sparse_aware(Xm, max_bins)
             if kind == "sparse_aware" else quantile_bins(Xm, max_bins))
    return edges, apply_bins(X, edges)


def _feature_subset_size(strategy: str, d: int,
                         classification: bool = True) -> int:
    """A forest's per-tree feature count: ``auto`` is ``sqrt`` for a
    classifier and ``onethird`` for a regressor."""
    if strategy == "all":
        return d
    if strategy == "sqrt" or (strategy == "auto" and classification):
        return max(1, int(np.sqrt(d)))
    if strategy == "onethird" or (strategy == "auto" and not classification):
        return max(1, d // 3)
    return d


class _RandomForestBase(PredictorEstimator):
    """Bagged random forest (Spark's parameters): ``num_trees`` trees on
    Poisson(``subsample_rate``) bags, each over a
    ``feature_subset_strategy`` subset of the features, grown to
    ``max_depth`` with splits gated by ``min_instances_per_node`` bag
    weight per child and ``min_info_gain`` gain per unit of node weight."""

    _op_name = "randomForest"
    _classification = True

    def __init__(self, num_trees: int = 20, max_depth: int = 5,
                 max_bins: int = 32, min_instances_per_node: int = 1,
                 min_info_gain: float = 0.0, subsample_rate: float = 1.0,
                 feature_subset_strategy: str = "auto", seed: int = 42,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name=self._op_name, uid=uid)
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
        """Fit on a (N, D) matrix and labels (in {0, .., K-1} for the
        classifier: K = the largest label + 1, at least 2), on ``device``
        (else the stage's, else the default device).
        ``metadata["hist_levels"]`` counts the per-level histograms
        built."""
        dev = resolve_device(device if device is not None else self.device)
        X = torch.as_tensor(X, dtype=torch.float32).to(dev)
        y = np.asarray(y, np.float32)
        cls = self._classification
        k = max(int(y.max()) + 1, 2) if cls and len(y) else 2
        n, d = X.shape
        edges, binned = prep_tree_inputs(X, self.max_bins)
        base_w = (torch.ones(n, dtype=torch.float32, device=dev) if w is None
                  else torch.as_tensor(np.asarray(w, np.float32)).to(dev))
        msub = _feature_subset_size(self.feature_subset_strategy, d, cls)
        forest = grow_forest_rf(
            binned, torch.from_numpy(y).to(dev), base_w, seed=self.seed,
            n_trees=self.num_trees, msub=msub,
            subsample_rate=self.subsample_rate, max_depth=self.max_depth,
            n_bins=self.max_bins, min_info_gain=self.min_info_gain,
            min_instances=float(self.min_instances_per_node),
            regression=not cls, n_classes=k)
        self.metadata["hist_levels"] = forest.levels
        return TreeEnsembleModel(mode="rf_cls" if cls else "rf_reg",
                                 edges=edges, feat=forest.feat,
                                 thresh=forest.thresh, leaf=forest.leaf,
                                 n_classes=k)


class OpRandomForestClassifier(_RandomForestBase):
    """Bagged random forest classifier, binary or K-class: the leaves hold
    class shares, a probability is their mean over the trees."""

    _op_name = "randomForestCls"
    _classification = True


class OpRandomForestRegressor(_RandomForestBase):
    """Bagged random forest regressor: the leaves hold the bag-weighted
    mean label; a prediction is the mean over the trees."""

    _op_name = "randomForestReg"
    _classification = False
