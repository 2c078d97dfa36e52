"""Grid-batched candidate groups (counterpart of
``transmogrifai_tpu.selector.grid_groups``) for binary, multiclass and
regression problems.

A run of candidates of one estimator family fits as one batched solve over
a (folds, candidates) grid, and the per-fold validation metrics come back
as one (C, F) device matrix.  The sweep consumes groups transparently: a
group that declines (returns None) or raises falls back to the candidates'
sequential fits.  A group whose ``run`` solved an appended full-train
weight row also hands the selector the winner's refit model.

Groups: ``LogRegGridGroup`` (binary LR), ``SoftmaxGridGroup``
(multiclass LR), ``LinRegGridGroup`` (linear regression), ``RFGridGroup``
(binary, K-class and regression forests) and ``GBTGridGroup`` (boosted
chains advanced in lockstep, binary and regression).

Not ported yet (ROADMAP Queue A): the sweep mesh (sharded placement,
cost-model observations; the JAX package's compile-depth hint has no
counterpart, nothing here is compiled).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..evaluators.metrics import (MULTICLASS_METRICS, REGRESSION_METRICS,
                                  binary_metric_grid, multiclass_metric_grid,
                                  regression_metric_grid)
from ..models.classification import (LogisticRegressionModel,
                                     OpLogisticRegression)
from ..models.gbdt_kernels import grow_rf_grid, predict_ensemble
from ..models.linear import (fit_linreg_grid, fit_logreg_grid,
                             fit_softmax_grid)
from ..models.regression import LinearRegressionModel, OpLinearRegression
from ..models.trees import (OpRandomForestClassifier,
                            OpRandomForestRegressor, TreeEnsembleModel,
                            _feature_subset_size, _GBTBase, boost_chains,
                            check_gbt_supported, gbt_base_score,
                            prep_tree_inputs, rf_probability)

__all__ = ["GridGroup", "LogRegGridGroup", "SoftmaxGridGroup",
           "LinRegGridGroup", "TreeGridGroup", "RFGridGroup", "GBTGridGroup",
           "make_grid_group"]


class GridGroup:
    """One batched fit+score+metric solve for C candidates.

    ``run(X, y, weight_ctxs)`` returns a (C, F) metric tensor, rows in
    ``grid_points`` order, or None to decline.  ``X`` is the (N, D) device
    matrix; ``y`` and the per-fold (train, eval) weights are host arrays."""

    #: the candidates' params a group may batch, and those it needs equal
    _batchable: Tuple[str, ...] = ()
    _static: Tuple[str, ...] = ()

    def __init__(self, proto, grid_points: Sequence[Dict[str, Any]],
                 metric: str):
        self.proto = proto
        self.grid_points = list(grid_points)
        self.metric = metric
        #: wall of the last ``run``, and its exception where it raised
        #: (set by the sweep)
        self.seconds: Optional[float] = None
        self.error: Optional[str] = None

    def run(self, X: torch.Tensor, y: np.ndarray, weight_ctxs):
        raise NotImplementedError

    def refit_model(self, row: int):
        """The full-train model of candidate ``row``, or None."""
        return None

    @staticmethod
    def _full_weights(weight_ctxs) -> np.ndarray:
        """Full-train weights from any one fold: its train and eval masks
        partition the selector's base weights."""
        w_tr, w_ev = weight_ctxs[0]
        return (np.asarray(w_tr, np.float32) + np.asarray(w_ev, np.float32))

    def _param(self, params: Dict[str, Any], name: str):
        return params.get(name, getattr(self.proto, name))

    def _batchable_params(self) -> bool:
        """Whether every grid point sets only batchable or static params
        and agrees with the others on the static ones."""
        allowed = set(self._batchable) | set(self._static)
        if any(set(p) - allowed for p in self.grid_points):
            return False
        return all(len({self._param(p, s) for p in self.grid_points}) == 1
                   for s in self._static)

    @staticmethod
    def _stack_weights(weight_ctxs, device):
        W_tr = np.stack([np.asarray(w, np.float32) for w, _ in weight_ctxs])
        W_ev = np.stack([np.asarray(w, np.float32) for _, w in weight_ctxs])
        return (torch.from_numpy(W_tr).to(device),
                torch.from_numpy(W_ev).to(device))


class _LinearGridGroup(GridGroup):
    _batchable = ("reg_param", "elastic_net_param")
    _static = ("max_iter", "tol", "fit_intercept", "standardization")

    def _regs_alphas(self, device):
        regs = [float(self._param(p, "reg_param")) for p in self.grid_points]
        alphas = [float(self._param(p, "elastic_net_param"))
                  for p in self.grid_points]
        return (torch.tensor(regs, dtype=torch.float32).to(device),
                torch.tensor(alphas, dtype=torch.float32).to(device))


class LogRegGridGroup(_LinearGridGroup):
    """Every binary-LR (fold x candidate) fit in one majorization solve
    (``linear.fit_logreg_grid``), with the full-train weights as one more
    row, whose solution is the winner's refit model."""

    def run(self, X, y, weight_ctxs):
        if not self._batchable_params() or (len(y) and np.nanmax(y) > 1):
            return None
        dev = X.device
        W_tr, W_ev = self._stack_weights(weight_ctxs, dev)
        full = torch.from_numpy(self._full_weights(weight_ctxs)).to(dev)
        F = W_tr.shape[0]
        regs, alphas = self._regs_alphas(dev)
        p0 = self.grid_points[0]
        max_iter = int(self._param(p0, "max_iter"))
        yt = torch.from_numpy(np.nan_to_num(np.asarray(y, np.float32))
                              ).to(dev)
        scores, _, coef, icpt = fit_logreg_grid(
            X, yt, torch.cat([W_tr, full[None]]), regs, alphas,
            # majorization steps are far cheaper than Newton steps: a
            # proportionally larger budget at a metric-sufficient tolerance
            max_iter=max(150, 4 * max_iter),
            tol=max(float(self._param(p0, "tol")), 1e-5),
            fit_intercept=bool(self._param(p0, "fit_intercept")),
            standardization=bool(self._param(p0, "standardization")))
        self._refit = (coef[F], icpt[F])
        m = binary_metric_grid(yt, scores[:F], W_ev, self.metric)
        return None if m is None else m.T

    def refit_model(self, row: int):
        if getattr(self, "_refit", None) is None:
            return None
        coef, icpt = self._refit
        return LogisticRegressionModel(coef=coef[row],
                                       intercept=float(icpt[row]))


class SoftmaxGridGroup(_LinearGridGroup):
    """Every multiclass-LR (fold x candidate) fit in one Böhning
    majorization solve (``linear.fit_softmax_grid``), scored by the
    argmax labels against the multiclass metric grid.  Declines (None)
    above ``MAX_LOGIT_ELEMS`` (F, C, K, N) logits — the solve holds a few
    such tensors at once — and the selector then fits the candidates one
    by one, as the JAX package does.  No full-train row: a softmax winner
    is refit sequentially (``fit_multinomial_logreg``)."""

    MAX_LOGIT_ELEMS = 2e8

    def __init__(self, proto, grid_points, metric, n_classes: int = 2):
        super().__init__(proto, grid_points, metric)
        self.n_classes = n_classes

    def run(self, X, y, weight_ctxs):
        if not self._batchable_params():
            return None
        n_classes = self.n_classes
        if len(y):
            n_classes = max(n_classes, int(np.nanmax(y)) + 1)
        F, C, n = len(weight_ctxs), len(self.grid_points), len(y)
        if F * C * n * n_classes > self.MAX_LOGIT_ELEMS:
            return None
        dev = X.device
        W_tr, W_ev = self._stack_weights(weight_ctxs, dev)
        regs, alphas = self._regs_alphas(dev)
        p0 = self.grid_points[0]
        yi = torch.from_numpy(np.nan_to_num(np.asarray(y, np.float32))
                              .astype(np.int64)).to(dev)
        logits, _ = fit_softmax_grid(
            X, yi, n_classes, W_tr, regs, alphas,
            max_iter=max(150, 4 * int(self._param(p0, "max_iter"))),
            tol=max(float(self._param(p0, "tol")), 1e-5),
            fit_intercept=bool(self._param(p0, "fit_intercept")),
            standardization=bool(self._param(p0, "standardization")))
        preds = torch.argmax(logits, dim=2)                  # (F, C, N)
        del logits
        m = multiclass_metric_grid(yi, preds, W_ev, n_classes, self.metric)
        return None if m is None else m.T


class LinRegGridGroup(_LinearGridGroup):
    """Every linear-regression (fold x candidate) fit in one Gram-sharing
    solve (``linear.fit_linreg_grid``), with the full-train weights as one
    more row, whose solution is the winner's refit model."""

    def run(self, X, y, weight_ctxs):
        if not self._batchable_params():
            return None
        dev = X.device
        W_tr, W_ev = self._stack_weights(weight_ctxs, dev)
        full = torch.from_numpy(self._full_weights(weight_ctxs)).to(dev)
        F = W_tr.shape[0]
        regs, alphas = self._regs_alphas(dev)
        p0 = self.grid_points[0]
        yt = torch.from_numpy(np.nan_to_num(np.asarray(y, np.float32))
                              ).to(dev)
        preds, coef, icpt = fit_linreg_grid(
            X, yt, torch.cat([W_tr, full[None]]), regs, alphas,
            max_iter=int(self._param(p0, "max_iter")),
            tol=float(self._param(p0, "tol")),
            fit_intercept=bool(self._param(p0, "fit_intercept")),
            standardization=bool(self._param(p0, "standardization")))
        self._refit = (coef[F], icpt[F])
        m = regression_metric_grid(yt, preds[:F], W_ev, self.metric)
        return None if m is None else m.T

    def refit_model(self, row: int):
        if getattr(self, "_refit", None) is None:
            return None
        coef, icpt = self._refit
        return LinearRegressionModel(coef=coef[row],
                                     intercept=float(icpt[row]))


class TreeGridGroup(GridGroup):
    """Base of the tree-family groups: counts the trees a group grew and
    the per-level histograms it built, and times its growth and its
    candidates' scoring apart (each synchronised with the device)."""

    def __init__(self, proto, grid_points, metric: str):
        super().__init__(proto, grid_points, metric)
        self.trees_grown = 0
        self.hist_levels = 0
        self.phase_seconds: Dict[str, float] = {}

    def _lap(self, phase: str, t0: float, device) -> float:
        """Add the wall since ``t0`` to ``phase``; returns the new t0."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        self.phase_seconds[phase] = (self.phase_seconds.get(phase, 0.0)
                                     + t1 - t0)
        return t1


def _score_forest(binned, feat, thresh, leaf, depth: int,
                  problem: str) -> torch.Tensor:
    """Every row's score under one forest: the class-1 probability
    (``binary``), the argmax class (``multiclass``) or the regression
    prediction, the mean of the trees (``regression``)."""
    raw = predict_ensemble(binned, feat, thresh, leaf, depth)
    if problem == "regression":
        return raw[:, 0] / feat.shape[0]
    proba = rf_probability(raw, feat.shape[0])
    if problem == "multiclass":
        return proba.argmax(dim=1).to(torch.float32)
    return proba[:, 1]


class RFGridGroup(TreeGridGroup):
    """Every (candidate x fold) random forest — binary or K-class
    classification (K-class: one-hot targets, the level histograms at K
    channels, argmax scores against the multiclass metric grid), or
    regression — as one tree stream (``gbdt_kernels.grow_rf_grid``):
    per-pair (min_info_gain, min_instances, depth) and fold weights over
    shared bags.  ``n_classes`` is the selector's class count; the labels
    can only raise it.  Declines (None) before growing anything when the
    label space and the metric family disagree.

    Depth-truncation sharing: candidates that differ only in ``max_depth``
    share bags and folds, and a level-wise tree cut at a depth is exactly
    the shallower candidate's tree, so one base forest grows per distinct
    (min_info_gain, min_instances) at that group's deepest depth and every
    shallower candidate is read off the base trees' leaf snapshots."""

    _batchable = ("max_depth", "min_info_gain", "min_instances_per_node")
    _static = ("num_trees", "max_bins", "subsample_rate",
               "feature_subset_strategy", "seed")

    def __init__(self, proto, grid_points, metric: str, n_classes: int = 2):
        super().__init__(proto, grid_points, metric)
        self.n_classes = n_classes

    def run(self, X, y, weight_ctxs):
        cls = self.proto._classification
        n_classes = self.n_classes
        if cls and len(y):
            n_classes = max(n_classes, int(np.nanmax(y)) + 1)
        problem = ("regression" if not cls
                   else "multiclass" if n_classes > 2 else "binary")
        family = {"binary": ("AuPR", "AuROC"),
                  "multiclass": MULTICLASS_METRICS,
                  "regression": REGRESSION_METRICS}[problem]
        if not self._batchable_params() or self.metric not in family:
            return None
        dev = X.device
        t0 = time.perf_counter()
        p0 = self.grid_points[0]
        mb = int(self._param(p0, "max_bins"))
        T = int(self._param(p0, "num_trees"))
        subsample = float(self._param(p0, "subsample_rate"))
        seed = int(self._param(p0, "seed"))
        full_w = self._full_weights(weight_ctxs)
        # zero-weight rows past the last training row never move the edges
        edges, binned = prep_tree_inputs(X, mb, row_weight=full_w)
        t0 = self._lap("binning", t0, dev)
        n, d = X.shape
        msub = _feature_subset_size(
            self._param(p0, "feature_subset_strategy"), d, cls)
        yt = torch.from_numpy(np.nan_to_num(np.asarray(y, np.float32))
                              ).to(dev)
        W_tr, W_ev = self._stack_weights(weight_ctxs, dev)
        F, C = W_tr.shape[0], len(self.grid_points)

        # a stump (depth <= 0) gets a base of its own
        cand_depth = [max(0, int(self._param(p, "max_depth")))
                      for p in self.grid_points]
        cand_key = [(float(self._param(p, "min_info_gain")),
                     float(self._param(p, "min_instances_per_node")))
                    + (() if cand_depth[i] > 0 else (0,))
                    for i, p in enumerate(self.grid_points)]
        base_keys: List[tuple] = []
        key2base: Dict[tuple, int] = {}
        for key in cand_key:
            if key not in key2base:
                key2base[key] = len(base_keys)
                base_keys.append(key)
        base_depth = [0] * len(base_keys)
        for c in range(C):
            bi = key2base[cand_key[c]]
            base_depth[bi] = max(base_depth[bi], cand_depth[c])
        leaf_levels = sorted({cand_depth[c] for c in range(C)
                              if cand_depth[c]
                              < base_depth[key2base[cand_key[c]]]})

        # base pair p = base * F + fold
        grown = grow_rf_grid(
            binned, yt, W_tr, seed=seed, n_trees=T,
            pair_fold=np.tile(np.arange(F), len(base_keys)),
            pair_min_ig=np.repeat([k[0] for k in base_keys], F),
            pair_min_inst=np.repeat([k[1] for k in base_keys], F),
            pair_depth=np.repeat(base_depth, F), msub=msub,
            subsample_rate=subsample, n_bins=mb, leaf_levels=leaf_levels,
            regression=not cls, n_classes=n_classes)
        self.trees_grown += len(base_keys) * F * T
        self.hist_levels += grown.levels
        heap_depth = int(np.log2(grown.feat.shape[2] + 1))
        t0 = self._lap("grow", t0, dev)

        # candidate pair (c, f) -> its base pair, cut at its own depth
        scores = torch.empty((F, C, n), dtype=torch.float32, device=dev)
        for c in range(C):
            bi, dt = key2base[cand_key[c]], cand_depth[c]
            for f in range(F):
                p = bi * F + f
                if dt == base_depth[bi]:
                    forest = (grown.feat[p], grown.thresh[p], grown.leaf[p],
                              heap_depth)
                else:
                    nd = 2 ** dt - 1
                    forest = (grown.feat[p][:, :nd], grown.thresh[p][:, :nd],
                              grown.snaps[dt][p], dt)
                scores[f, c] = _score_forest(binned, *forest, problem)
        self._refit_ctx = dict(
            binned=binned, y=yt, edges=edges, msub=msub, mb=mb, T=T,
            key2base=key2base, cand_key=cand_key, cand_depth=cand_depth,
            base_depth=base_depth, leaf_levels=leaf_levels,
            full_w=torch.from_numpy(full_w).to(dev), seed=seed,
            subsample=subsample, cls=cls, n_classes=n_classes)
        if problem == "multiclass":
            m = multiclass_metric_grid(yt, scores, W_ev, n_classes,
                                       self.metric)
        else:
            m = (binary_metric_grid if cls else regression_metric_grid)(
                yt, scores, W_ev, self.metric)
        self._lap("score", t0, dev)
        return None if m is None else m.T

    def refit_model(self, row: int):
        """The full-train forest of candidate ``row``: its base pair grown
        once more on the full training weights (the same bags as every
        fold's), cut at the candidate's depth."""
        ctx = getattr(self, "_refit_ctx", None)
        if ctx is None:
            return None
        key = ctx["cand_key"][row]
        bd = ctx["base_depth"][ctx["key2base"][key]]
        dt = ctx["cand_depth"][row]
        grown = grow_rf_grid(
            ctx["binned"], ctx["y"], ctx["full_w"][None], seed=ctx["seed"],
            n_trees=ctx["T"], pair_fold=[0], pair_min_ig=[key[0]],
            pair_min_inst=[key[1]], pair_depth=[bd], msub=ctx["msub"],
            subsample_rate=ctx["subsample"], n_bins=ctx["mb"],
            leaf_levels=ctx["leaf_levels"], regression=not ctx["cls"],
            n_classes=ctx["n_classes"])
        self.trees_grown += ctx["T"]
        self.hist_levels += grown.levels
        if dt < bd:
            nd = 2 ** dt - 1
            feat, thresh = grown.feat[0][:, :nd], grown.thresh[0][:, :nd]
            leaf = grown.snaps[dt][0]
        else:
            feat, thresh, leaf = grown.feat[0], grown.thresh[0], grown.leaf[0]
        return TreeEnsembleModel(
            mode="rf_cls" if ctx["cls"] else "rf_reg", edges=ctx["edges"],
            feat=feat, thresh=thresh, leaf=leaf,
            n_classes=ctx["n_classes"] if ctx["cls"] else 2)


class GBTGridGroup(TreeGridGroup):
    """Every (candidate x fold) boosting chain, advanced in lockstep one
    round at a time (the JAX package's ``GBTGridGroup``), binary logistic
    or squared error.

    Chain s = c * F + f boosts candidate c on fold f's training weights,
    with its own depth, eta, lambda, min_child_weight and gamma, through
    ``boost_chains`` (the loop a sequential fit runs as one chain): early
    stopping on the same validation rows as a sequential fit (the
    ``seed``'s draw) with per-chain lagged patience, GOSS when every chain
    is deep.  A chain's validation scores come from its first ``best_len``
    trees.  No full-train refit chains, as in the JAX group: a GBT winner
    is refit sequentially.  Declines (None) for other objectives, mixed
    static attributes and subsampling; raises for count-gated growth, as
    the sequential fits do."""

    _STATIC = ("max_iter", "max_bins", "early_stopping_rounds",
               "validation_fraction", "seed", "subsample_rate", "colsample",
               "sparse_default_direction")

    def _chains(self):
        """The candidates' estimators (attribute-level params, robust to
        constructor aliases such as XGBoost's eta -> step_size)."""
        return [self.proto.copy(**p) for p in self.grid_points]

    def run(self, X, y, weight_ctxs):
        ests = self._chains()
        e0 = ests[0]
        obj = e0._objective
        if obj not in ("binary", "regression"):
            return None
        if obj == "binary" and len(y) and np.nanmax(y) > 1:
            return None
        if any(len({getattr(e, a) for e in ests}) > 1 for a in self._STATIC):
            return None
        if e0.subsample_rate < 1.0 or e0.colsample < 1.0:
            return None
        dev = X.device
        t0 = time.perf_counter()
        y = np.nan_to_num(np.asarray(y, np.float32))
        n = len(y)
        W_tr = np.stack([np.asarray(w, np.float32) for w, _ in weight_ctxs])
        F, C = W_tr.shape[0], len(ests)
        S = C * F
        chain_fold = np.tile(np.arange(F), C)
        chain_est = [ests[c] for c in np.repeat(np.arange(C), F)]
        rng = np.random.default_rng(e0.seed)
        val = (rng.random(n) < e0.validation_fraction
               if e0.early_stopping_rounds > 0 else np.zeros(n, bool))
        # full fold weights for the starting margins, the early-stopping
        # train weights for the gradients (sequential fit_raw parity)
        W_full = W_tr[chain_fold]
        W_train = W_full * (~val)[None, :]
        check_gbt_supported(obj, 1.0, 1.0,
                            [e.min_instances_per_node for e in ests],
                            [e.min_info_gain for e in ests], W_train)
        edges, binned = prep_tree_inputs(X, int(e0.max_bins),
                                         row_weight=self._full_weights(
                                             weight_ctxs))
        t0 = self._lap("binning", t0, dev)

        base = gbt_base_score(obj, W_full, y)
        yt = torch.from_numpy(y).to(dev)
        out = boost_chains(chain_est, binned, edges, yt,
                           torch.from_numpy(W_train).to(dev),
                           torch.from_numpy(base), np.flatnonzero(val))
        trees, best_len = out.trees, out.best_len
        self.trees_grown += sum(len(t) for t in trees)
        self.hist_levels += out.levels
        self.best_len = best_len.copy()
        t0 = self._lap("grow", t0, dev)

        scores = torch.empty((S, n), dtype=torch.float32, device=dev)
        for s in range(S):
            kept = trees[s][:int(best_len[s])]
            raw = predict_ensemble(
                binned, torch.stack([t.feat for t in kept]),
                torch.stack([t.thresh for t in kept]),
                torch.stack([t.leaf for t in kept]),
                int(chain_est[s].max_depth))[:, 0]
            z = raw + float(base[s])
            scores[s] = torch.sigmoid(z) if obj == "binary" else z
        self.chain_trees = trees
        scores = scores.reshape(C, F, n).transpose(0, 1)
        W_ev = torch.from_numpy(np.stack([np.asarray(w, np.float32)
                                          for _, w in weight_ctxs])).to(dev)
        fn = binary_metric_grid if obj == "binary" else regression_metric_grid
        m = fn(yt, scores, W_ev, self.metric)
        self._lap("score", t0, dev)
        return None if m is None else m.T


def make_grid_group(proto, grid_points, problem_type: str,
                    metric: str, n_classes: int = 2) -> Optional[GridGroup]:
    """A batched group for the candidates' family under the problem type
    and metric (the JAX package's table), else None (sequential fits):
    LR, forests and boosted trees for binary problems scored by AuPR or
    AuROC; softmax LR and K-class forests for multiclass problems scored
    by F1, Error, Accuracy, Precision or Recall (``n_classes``: the
    selector's class count); linear regression, forests and boosted trees
    for regression scored by RMSE, MSE, MAE or R2."""
    if len(grid_points) == 0:
        return None
    if problem_type == "binary" and metric in ("AuPR", "AuROC"):
        if type(proto) is OpLogisticRegression:
            return LogRegGridGroup(proto, grid_points, metric)
        if type(proto) is OpRandomForestClassifier:
            return RFGridGroup(proto, grid_points, metric)
    if problem_type == "multiclass" and metric in MULTICLASS_METRICS:
        if type(proto) is OpLogisticRegression:
            return SoftmaxGridGroup(proto, grid_points, metric, n_classes)
        if type(proto) is OpRandomForestClassifier:
            return RFGridGroup(proto, grid_points, metric, n_classes)
    if problem_type == "regression" and metric in REGRESSION_METRICS:
        if type(proto) is OpLinearRegression:
            return LinRegGridGroup(proto, grid_points, metric)
        if type(proto) is OpRandomForestRegressor:
            return RFGridGroup(proto, grid_points, metric)
    if isinstance(proto, _GBTBase) and (
            (problem_type == "binary" and proto._objective == "binary"
             and metric in ("AuPR", "AuROC"))
            or (problem_type == "regression"
                and proto._objective == "regression"
                and metric in REGRESSION_METRICS)):
        return GBTGridGroup(proto, grid_points, metric)
    return None
