"""Grid-batched candidate groups (counterpart of
``transmogrifai_tpu.selector.grid_groups``), binary only.

A run of candidates of one estimator family fits as one batched solve over
a (folds, candidates) grid, and the per-fold validation metrics come back
as one (C, F) device matrix.  The sweep consumes groups transparently: a
group that declines (returns None) or raises falls back to the candidates'
sequential fits.  A group whose ``run`` solved an appended full-train
weight row also hands the selector the winner's refit model.

Not ported yet (ROADMAP Queue A): the linear-regression, softmax and GBT
groups, multiclass and regression forests, and the sweep mesh (sharded
placement, cost-model observations; the JAX package's compile-depth hint
has no counterpart, nothing here is compiled).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..evaluators.metrics import binary_metric_grid
from ..models.classification import (LogisticRegressionModel,
                                     OpLogisticRegression)
from ..models.gbdt_kernels import grow_rf_grid, predict_ensemble
from ..models.linear import fit_logreg_grid
from ..models.trees import (OpRandomForestClassifier, TreeEnsembleModel,
                            _feature_subset_size, prep_tree_inputs,
                            rf_probability)

__all__ = ["GridGroup", "LogRegGridGroup", "TreeGridGroup", "RFGridGroup",
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


def _score_forest(binned, feat, thresh, leaf, depth: int) -> torch.Tensor:
    """Class-1 probability of every row under one forest."""
    raw = predict_ensemble(binned, feat, thresh, leaf, depth)
    return rf_probability(raw, feat.shape[0])[:, 1]


class RFGridGroup(TreeGridGroup):
    """Every (candidate x fold) binary random forest as one tree stream
    (``gbdt_kernels.grow_rf_grid``): per-pair (min_info_gain,
    min_instances, depth) and fold weights over shared bags.

    Depth-truncation sharing: candidates that differ only in ``max_depth``
    share bags and folds, and a level-wise tree cut at a depth is exactly
    the shallower candidate's tree, so one base forest grows per distinct
    (min_info_gain, min_instances) at that group's deepest depth and every
    shallower candidate is read off the base trees' leaf snapshots."""

    _batchable = ("max_depth", "min_info_gain", "min_instances_per_node")
    _static = ("num_trees", "max_bins", "subsample_rate",
               "feature_subset_strategy", "seed")

    def run(self, X, y, weight_ctxs):
        if (not self._batchable_params() or (len(y) and np.nanmax(y) > 1)
                or self.metric not in ("AuPR", "AuROC")):
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
            self._param(p0, "feature_subset_strategy"), d)
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
            subsample_rate=subsample, n_bins=mb, leaf_levels=leaf_levels)
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
                scores[f, c] = _score_forest(binned, *forest)
        self._refit_ctx = dict(
            binned=binned, y=yt, edges=edges, msub=msub, mb=mb, T=T,
            key2base=key2base, cand_key=cand_key, cand_depth=cand_depth,
            base_depth=base_depth, leaf_levels=leaf_levels,
            full_w=torch.from_numpy(full_w).to(dev), seed=seed,
            subsample=subsample)
        m = binary_metric_grid(yt, scores, W_ev, self.metric)
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
            leaf_levels=ctx["leaf_levels"])
        self.trees_grown += ctx["T"]
        self.hist_levels += grown.levels
        if dt < bd:
            nd = 2 ** dt - 1
            feat, thresh = grown.feat[0][:, :nd], grown.thresh[0][:, :nd]
            leaf = grown.snaps[dt][0]
        else:
            feat, thresh, leaf = grown.feat[0], grown.thresh[0], grown.leaf[0]
        return TreeEnsembleModel(mode="rf_cls", edges=ctx["edges"],
                                 feat=feat, thresh=thresh, leaf=leaf,
                                 n_classes=2)


def make_grid_group(proto, grid_points, problem_type: str,
                    metric: str) -> Optional[GridGroup]:
    """A batched group for a binary LR or random-forest grid scored by
    AuPR or AuROC, else None (sequential fits)."""
    if (len(grid_points) == 0 or problem_type != "binary"
            or metric not in ("AuPR", "AuROC")):
        return None
    if type(proto) is OpLogisticRegression:
        return LogRegGridGroup(proto, grid_points, metric)
    if type(proto) is OpRandomForestClassifier:
        return RFGridGroup(proto, grid_points, metric)
    return None
