"""Tree model stages (counterpart of ``transmogrifai_tpu.models.trees``).

Ported: ``OpGBTClassifier``, ``OpXGBoostClassifier`` (binary, or softmax
over K classes), ``OpGBTRegressor`` and ``OpXGBoostRegressor``: a fit is
one chain of ``boost_chains``, the boosting loop that the lockstep grid
group runs over many — rounds run in chunks of ``es_chunk``, the
early-stopping metric (validation AuPR, accuracy, or minus the validation
MSE) of each chunk is read one chunk late so the device never waits on
the host, and the ensemble is trimmed to the best round count; count-gated
growth (``min_instances_per_node``, ``min_info_gain``, fractional
weights) grows with the count channel, row and column subsampling draw
from the JAX package's numpy stream, and deep fits on many rows grow each
round on a GOSS row sample (``gbdt_kernels.goss_plan``).  A Python loop
over rounds takes the place of ``lax.scan``.  ``OpRandomForestClassifier``
(K classes) and ``OpRandomForestRegressor``: Poisson bags, square-root
(classification) or one-third (regression) feature subsets, count-gated
growth (``gbdt_kernels.grow_forest_rf``).  ``OpDecisionTreeClassifier``
and ``OpDecisionTreeRegressor``: one unbagged tree of mean leaves on the
general grower.  ``TreeEnsembleModel`` scores the ``gbdt_binary``,
``gbdt_multi``, ``gbdt_reg``, ``rf_cls`` and ``rf_reg`` modes.

Boosted fits and forests bin through ``prep_tree_inputs``, which takes
the nonzero-aware sketch for a wide, mostly zero matrix as the JAX package
does; decision trees bin through the dense sketch, as the JAX package's
do.  Every sketch, binned matrix, bundling plan and CSR goes through the
sweep memo (``memo_get``): a selector's candidates, which all fit on the
same matrix with fold weights, and the scoring of that matrix with a
fit's edges share one binning per distinct (matrix, sketch).  The memo is
keyed on the matrix tensor's identity and ``_version`` (an in-place write
misses), its shape, strides, dtype and device, and the edges' content; it
holds at most ``_BIN_CACHE_CAPACITY`` entries, drops a matrix's entries
when the matrix is freed, and ``clear_sweep_caches`` (which
``OpWorkflow.train`` calls at its end) empties it.  Boosted fits bundle
mutually exclusive columns (EFB, ``TMOG_EFB``) where the JAX package does,
and grow through the CSR histogram path under ``TMOG_SPARSE_HIST=1``.
The memo dedupes builds in flight: a fit that asks for an entry the
selector's prefetch thread is building waits for it instead of building
it twice.

Not ported (it has no counterpart here): the JAX package's bf16 upload
of large matrices (``_dev_f32``), which saves bytes on a remote TPU's
link.  Not ported yet (ROADMAP Queue A item 6.7): the ``with_mesh``
paths.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import as_device_tensor, resolve_device
from ..evaluators.metrics import aupr_es
from ..types.columns import ColumnarDataset
from ..utils.profiling import upload_timed
from . import gbdt_kernels
from .gbdt_kernels import (
    EFB_MIN_WIDTH_RATIO, FeatureBundles, FeatureCSR, HistFn, TreeArrays,
    apply_bins, build_feature_csr, bundle_features, bundle_matrix,
    csr_hist_fn, default_dir_mask, goss_plan, goss_rows, grow_forest_rf,
    grow_tree, predict_ensemble, predict_tree, predict_tree_bundled,
    quantile_bins, quantile_bins_sparse_aware, seg_level_hists,
    unbundle_ensemble,
)
from .prediction import PredictionBatch, PredictorEstimator, PredictorModel

__all__ = ["OpGBTClassifier", "OpXGBoostClassifier", "OpGBTRegressor",
           "OpXGBoostRegressor", "OpRandomForestClassifier",
           "OpRandomForestRegressor", "OpDecisionTreeClassifier",
           "OpDecisionTreeRegressor", "TreeEnsembleModel",
           "BoostedChains", "boost_chains", "skip_counts",
           "es_patience_vec", "clear_sweep_caches", "memo_get", "MEMO_STATS",
           "prep_tree_inputs", "binned_for_edges", "dense_tree_inputs",
           "prep_tree_csr", "efb_enabled", "maybe_bundle", "EFBInputs"]

_MODES = ("gbdt_binary", "gbdt_multi", "gbdt_reg", "rf_cls", "rf_reg")


class TreeEnsembleModel(PredictorModel):
    """Fitted tree ensemble.  ``gbdt_binary``: raw margin = base_score +
    sum of trees, probability = sigmoid.  ``gbdt_multi``: K class margins
    = base_score + sum of trees, probability = their softmax, prediction
    = the argmax class.  ``gbdt_reg``: the prediction is
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
        binned = binned_for_edges(X, self.edges)
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
        if self.mode == "gbdt_multi":
            z = self.raw_margin(X) + self.base_score
            e = torch.exp(z - z.max(dim=1, keepdim=True).values)
            proba = e / e.sum(dim=1, keepdim=True)
            return PredictionBatch(
                prediction=proba.argmax(dim=1).to(torch.float64),
                raw_prediction=z, probability=proba)
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
    grew (splits on the original columns), the rounds each chain keeps
    (S,), the per-level histograms built, the GOSS budget (None when off),
    the bundled width (d, d_b) (None when the fit grew unbundled) and the
    seconds the bundling plan and its encode took (0 on a memo hit)."""
    trees: List[List[TreeArrays]]
    best_len: np.ndarray
    levels: int
    goss: Optional[Tuple[int, int]]
    efb_width: Optional[Tuple[int, int]] = None
    efb_s: float = 0.0


def skip_counts(ests, W) -> bool:
    """The JAX package's rule for dropping the count channel (bag mode
    ``"newton"``): every chain gates on XGBoost's terms only
    (``min_instances_per_node <= 1``, ``min_info_gain == 0``) and the
    weights ``W`` are integers (the count channel is weighted, so with
    fractional weights ``count >= 1`` can gate a split)."""
    W = np.asarray(W)
    return (all(float(e.min_instances_per_node) <= 1
                and float(e.min_info_gain) == 0.0 for e in ests)
            and bool((W == np.floor(W)).all()))


def boost_chains(ests, binned: torch.Tensor, edges, y: torch.Tensor,
                 W: torch.Tensor, base: torch.Tensor, val_idx,
                 hist_fn: HistFn = seg_level_hists,
                 rng: Optional[np.random.Generator] = None,
                 csr: Optional[FeatureCSR] = None) -> BoostedChains:
    """THE boosting loop: S chains advanced in lockstep one round at a
    time — the JAX package's sequential fits are one chain, its
    ``GBTGridGroup`` one chain per (candidate x fold).

    Chain s boosts from the margins ``base[s]`` on the gradient weights
    ``W[s]`` (N,) with ``ests[s]``'s depth, step, lambda, min_child_weight,
    gamma, min_instances_per_node and min_info_gain; ``ests[0]`` gives
    what the chains share (objective, max_iter, max_bins, early stopping,
    seed, subsampling, default-direction splits).  ``base`` (S, K) — K
    class margins a chain — boosts the softmax objective over labels
    ``y`` in 0..K-1, whatever ``ests[0]``'s objective; ``base`` (S,) boosts
    that objective (binary logistic or squared error).  Trees grow with
    the count channel (2K+1 channels, count gates; the count is the
    round's row weights) wherever the JAX package keeps it: unless
    ``skip_counts`` holds, and always in its per-round loop (softmax and
    subsampled fits).  Row and column subsampling (one chain only) draw from
    ``rng`` every round, as the JAX package's loop does: the rows
    ``rng.random(N) < subsample_rate`` (the round's weights become W x the
    draw), then ``rng.choice(d, int(d * colsample), replace=False)`` as
    the features a split may use.
    Rounds run in chunks of ``es_chunk``: after chunk c is grown, chunk
    c-1's per-chain metrics on the rows ``val_idx`` are fetched in one copy
    and the patience rule replayed (``replay_es``), so the device never
    waits on the host; a stopped chain grows no more trees, and rounds past
    max_iter are not grown.  GOSS engages when every chain is deep
    (``goss_plan`` over the shallowest depth) and the fit is neither
    softmax nor subsampled (the JAX package's per-round loop never
    samples): chain s's tree of round r then grows on
    ``gbdt_kernels.goss_select(|g|, seed, r, s)``'s rows.  ``hist_fn``
    builds every level's histograms (the kernel wrapper by default).

    Where the JAX package bundles (``efb_enabled``, neither softmax nor
    subsampled, no CSR) the chains grow on ``maybe_bundle``'s bundled
    matrix, GOSS samples included, with the member end table, and each
    tree is unbundled as it is grown.  ``csr`` (``prep_tree_csr``): levels
    of up to ``SPARSE_MAX_SLOTS`` slots build from the nonzero entries
    (``csr_hist_fn``), unless GOSS engages."""
    e0 = ests[0]
    dev = binned.device
    S, (n, d) = len(ests), binned.shape
    max_iter, mb = int(e0.max_iter), int(e0.max_bins)
    patience = int(e0.early_stopping_rounds)
    dd_host = default_dir_mask(edges) if e0.sparse_default_direction else None
    base = base.to(dev, torch.float32)
    K = base.shape[1] if base.dim() == 2 else 1
    obj = "multiclass" if base.dim() == 2 else e0._objective
    sub_rows = float(e0.subsample_rate) < 1.0
    sub_cols = float(e0.colsample) < 1.0
    if (sub_rows or sub_cols) and (S != 1 or rng is None):
        raise ValueError("subsampling grows one chain from an rng")
    per_round = obj == "multiclass" or sub_rows or sub_cols
    counts = per_round or not skip_counts(ests, W.cpu().numpy())
    efb, efb_s = None, 0.0
    if not per_round and csr is None and efb_enabled():
        t0 = time.perf_counter()
        efb = maybe_bundle(binned, edges, mb)
        _sync(dev)
        efb_s = time.perf_counter() - t0
    goss = None if per_round else goss_plan(
        n, min(int(e.max_depth) for e in ests))
    if csr is not None and goss is None:
        hist_fn = csr_hist_fn(csr, hist_fn)
    gb, bend = binned, None        # the matrix the trees grow on
    if efb is not None:
        gb, bend = efb.binned, efb.end_bin
        if dd_host is not None:
            dd_host = efb.bundles.bundled_dd_mask(dd_host)
    dd = torch.from_numpy(dd_host).to(dev) if dd_host is not None else None
    es_chunk = max(1, min(8, patience or 8))
    run_es = patience > 0 and len(val_idx) > 0
    vi = torch.from_numpy(np.asarray(val_idx, np.int64)).to(dev)
    y_val = y[vi]
    target = (torch.nn.functional.one_hot(y.long(), K).to(torch.float32)
              if obj == "multiclass" else y)
    Fm = base.reshape(S, 1, K).repeat(1, n, 1)                # (S, N, K)
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
                bw = W[s]
                if sub_rows:
                    bw = bw * torch.from_numpy(
                        (rng.random(n) < float(e0.subsample_rate))
                        .astype(np.float32)).to(dev)
                mask = None
                if sub_cols:
                    mask = np.zeros(d, bool)
                    mask[rng.choice(d, max(1, int(d * float(e0.colsample))),
                                    replace=False)] = True
                    mask = torch.from_numpy(mask).to(dev)
                G, H = gbt_grad_hess(obj, Fm[s], target, bw)
                C = bw if counts else None
                tb = gb
                if goss is not None:
                    idx, mult = gbdt_kernels.goss_select(
                        G[:, 0].abs(), int(e0.seed), rid, s, *goss)
                    tb = goss_rows(gb, idx)
                    G, H = G[idx] * mult[:, None], H[idx] * mult[:, None]
                    C = None if C is None else C[idx] * mult
                tree = grow_tree(
                    tb, G, H, depth, mb, C=C,
                    lam=float(e.reg_lambda),
                    min_child_weight=float(e.min_child_weight),
                    min_info_gain=float(e.min_info_gain),
                    min_instances=float(e.min_instances_per_node),
                    feat_mask=mask,
                    min_gain_raw=float(e.min_split_gain_raw),
                    learning_rate=float(e.step_size),
                    default_dir=bool(e0.sparse_default_direction),
                    dd_mask=dd, hist_fn=hist_fn, bundle_end=bend)
                del tb
                levels += depth
                if efb is None:
                    Fm[s] += predict_tree(binned, *tree, depth)
                else:
                    Fm[s] += predict_tree_bundled(gb, *tree, depth, bend)
                    tree = TreeArrays(*unbundle_ensemble(
                        efb.bundles, tree.feat, tree.thresh, efb.tables),
                        tree.leaf)
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
    return BoostedChains(trees, best_len, levels, goss,
                         None if efb is None else (d, efb.bundles.width),
                         efb_s)


class _GBTBase(PredictorEstimator):
    """Gradient-boosted trees, binary logistic, softmax (``OpXGBoost
    Classifier`` on more than two classes) or squared-error objective:
    Spark-GBT parameterisation (max_iter, step_size, max_depth,
    min_instances_per_node, min_info_gain) with XGBoost extras
    (reg_lambda, min_child_weight, gamma as ``min_split_gain_raw``, row
    and column subsampling, early stopping on a validation slice scored
    by AuPR, accuracy, or minus the MSE for regression)."""

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

    def _fit_objective(self, y: np.ndarray) -> str:
        """The objective a fit on labels ``y`` runs."""
        return self._objective

    def streaming_bin_edges(self, chunks, hist_bins: int = 0) -> np.ndarray:
        """Quantile bin edges from chunked feature matrices: per-feature
        sketches of ``hist_bins`` (default ``8 * max_bins``) bins absorb
        the chunks, and the edges are their quantiles
        (``gbdt_kernels.quantile_bins_streaming``).  The growth itself
        reads the packed matrix, as the out-of-core train's tail does."""
        hists = gbdt_kernels.streaming_histograms_for(
            chunks, hist_bins=hist_bins or 8 * self.max_bins)
        return gbdt_kernels.quantile_bins_streaming(hists, self.max_bins)

    def fit_raw(self, X, y, w=None, device=None) -> TreeEnsembleModel:
        """Fit on a (N, D) matrix (tensor or array) and labels (in {0, 1}
        for the binary objective, 0..K-1 for the softmax one).  Runs on
        ``device`` (else the stage's, else the default device).  The
        validation rows and every round's row and column draws come from
        ``np.random.default_rng(seed)`` in the JAX package's order."""
        dev = resolve_device(device if device is not None else self.device)
        X = torch.as_tensor(X, dtype=torch.float32).to(dev)
        y = np.asarray(y, np.float32)
        n, d = X.shape
        obj = self._fit_objective(y)
        # fit_timing and the profiler ranges below split the fit into its
        # host-heavy binning and its device-heavy boosting
        timing = {}
        with torch.profiler.record_function("tmog.binning"):
            t0 = time.perf_counter()
            edges, binned = prep_tree_inputs(X, self.max_bins)
            csr = prep_tree_csr(X, edges, binned)
            _sync(dev)
            timing["binning_s"] = time.perf_counter() - t0

        rng = np.random.default_rng(self.seed)
        base_w = np.ones(n, np.float32) if w is None else np.asarray(
            w, np.float32)
        val = (rng.random(n) < self.validation_fraction
               if self.early_stopping_rounds > 0 else np.zeros(n, bool))
        train_w = base_w * (~val)
        k = max(int(y.max()) + 1, 2) if obj == "multiclass" else 1
        base = (np.zeros((1, k), np.float32) if obj == "multiclass"
                else np.full(1, gbt_base_score(obj, base_w, y), np.float32))

        with torch.profiler.record_function("tmog.boosting"):
            t0 = time.perf_counter()
            out = boost_chains(
                [self], binned, edges, torch.from_numpy(y).to(dev),
                torch.from_numpy(train_w).to(dev)[None],
                torch.from_numpy(base), np.where(val)[0], rng=rng, csr=csr)
            kept = out.trees[0][:int(out.best_len[0])]
            model = TreeEnsembleModel(
                mode=_GBT_MODES[obj], edges=edges,
                feat=torch.stack([t.feat for t in kept]),
                thresh=torch.stack([t.thresh for t in kept]),
                leaf=torch.stack([t.leaf for t in kept]),
                base_score=0.0 if obj == "multiclass" else float(base[0]),
                n_classes=k if obj == "multiclass" else 2)
            _sync(dev)
            # the bundling plan and encode, timed apart from the rounds
            timing["bundling_s"] = out.efb_s
            timing["boosting_s"] = time.perf_counter() - t0 - out.efb_s
        self.metadata["fit_timing"] = timing
        self.metadata["rounds_grown"] = len(out.trees[0])
        self.metadata["best_len"] = len(kept)
        self.metadata["hist_levels"] = out.levels
        self.metadata["goss"] = (list(out.goss) if out.goss is not None
                                 else None)
        self.metadata["efb_width"] = (list(out.efb_width)
                                      if out.efb_width is not None else None)
        self.metadata["csr"] = csr is not None
        return model


#: the ensemble mode of each boosting objective
_GBT_MODES = {"binary": "gbdt_binary", "multiclass": "gbdt_multi",
              "regression": "gbdt_reg"}


def gbt_base_score(objective: str, W: np.ndarray, y: np.ndarray):
    """Starting margins: the log-odds of the weighted positive share
    (clipped to [1e-6, 1 - 1e-6]) for the binary objective, the weighted
    mean label for regression.  ``W`` (N,) is one fit's weights and gives
    a float32 scalar in the JAX package's sequential-fit arithmetic; (S,
    N) chains' weights give (S,) float32 in its grid group's arithmetic
    (float32 sums and quotient), so either path starts where the JAX one
    does, bit for bit.  (The softmax objective starts from zeros.)"""
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
    """Per-row gradients and hessians (N, K) of one chain's margins ``F``
    (N, K) and row weights ``W`` (N,): binary logistic (w (p - y), w max(p
    (1 - p), 1e-6)), softmax over the K classes of the one-hot targets
    ``y`` (N, K) (P = softmax(F): w (P - Y), w max(P (1 - P), 1e-6)) or
    squared error (w (F - y), w)."""
    if objective == "multiclass":
        P = torch.softmax(F, dim=1)
        return (W[:, None] * (P - y),
                W[:, None] * torch.clamp(P * (1 - P), min=1e-6))
    if objective == "binary":
        P = torch.sigmoid(F[:, 0])
        return ((W * (P - y))[:, None],
                (W * torch.clamp(P * (1 - P), min=1e-6))[:, None])
    return (W * (F[:, 0] - y))[:, None], W[:, None]


def gbt_es_metric(objective: str, F_val: torch.Tensor, y_val: torch.Tensor
                  ) -> torch.Tensor:
    """The early-stopping metric of one chain's validation margins (V, K),
    larger better: AuPR of the sigmoid in the JAX package's float32
    arithmetic (``aupr_es``), the accuracy of the argmax class (softmax),
    or minus the unweighted mean squared error."""
    if objective == "binary":
        return aupr_es(y_val, F_val[:, 0])
    if objective == "multiclass":
        return (F_val.argmax(dim=1) == y_val.long()).to(
            torch.float32).mean()
    return -torch.mean((F_val[:, 0] - y_val) ** 2)


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
    """XGBoost-parameterised boosted classifier: binary, or softmax over K
    classes when ``num_class`` > 2 or (``num_class`` 0) a label exceeds 1.

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

    def _fit_objective(self, y: np.ndarray) -> str:
        """Softmax when ``num_class`` > 2, or when it is 0 and a label
        exceeds 1; else the binary objective."""
        if self.num_class > 2 or (self.num_class == 0 and len(y)
                                  and float(np.max(y)) > 1):
            return "multiclass"
        return self._objective


class OpXGBoostRegressor(OpXGBoostClassifier):
    """XGBoost-parameterised boosted regressor (squared error)."""

    _op_name = "xgbReg"
    _objective = "regression"

    def _fit_objective(self, y: np.ndarray) -> str:
        return "regression"


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


# ---------------------------------------------------------------------------
# The sweep memo
# ---------------------------------------------------------------------------

#: most entries the memo holds; the oldest goes first (the JAX package's
#: capacity).  0 turns the memo off.
_BIN_CACHE_CAPACITY = 32
_MEMO: "OrderedDict" = OrderedDict()
#: id of a matrix tensor -> (weak reference to it, its entries' keys)
_MEMO_OWNERS: Dict[int, Tuple[weakref.ref, set]] = {}
_MEMO_LOCK = threading.RLock()
#: key -> threading.Event of a build in flight
_MEMO_INFLIGHT: Dict[tuple, threading.Event] = {}
#: bumped by ``clear_sweep_caches``: a build that began before a clear is
#: not inserted after it
_MEMO_GEN = [0]
#: binnings built and binned matrices served from the memo (running
#: counts; read differences)
MEMO_STATS = {"binnings": 0, "binning_hits": 0}


def _tensor_key(t: torch.Tensor) -> tuple:
    """What identifies a tensor's content without reading it: its object,
    its version counter (an in-place write bumps it), its storage address,
    shape, strides, dtype and device."""
    return (id(t), t._version, t.data_ptr(), tuple(t.shape), t.stride(),
            str(t.dtype), str(t.device))


def _drop_owner(oid: int, ref: weakref.ref, memo=_MEMO,
                owners=_MEMO_OWNERS, lock=_MEMO_LOCK) -> None:
    """A memoized matrix was freed: drop its entries.  (The tables are
    bound at definition: a tensor freed at interpreter exit finds them
    even after the module's globals are gone.)"""
    with lock:
        owner = owners.get(oid)
        if owner is not None and owner[0] is ref:
            for k in owner[1]:
                memo.pop(k, None)
            del owners[oid]


def _tensors_in(val) -> list:
    """The tensors a memo value holds (itself, or those of a tuple)."""
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (tuple, list)):
        return [t for v in val for t in _tensors_in(v)]
    return []


def _ready_event(owner: torch.Tensor, val):
    """A value built on a side CUDA stream (the tree-prep prefetch
    thread's) is handed over with an event recorded after its build, and
    its tensors are marked as used on the device's default stream, where
    the sweep consumes them; None for anything else."""
    if owner.device.type != "cuda":
        return None
    side = torch.cuda.current_stream(owner.device)
    main = torch.cuda.default_stream(owner.device)
    if side == main:
        return None
    for t in _tensors_in(val):
        if t.is_cuda:
            t.record_stream(main)
    ev = torch.cuda.Event()
    ev.record(side)
    return ev


def _handed(owner: torch.Tensor, entry):
    """A memo entry's value, the current stream first made to wait for
    its build where one was recorded."""
    val, ev = entry
    if ev is not None:
        torch.cuda.current_stream(owner.device).wait_event(ev)
    return val


def _memo_probe(key, owner: torch.Tensor):
    """The entry of ``key`` if it is ``owner``'s (call under the lock)."""
    if key in _MEMO:
        ref = _MEMO_OWNERS.get(id(owner))
        if ref is not None and ref[0]() is owner:
            _MEMO.move_to_end(key)
            return _MEMO[key]
    return None


def memo_get(owner: torch.Tensor, tag: str, extra: tuple,
             build: Callable[[], object]):
    """The memoized value of ``build()`` for the tensor ``owner`` under
    ``tag`` and ``extra`` (hashable parameters of the build), built on a
    miss.  Entries go oldest first past ``_BIN_CACHE_CAPACITY`` and with
    their owner tensor.

    Concurrent builders of one key build once (the selector's tree-prep
    prefetch thread and the sweep's tree group may reach one prep
    together): the first owns the build, a later one waits on the
    owner's event and probes again; where the owner failed (or a clear
    raced it), the waiter builds itself.  ``clear_sweep_caches`` bumps a
    generation, and a build that began before a clear is not inserted."""
    key = (tag, _tensor_key(owner)) + tuple(extra)
    oid = id(owner)
    with _MEMO_LOCK:
        hit = _memo_probe(key, owner)
        if hit is not None:
            return _handed(owner, hit)
        flight = _MEMO_INFLIGHT.get(key)
        owns = flight is None
        if owns:
            flight = threading.Event()
            _MEMO_INFLIGHT[key] = flight
        gen = _MEMO_GEN[0]
    if not owns:
        flight.wait()
        with _MEMO_LOCK:
            hit = _memo_probe(key, owner)
        if hit is not None:
            return _handed(owner, hit)
    try:
        val = build()
        if _BIN_CACHE_CAPACITY > 0:
            entry = (val, _ready_event(owner, val))
            with _MEMO_LOCK:
                # inserted before the waiters wake (they probe again)
                if _MEMO_GEN[0] == gen:
                    while len(_MEMO) >= _BIN_CACHE_CAPACITY:
                        old, _ = _MEMO.popitem(last=False)
                        held = _MEMO_OWNERS.get(old[1][0])
                        if held is not None:
                            held[1].discard(old)
                    held = _MEMO_OWNERS.get(oid)
                    if held is None or held[0]() is not owner:
                        ref = weakref.ref(
                            owner, lambda r, oid=oid: _drop_owner(oid, r))
                        held = (ref, set())
                        _MEMO_OWNERS[oid] = held
                    held[1].add(key)
                    _MEMO[key] = entry
    finally:
        if owns:
            with _MEMO_LOCK:
                _MEMO_INFLIGHT.pop(key, None)
            flight.set()
    return val


def clear_sweep_caches() -> None:
    """Release every memoized sketch, binned matrix, bundling plan and CSR
    (``OpWorkflow.train`` calls it at its end, as the JAX package's
    does); a build in flight is not inserted after it."""
    with _MEMO_LOCK:
        _MEMO_GEN[0] += 1
        _MEMO.clear()
        _MEMO_OWNERS.clear()


def _edges_key(edges) -> tuple:
    e = np.ascontiguousarray(np.asarray(edges, np.float32))
    return (e.shape, hashlib.blake2b(e.tobytes(), digest_size=16).digest())


def binned_for_edges(X: torch.Tensor, edges) -> torch.Tensor:
    """``apply_bins(X, edges)`` through the memo: a fit's binning and the
    scoring of the same matrix with the fit's edges share one entry."""
    def build():
        MEMO_STATS["binnings"] += 1
        return apply_bins(X, edges)

    before = MEMO_STATS["binnings"]
    out = memo_get(X, "binned", _edges_key(edges), build)
    if MEMO_STATS["binnings"] == before:
        MEMO_STATS["binning_hits"] += 1
    return out


def _sketch_rows(X: torch.Tensor, row_weight) -> int:
    """The rows a sketch reads: up to the last one of positive
    ``row_weight`` (all, without weights or with none positive)."""
    if row_weight is not None:
        nz = np.flatnonzero(np.asarray(row_weight) > 0)
        if len(nz):
            return int(nz[-1]) + 1
    return X.shape[0]


def prep_tree_inputs(X: torch.Tensor, max_bins: int, row_weight=None):
    """Bin edges and the binned matrix of a tree fit: the quantile sketch
    (``sketch_kind``'s choice) over the rows up to the last one of
    positive ``row_weight`` (a trailing block of zero-weight rows never
    moves the edges; interior ones stay in the sketch, as in the JAX
    package's weighted sketch), binning over every row; both memoized."""
    k = _sketch_rows(X, row_weight)
    Xm = X if k == X.shape[0] else X[:k]
    kind = sketch_kind(Xm)
    SKETCH_KINDS[kind] += 1
    edges = memo_get(X, "edges", (k, kind, int(max_bins)), lambda: (
        quantile_bins_sparse_aware(Xm, max_bins) if kind == "sparse_aware"
        else quantile_bins(Xm, max_bins)))
    return edges, binned_for_edges(X, edges)


def dense_tree_inputs(X: torch.Tensor, max_bins: int):
    """Edges of the dense sketch (``quantile_bins``, what the decision
    trees bin with, whatever the sparse rule says) and the binned matrix,
    through the memo: a dense matrix's entry is ``prep_tree_inputs``'."""
    edges = memo_get(X, "edges", (X.shape[0], "dense", int(max_bins)),
                     lambda: quantile_bins(X, max_bins))
    return edges, binned_for_edges(X, edges)


def prep_tree_csr(X: torch.Tensor, edges, binned: torch.Tensor,
                  row_weight=None) -> Optional[FeatureCSR]:
    """The CSR of a boosted fit's matrix, memoized, or None: the JAX
    package builds one only under ``TMOG_SPARSE_HIST=1``, for a matrix the
    sparse rule sends to the nonzero-aware sketch (``sketch_kind``), whose
    sketch reads every row, and that ``build_feature_csr`` accepts."""
    if os.environ.get("TMOG_SPARSE_HIST", "0") != "1":
        return None
    if (_sketch_rows(X, row_weight) != X.shape[0]
            or sketch_kind(X) != "sparse_aware"):
        return None
    return memo_get(X, "csr", _edges_key(edges),
                    lambda: build_feature_csr(X, edges, binned))


def efb_enabled() -> bool:
    """``TMOG_EFB``: '0' turns exclusive feature bundling off, '1' bundles
    past the width-ratio gate, 'auto' (the default) bundles where the plan
    shrinks the width to ``EFB_MIN_WIDTH_RATIO`` or less."""
    return os.environ.get("TMOG_EFB", "auto") != "0"


class EFBInputs(NamedTuple):
    """A bundled fit's inputs: the plan, the bundled matrix, the member
    end table (B, D_b) int32 and the plan's split map (``col_feat``,
    ``col_thresh``), all on the matrix's device."""
    bundles: FeatureBundles
    binned: torch.Tensor
    end_bin: torch.Tensor
    tables: Tuple[torch.Tensor, torch.Tensor]


def maybe_bundle(binned: torch.Tensor, edges, max_bins: int
                 ) -> Optional[EFBInputs]:
    """The bundling plan of a binned matrix and its bundled copy
    (memoized on the binned matrix, the edges and ``TMOG_EFB``), or None
    where the plan declines."""
    force = os.environ.get("TMOG_EFB", "auto") == "1"

    def build():
        b = bundle_features(binned, edges, max_bins,
                            min_width_ratio=(1.0 if force
                                             else EFB_MIN_WIDTH_RATIO))
        if b is None:
            return None
        dev = binned.device
        return EFBInputs(b, bundle_matrix(b, binned),
                         upload_timed(b.end_bin, dev),
                         (upload_timed(b.col_feat, dev),
                          upload_timed(b.col_thresh, dev)))

    return memo_get(binned, "efb", _edges_key(edges) + (int(max_bins),
                                                        force), build)


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


class OpDecisionTreeClassifier(OpRandomForestClassifier):
    """One unbagged tree (OpDecisionTreeClassifier parity): every feature,
    the row weights as bag weights, leaves of class shares (mode
    ``rf_cls``, one tree)."""

    _op_name = "decisionTreeCls"

    def __init__(self, max_depth: int = 5, max_bins: int = 32,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 seed: int = 42, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(num_trees=1, max_depth=max_depth, max_bins=max_bins,
                         min_instances_per_node=min_instances_per_node,
                         min_info_gain=min_info_gain, subsample_rate=1.0,
                         feature_subset_strategy="all", seed=seed,
                         device=device, uid=uid)
        # a single tree: no bootstrap
        self.subsample_rate = 0.0

    def fit_raw(self, X, y, w=None, device=None) -> TreeEnsembleModel:
        """Fit on a (N, D) matrix and labels (classes 0..K-1, K = the
        largest label + 1 and at least 2; or real values), on ``device``
        (else the stage's, else the default device).  The JAX package's
        decision tree on the general grower: the dense sketch's bins, G =
        Y w (the one-hot classes, or the label), H = w in every column, the
        count C = w, gain regulariser ``RF_LAMBDA``, mean leaves G / C."""
        dev = resolve_device(device if device is not None else self.device)
        X = torch.as_tensor(X, dtype=torch.float32).to(dev)
        y = np.asarray(y, np.float32)
        cls = self._classification
        edges, binned = dense_tree_inputs(X, self.max_bins)
        w = (torch.ones(X.shape[0], dtype=torch.float32, device=dev)
             if w is None else torch.as_tensor(np.asarray(w, np.float32)
                                               ).to(dev))
        yt = torch.from_numpy(y).to(dev)
        k = max(int(y.max()) + 1, 2) if cls else 1
        Y = (torch.nn.functional.one_hot(yt.long(), k).to(torch.float32)
             if cls else yt[:, None])
        tree = grow_tree(binned, Y * w[:, None], w[:, None].repeat(1, k),
                         self.max_depth, self.max_bins, C=w,
                         lam=gbdt_kernels.RF_LAMBDA,
                         min_info_gain=float(self.min_info_gain),
                         min_instances=float(self.min_instances_per_node),
                         newton_leaf=False)
        self.metadata["hist_levels"] = int(self.max_depth)
        return TreeEnsembleModel(
            mode="rf_cls" if cls else "rf_reg", edges=edges,
            feat=tree.feat[None], thresh=tree.thresh[None],
            leaf=tree.leaf[None], n_classes=k if cls else 2)


class OpDecisionTreeRegressor(OpDecisionTreeClassifier):
    """One unbagged regression tree: leaves of the weighted mean label
    (mode ``rf_reg``, one tree)."""

    _op_name = "decisionTreeReg"
    _classification = False
