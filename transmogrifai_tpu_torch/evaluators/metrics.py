"""Binary and regression metrics on device tensors (counterpart of
``transmogrifai_tpu.evaluators.metrics``): the areas under the
precision-recall and ROC curves from one sort of the scores, evaluated at
distinct-score boundaries (average-precision style, as sklearn and Spark
compute them), the metrics at a threshold, Brier score and log loss; the
weighted regression set (RMSE, MSE, MAE, R2); the weighted multiclass set
(F1, Error, Accuracy, Precision, Recall: support-weighted averages over a
confusion matrix) and the top-N / confidence-threshold counts.

Sums run in float64 over cumulative sums rather than scatter-adds, so the
results are deterministic on the card; with unit weights every partial sum
is an exact integer.  ``binary_metric_grid`` and
``regression_metric_grid`` score a whole (fold, candidate) sweep against
per-fold evaluation weights, ``multiclass_metric_grid`` a sweep's
predicted labels.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["MINIMIZE_METRICS", "aupr", "aupr_device", "aupr_es", "auroc",
           "auroc_device", "binary_metric_grid", "binary_metrics_at_threshold",
           "brier_score", "log_loss", "binary_classification_metrics",
           "REGRESSION_METRICS", "regression_metric_device",
           "regression_metric_grid", "regression_metrics",
           "MULTICLASS_METRICS", "multiclass_metric_device",
           "multiclass_metric_grid", "multiclass_metrics",
           "multiclass_threshold_metrics", "threshold_curves"]

#: metrics where smaller is better (the selector's direction of selection)
MINIMIZE_METRICS = ("RootMeanSquaredError", "MeanSquaredError",
                    "MeanAbsoluteError", "Error", "LogLoss", "BrierScore")

#: the regression metric set, by the JAX package's names
REGRESSION_METRICS = ("RootMeanSquaredError", "MeanSquaredError",
                      "MeanAbsoluteError", "R2")


def _prep(y_true, y_score, sample_weight):
    """float64 labels and weights and float32 scores on the scores'
    device."""
    s = torch.as_tensor(y_score)
    dev = s.device
    y = torch.as_tensor(y_true).to(dev, torch.float64)
    w = (torch.ones_like(y) if sample_weight is None
         else torch.as_tensor(sample_weight).to(dev, torch.float64))
    return y, w, s.to(torch.float32)


def _group_ends(s_sorted: torch.Tensor, *cums: torch.Tensor):
    """For scores sorted so that ties are adjacent, and running sums over
    that order: a mask of each tie group's last position and, per running
    sum, its value at the end of the previous group (at every position).
    Masks in place: a boolean index would read its size back to the host
    and stall it.  Running sums never decrease, so a running max of the
    group-end values gives each position the total of the groups before
    it."""
    n = s_sorted.shape[0]
    is_last = torch.ones(n, dtype=torch.bool, device=s_sorted.device)
    is_last[:-1] = s_sorted[1:] != s_sorted[:-1]
    befores = []
    for c in cums:
        before = torch.cummax(torch.where(is_last, c, 0.0), 0).values.roll(1)
        before[0] = 0.0
        befores.append(before)
    return is_last, befores


def aupr_device(y_true: torch.Tensor, y_score: torch.Tensor,
                sample_weight: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """AuPR as a 0-d float64 tensor on the inputs' device (no host sync)."""
    y, w, s = _prep(y_true, y_score, sample_weight)
    if s.shape[0] == 0:
        return torch.zeros((), dtype=torch.float64, device=s.device)
    order = torch.sort(-s, stable=True).indices
    cy = torch.cumsum((w * y)[order], 0)
    cw = torch.cumsum(w[order], 0)
    is_last, (before,) = _group_ends(s[order], cy)
    pos_g = torch.where(is_last, cy - before, 0.0)
    pos = torch.clamp(cy[-1], min=1e-12)
    precision = cy / torch.clamp(cw, min=1e-12)
    return torch.clamp(torch.sum(pos_g / pos * precision), 0.0, 1.0)


def aupr_es(y_true: torch.Tensor, margin: torch.Tensor) -> torch.Tensor:
    """The unweighted AuPR of ``sigmoid(margin)`` that boosted early
    stopping compares, as a 0-d float32 tensor: the JAX package's
    ``_aupr_dev`` arithmetic (float32 sums of each score tie group in
    group order, float32 running sums, a float32 total), so that the
    patience rule's 1e-9 comparisons land as they do there.  Equal margins
    get one probability: a vectorized sigmoid computes some elements on
    another code path, which splits a tie of margins by an ulp (both
    torch's and XLA's CPU kernels do), and a split tie moves the AuPR."""
    m = margin.to(torch.float32)
    n = m.shape[0]
    dev = m.device
    if n == 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    order = torch.sort(-m, stable=True).indices
    ms = m[order]
    pos_idx = torch.arange(n, device=dev)
    new_m = torch.ones(n, dtype=torch.bool, device=dev)
    new_m[1:] = ms[1:] != ms[:-1]
    first = torch.cummax(torch.where(new_m, pos_idx, 0), 0).values
    s = torch.sigmoid(ms)[first]
    is_new = torch.ones(n, dtype=torch.bool, device=dev)
    is_new[1:] = s[1:] != s[:-1]
    gid = torch.cumsum(is_new.to(torch.int64), 0) - 1
    wy = torch.as_tensor(y_true).to(dev, torch.float32)[order]
    # integer-valued float32 sums: exact in any order of addition
    pos_g = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
        0, gid, wy)
    tot_g = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
        0, gid, torch.ones_like(wy))
    tp = torch.cumsum(pos_g, 0)
    all_pred = torch.cumsum(tot_g, 0)
    pos = torch.clamp(wy.sum(), min=1e-12)
    precision = tp / torch.clamp(all_pred, min=1e-12)
    return torch.clamp(torch.sum(pos_g / pos * precision), 0.0, 1.0)


def aupr(y_true: torch.Tensor, y_score: torch.Tensor,
         sample_weight: Optional[torch.Tensor] = None) -> float:
    """AuPR as a Python float."""
    return float(aupr_device(y_true, y_score, sample_weight))


def auroc_device(y_true: torch.Tensor, y_score: torch.Tensor,
                 sample_weight: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Weighted AUC = P(s+ > s-) + 0.5 P(s+ = s-) over score tie groups,
    as a 0-d float64 tensor on the inputs' device."""
    y, w, s = _prep(y_true, y_score, sample_weight)
    if s.shape[0] == 0:
        return torch.zeros((), dtype=torch.float64, device=s.device)
    order = torch.sort(s, stable=True).indices
    cp = torch.cumsum((w * y)[order], 0)
    cn = torch.cumsum((w * (1 - y))[order], 0)
    is_last, (p_before, n_before) = _group_ends(s[order], cp, cn)
    pos_g = torch.where(is_last, cp - p_before, 0.0)
    neg_g = torch.where(is_last, cn - n_before, 0.0)
    num = torch.sum(pos_g * (n_before + 0.5 * neg_g))
    denom = torch.clamp(cp[-1] * cn[-1], min=1e-12)
    return torch.clamp(num / denom, 0.0, 1.0)


def auroc(y_true, y_score, sample_weight=None) -> float:
    return float(auroc_device(y_true, y_score, sample_weight))


_GRID_METRICS = {"AuPR": aupr_device, "AuROC": auroc_device}


def binary_metric_grid(y_true: torch.Tensor, scores: torch.Tensor,
                       weights: torch.Tensor, metric: str
                       ) -> Optional[torch.Tensor]:
    """A validation sweep's metrics: ``scores`` (F, C, N) per (fold,
    candidate), ``weights`` (F, N) per-fold evaluation weights, one label
    vector -> (F, C) float64 device values, or None when ``metric`` has no
    device form (callers then score candidates one by one)."""
    fn = _GRID_METRICS.get(metric)
    if fn is None:
        return None
    return torch.stack([torch.stack([fn(y_true, s, weights[f])
                                     for s in scores[f]])
                        for f in range(scores.shape[0])])


def binary_metrics_at_threshold(y_true, y_score, threshold: float = 0.5,
                                sample_weight=None) -> Dict[str, float]:
    y, w, s = _prep(y_true, y_score, sample_weight)
    pred = (s.to(torch.float64) >= threshold).to(torch.float64)
    tp = float(torch.sum(w * pred * y))
    fp = float(torch.sum(w * pred * (1 - y)))
    fn = float(torch.sum(w * (1 - pred) * y))
    tn = float(torch.sum(w * (1 - pred) * (1 - y)))
    precision = tp / max(tp + fp, 1e-12)
    recall = tp / max(tp + fn, 1e-12)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    error = (fp + fn) / max(tp + fp + fn + tn, 1e-12)
    return {"Precision": precision, "Recall": recall, "F1": f1,
            "Error": error, "TP": tp, "TN": tn, "FP": fp, "FN": fn}


def brier_score(y_true, y_prob, sample_weight=None) -> float:
    y, w, p = _prep(y_true, y_prob, sample_weight)
    return float(torch.sum(w * (p.to(torch.float64) - y) ** 2)
                 / max(float(torch.sum(w)), 1e-12))


def log_loss(y_true, y_prob, sample_weight=None, eps: float = 1e-15
             ) -> float:
    y, w, p = _prep(y_true, y_prob, sample_weight)
    p = torch.clamp(p.to(torch.float64), eps, 1 - eps)
    ll = -(y * torch.log(p) + (1 - y) * torch.log1p(-p))
    return float(torch.sum(w * ll) / max(float(torch.sum(w)), 1e-12))


def binary_classification_metrics(y_true, y_prob, sample_weight=None,
                                  threshold: float = 0.5) -> Dict[str, float]:
    """The full binary metric set (OpBinaryClassificationEvaluator's)."""
    out = {"AuROC": auroc(y_true, y_prob, sample_weight),
           "AuPR": aupr(y_true, y_prob, sample_weight),
           "BrierScore": brier_score(y_true, y_prob, sample_weight),
           "LogLoss": log_loss(y_true, y_prob, sample_weight)}
    out.update(binary_metrics_at_threshold(y_true, y_prob, threshold,
                                           sample_weight))
    return out


def threshold_curves(y_true, y_prob, n_thresholds: int = 100,
                     sample_weight=None) -> Dict[str, np.ndarray]:
    """Precision, recall and F1 at each of ``n_thresholds`` evenly spaced
    thresholds in [0, 1] (``binary_metrics_at_threshold`` at each, as one
    (N, T) comparison on the scores' device)."""
    ts = np.linspace(0.0, 1.0, n_thresholds)
    y, w, s = _prep(y_true, y_prob, sample_weight)
    thr = torch.as_tensor(ts, dtype=torch.float64, device=s.device)
    pred = (s.to(torch.float64)[:, None] >= thr[None, :]).to(torch.float64)
    tp = (w * y) @ pred
    fp = (w * (1 - y)) @ pred
    fn = (w * y).sum() - tp
    precision = tp / torch.clamp(tp + fp, min=1e-12)
    recall = tp / torch.clamp(tp + fn, min=1e-12)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    curves = torch.stack([precision, recall, f1]).cpu().numpy()
    return {"thresholds": ts, "precisionByThreshold": curves[0],
            "recallByThreshold": curves[1], "f1ByThreshold": curves[2]}


# ---------------------------------------------------------------------------
# Regression
# ---------------------------------------------------------------------------

def regression_metric_device(y_true, y_pred, sample_weight,
                             metric: str) -> torch.Tensor:
    """One weighted regression metric as a 0-d float64 tensor on the
    predictions' device: the sums run in float64, the total weight floored
    at 1e-12 and R2's label variance at 1e-12, as in the JAX package's
    kernel."""
    if metric not in REGRESSION_METRICS:
        raise ValueError(f"unknown regression metric {metric!r}")
    y, w, _ = _prep(y_true, y_pred, sample_weight)
    ws = torch.clamp(w.sum(), min=1e-12)
    err = torch.as_tensor(y_pred).to(y.device, torch.float64) - y
    if metric == "MeanAbsoluteError":
        return (w * err.abs()).sum() / ws
    mse = (w * err * err).sum() / ws
    if metric == "MeanSquaredError":
        return mse
    if metric == "RootMeanSquaredError":
        return torch.sqrt(mse)
    mean = (w * y).sum() / ws
    var = (w * (y - mean) ** 2).sum() / ws
    return 1.0 - mse / torch.clamp(var, min=1e-12)


def regression_metric_grid(y_true: torch.Tensor, preds: torch.Tensor,
                           weights: torch.Tensor, metric: str
                           ) -> Optional[torch.Tensor]:
    """A regression sweep's metrics: ``preds`` (F, C, N) per (fold,
    candidate), ``weights`` (F, N) -> (F, C) float64 device values, or
    None for a metric outside the regression set."""
    if metric not in REGRESSION_METRICS:
        return None
    return torch.stack([torch.stack([
        regression_metric_device(y_true, p, weights[f], metric)
        for p in preds[f]]) for f in range(preds.shape[0])])


def regression_metrics(y_true, y_pred, sample_weight=None
                       ) -> Dict[str, float]:
    """The full regression metric set (OpRegressionEvaluator's)."""
    return {m: float(regression_metric_device(y_true, y_pred, sample_weight,
                                              m))
            for m in REGRESSION_METRICS}


# ---------------------------------------------------------------------------
# Multiclass
# ---------------------------------------------------------------------------

#: the multiclass metrics a sweep scores on the device
MULTICLASS_METRICS = ("F1", "Error", "Accuracy", "Precision", "Recall")


def _confusion(y: torch.Tensor, p: torch.Tensor, w: torch.Tensor,
               n_classes: int) -> torch.Tensor:
    """(K, K) float64 weighted confusion matrix (rows: labels, columns:
    predictions) as one one-hot product: a fixed summation order on the
    card, unlike a scatter."""
    yo = torch.nn.functional.one_hot(y, n_classes).to(torch.float64)
    po = torch.nn.functional.one_hot(p, n_classes).to(torch.float64)
    return (yo * w[:, None]).T @ po


def _multiclass_set(conf: torch.Tensor, wsum: torch.Tensor):
    """(Precision, Recall, F1) support-weighted over the classes of a
    confusion matrix whose rows hold ``wsum`` in all."""
    tp = torch.diagonal(conf)
    support = conf.sum(1)
    prec_k = tp / torch.clamp(conf.sum(0), min=1e-12)
    rec_k = tp / torch.clamp(support, min=1e-12)
    f1_k = 2 * prec_k * rec_k / torch.clamp(prec_k + rec_k, min=1e-12)
    wts = support / wsum
    return (wts * prec_k).sum(), (wts * rec_k).sum(), (wts * f1_k).sum()


def _multiclass_prep(y_true, y_pred, sample_weight, n_classes: int):
    """int64 labels and predictions on the predictions' device, and the
    float64 weights with rows whose label or prediction lies outside [0,
    K) zeroed (both are then clamped into range)."""
    pt = torch.as_tensor(y_pred)
    dev = pt.device
    y = torch.as_tensor(y_true).to(dev).long()
    p = pt.long()
    w = (torch.ones(y.shape[0], dtype=torch.float64, device=dev)
         if sample_weight is None
         else torch.as_tensor(sample_weight).to(dev, torch.float64))
    ok = (y >= 0) & (y < n_classes) & (p >= 0) & (p < n_classes)
    return torch.where(ok, y, 0), torch.where(ok, p, 0), w * ok


def multiclass_metric_device(y_true, y_pred, sample_weight, n_classes: int,
                             metric: str) -> torch.Tensor:
    """One weighted multiclass metric of predicted labels as a 0-d float64
    tensor on the predictions' device.  Rows whose label or prediction
    lies outside [0, K) weigh nothing (the JAX package's grid kernel)."""
    if metric not in MULTICLASS_METRICS:
        raise ValueError(f"unknown multiclass metric {metric!r}")
    y, p, w = _multiclass_prep(y_true, y_pred, sample_weight, n_classes)
    wsum = torch.clamp(w.sum(), min=1e-12)
    if metric in ("Accuracy", "Error"):
        acc = (w * (y == p)).sum() / wsum
        return acc if metric == "Accuracy" else 1.0 - acc
    prec, rec, f1 = _multiclass_set(_confusion(y, p, w, n_classes), wsum)
    return {"Precision": prec, "Recall": rec, "F1": f1}[metric]


def multiclass_metric_grid(y_true: torch.Tensor, preds: torch.Tensor,
                           weights: torch.Tensor, n_classes: int,
                           metric: str) -> Optional[torch.Tensor]:
    """A multiclass sweep's metrics: ``preds`` (F, C, N) predicted labels
    per (fold, candidate), ``weights`` (F, N) per-fold evaluation weights,
    one label vector -> (F, C) float64 device values, or None when
    ``metric`` has no device form."""
    if metric not in MULTICLASS_METRICS:
        return None
    return torch.stack([torch.stack([
        multiclass_metric_device(y_true, p, weights[f], n_classes, metric)
        for p in preds[f]]) for f in range(preds.shape[0])])


def multiclass_metrics(y_true, y_pred, n_classes: int,
                       sample_weight=None) -> Dict[str, object]:
    """The full multiclass set (Accuracy, Error, Precision, Recall, F1)
    and the (K, K) ``confusion`` matrix (a float64 numpy array) of
    predicted labels; rows whose label or prediction lies outside [0, K)
    are dropped, as the JAX package's host path drops them."""
    y, p, w = _multiclass_prep(y_true, y_pred, sample_weight, n_classes)
    wsum = torch.clamp(w.sum(), min=1e-12)
    acc = float((w * (y == p)).sum() / wsum)
    conf = _confusion(y, p, w, n_classes)
    prec, rec, f1 = _multiclass_set(conf, wsum)
    return {"Accuracy": acc, "Error": 1.0 - acc, "Precision": float(prec),
            "Recall": float(rec), "F1": float(f1),
            "confusion": conf.cpu().numpy()}


def multiclass_threshold_metrics(y_true, proba, top_ns=(1, 3),
                                 thresholds=None) -> Dict:
    """Top-N / confidence-threshold counts of multiclass probabilities
    (OpMultiClassificationEvaluator's threshold metrics, the JAX
    package's host arithmetic in float64): for every N and threshold, the
    rows whose true class ranks in the top N (stable descending order: a
    tie goes to the earlier class) with a score at or above the threshold
    (``correct``), the rows whose top score clears the threshold but whose
    true class misses the top N or the threshold (``incorrect``), and the
    rest (``noPrediction``).  A label outside [0, K) scores 0."""
    thr = (np.arange(0, 101) / 100.0 if thresholds is None
           else np.asarray(thresholds, np.float64))
    if thr.size == 0 or not np.all((thr >= 0) & (thr <= 1)):
        raise ValueError("thresholds must be a non-empty sequence in [0, 1]")
    tns = list(dict.fromkeys(int(t) for t in top_ns))
    if not tns or any(t <= 0 for t in tns):
        raise ValueError("top_ns must be a non-empty sequence of positive "
                         "integers")
    P = torch.as_tensor(proba).to(torch.float64)
    dev = P.device
    y = torch.as_tensor(y_true).to(dev).long()
    n, k = P.shape
    lbl = torch.clamp(y, 0, k - 1)
    seen = (y >= 0) & (y < k)
    rows = torch.arange(n, device=dev)
    true_score = torch.where(seen, P[rows, lbl], 0.0)
    top_score = P.max(dim=1).values
    gt = (P > true_score[:, None]).sum(1)
    eq_before = ((P == true_score[:, None])
                 & (torch.arange(k, device=dev)[None, :]
                    < lbl[:, None])).sum(1)
    rank = torch.where(seen, gt + eq_before, k)
    thr_t = torch.as_tensor(thr, dtype=torch.float64, device=dev)
    true_ge = true_score[:, None] >= thr_t[None, :]
    top_ge = top_score[:, None] >= thr_t[None, :]
    out = {"topNs": tns, "thresholds": [float(t) for t in thr],
           "correctCounts": {}, "incorrectCounts": {},
           "noPredictionCounts": {}}
    for t in tns:
        in_top = (rank < t)[:, None]
        correct = (in_top & true_ge).sum(0).cpu().tolist()
        incorrect = ((in_top & top_ge & ~true_ge)
                     | (~in_top & top_ge)).sum(0).cpu().tolist()
        out["correctCounts"][t] = [int(c) for c in correct]
        out["incorrectCounts"][t] = [int(c) for c in incorrect]
        out["noPredictionCounts"][t] = [int(n - c - i) for c, i
                                        in zip(correct, incorrect)]
    return out
