"""Binary and regression metrics on device tensors (counterpart of
``transmogrifai_tpu.evaluators.metrics``): the areas under the
precision-recall and ROC curves from one sort of the scores, evaluated at
distinct-score boundaries (average-precision style, as sklearn and Spark
compute them), the metrics at a threshold, Brier score and log loss; the
weighted regression set (RMSE, MSE, MAE, R2).

Sums run in float64 over cumulative sums rather than scatter-adds, so the
results are deterministic on the card; with unit weights every partial sum
is an exact integer.  ``binary_metric_grid`` and
``regression_metric_grid`` score a whole (fold, candidate) sweep against
per-fold evaluation weights.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["MINIMIZE_METRICS", "aupr", "aupr_device", "auroc",
           "auroc_device", "binary_metric_grid", "binary_metrics_at_threshold",
           "brier_score", "log_loss", "binary_classification_metrics",
           "REGRESSION_METRICS", "regression_metric_device",
           "regression_metric_grid", "regression_metrics"]

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
