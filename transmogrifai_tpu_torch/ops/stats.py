"""Statistics for SanityChecker (counterpart of ``transmogrifai_tpu.ops.stats``).

Column statistics and Pearson correlation with the label are reductions
over the device-resident (N, D) matrix, taken in float64 over row blocks
(two passes: means, then centered moments) so that a float32 matrix of any
width costs at most one block of float64 scratch.  Cramér's V of a
categorical group is a one-hot contingency product on the device, reduced
to chi² on the host.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

__all__ = ["ColStats", "col_stats_with_label", "cramers_v",
           "contingency_stats"]

#: rows per float64 block of the two-pass reductions
STATS_ROW_BLOCK = 1 << 16


class ColStats(NamedTuple):
    """Host float64 per-column statistics and label correlation."""
    mean: np.ndarray
    variance: np.ndarray
    min: np.ndarray
    max: np.ndarray
    corr: np.ndarray


def col_stats_with_label(X: torch.Tensor, y: torch.Tensor) -> ColStats:
    """Mean, variance (ddof=1), min, max and Pearson corr(x_j, y) per column.

    ``X`` (N, D) float32 and ``y`` (N,) on one device.  Columns with no
    variance get correlation 0 (the JAX package's ``nan_to_num``)."""
    n, d = X.shape
    dev = X.device
    f64 = torch.float64
    s = torch.zeros(d, dtype=f64, device=dev)
    mn = torch.full((d,), float("inf"), dtype=torch.float32, device=dev)
    mx = torch.full((d,), float("-inf"), dtype=torch.float32, device=dev)
    for a in range(0, n, STATS_ROW_BLOCK):
        blk = X[a:a + STATS_ROW_BLOCK]
        s += blk.sum(dim=0, dtype=f64)
        mn = torch.minimum(mn, blk.amin(dim=0))
        mx = torch.maximum(mx, blk.amax(dim=0))
    mean = s / n
    yc = y.to(f64) - y.to(f64).mean()
    ss = torch.zeros(d, dtype=f64, device=dev)
    num = torch.zeros(d, dtype=f64, device=dev)
    for a in range(0, n, STATS_ROW_BLOCK):
        xc = X[a:a + STATS_ROW_BLOCK].to(f64) - mean
        ss += (xc * xc).sum(dim=0)
        num += yc[a:a + STATS_ROW_BLOCK] @ xc
    var = ss / max(n - 1, 1)
    den = (torch.sqrt(torch.clamp(var, min=1e-30) * (n - 1))
           * torch.sqrt(torch.clamp(yc @ yc, min=1e-30)))
    corr = torch.nan_to_num(num / den)
    packed = torch.stack([mean, var, mn.to(f64), mx.to(f64), corr]).cpu()
    return ColStats(*packed.numpy())


def contingency_stats(table: np.ndarray) -> Dict[str, float]:
    """chi² and Cramér's V from a contingency table."""
    t = np.asarray(table, np.float64)
    n = t.sum()
    if n <= 0 or t.shape[0] < 2 or t.shape[1] < 2:
        return {"chi2": 0.0, "cramersV": 0.0, "n": float(n)}
    expected = t.sum(axis=1, keepdims=True) @ t.sum(axis=0, keepdims=True) / n
    with np.errstate(divide="ignore", invalid="ignore"):
        chi2 = np.nansum(np.where(expected > 0,
                                  (t - expected) ** 2 / expected, 0.0))
    k = min(t.shape)
    cramers = float(np.sqrt(chi2 / n / max(k - 1, 1)))
    return {"chi2": float(chi2), "cramersV": min(cramers, 1.0),
            "n": float(n)}


def cramers_v(labels: torch.Tensor, group_indicators: torch.Tensor,
              n_label_classes: int) -> Dict[str, float]:
    """Cramér's V of one categorical group given its (N, C) one-hot block
    and integer labels in [0, n_label_classes): the table is
    ``onehot(labels).T @ indicators``."""
    L = torch.nn.functional.one_hot(labels, n_label_classes).to(torch.float64)
    tbl = L.T @ group_indicators.to(torch.float64)
    return contingency_stats(tbl.cpu().numpy())
