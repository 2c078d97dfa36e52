"""Binary metrics on device tensors (counterpart of
``transmogrifai_tpu.evaluators.metrics``): area under the precision-recall
curve from one descending sort of the scores, evaluated at distinct-score
boundaries (average-precision style, as sklearn and Spark compute it).

Sums run in float64 over cumulative sums rather than scatter-adds, so the
result is deterministic on the card; with unit weights every partial sum
is an exact integer.  Only AuPR is ported so far.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["aupr", "aupr_device"]


def aupr_device(y_true: torch.Tensor, y_score: torch.Tensor,
                sample_weight: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """AuPR as a 0-d float64 tensor on the inputs' device (no host sync)."""
    f64 = torch.float64
    y = y_true.to(f64)
    w = torch.ones_like(y) if sample_weight is None else sample_weight.to(f64)
    s = y_score.to(torch.float32)
    n = s.shape[0]
    if n == 0:
        return torch.zeros((), dtype=f64, device=s.device)
    order = torch.sort(-s, stable=True).indices
    s_sorted = s[order]
    cy = torch.cumsum((w * y)[order], 0)
    cw = torch.cumsum(w[order], 0)
    # Evaluate at the last position of each distinct-score group, masked in
    # place (a boolean index would read its size back to the host).  cy
    # never decreases, so a running max of the group-end values gives each
    # position the true positives of the groups before it.
    is_last = torch.ones(n, dtype=torch.bool, device=s.device)
    is_last[:-1] = s_sorted[1:] != s_sorted[:-1]
    ends = torch.where(is_last, cy, 0.0)
    before = torch.cummax(ends, 0).values.roll(1)
    before[0] = 0.0
    pos_g = torch.where(is_last, cy - before, 0.0)
    pos = torch.clamp(cy[-1], min=1e-12)
    precision = cy / torch.clamp(cw, min=1e-12)
    return torch.clamp(torch.sum(pos_g / pos * precision), 0.0, 1.0)


def aupr(y_true: torch.Tensor, y_score: torch.Tensor,
         sample_weight: Optional[torch.Tensor] = None) -> float:
    """AuPR as a Python float."""
    return float(aupr_device(y_true, y_score, sample_weight))
