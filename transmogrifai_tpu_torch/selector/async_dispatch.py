"""Async sweep dispatch helpers (counterpart of
``transmogrifai_tpu.selector.async_dispatch``): device-resident scoring
and promotion.

* :func:`sync_sweep_forced` — ``TMOG_SYNC_SWEEP=1``, read at sweep time,
  restores the synchronous sweep loop (``SweepWorkQueue._run_all_inner``)
  and the halving scheduler's host promotion.
* :func:`device_rung_scores` / :func:`device_promote` — a halving rung's
  elimination as torch reductions on the metric tensors' device: a
  finite-fold mean in float32 (as the JAX package computes it) and a
  stable descending sort, of which only the ``survivors_out`` int32
  indices come back to the host.

Ties: the stable sort keeps the lower index first among equal scores,
which is the host promotion's ``sorted(alive, key=lambda i: (sign *
score[i], i))`` order (``torch.topk`` promises no order among equals).
The float32 means may rank two candidates closer than float32's epsilon
otherwise than the host's float64 means; the winner is always chosen
from the host-precision results.
"""
from __future__ import annotations

import os
from typing import Any, List, Optional

import torch

__all__ = ["sync_sweep_forced", "device_rung_scores", "device_promote"]


def sync_sweep_forced() -> bool:
    """True when ``TMOG_SYNC_SWEEP=1``: run the synchronous sweep loop
    (metrics fetched unit by unit, halving promotion on the host)."""
    return os.environ.get("TMOG_SYNC_SWEEP", "") == "1"


def _finite_mean_rows(M: torch.Tensor) -> torch.Tensor:
    """(C, F) -> (C,) float32 means over each row's finite entries (NaN
    where a row has none): the device twin of ``collect``'s mean."""
    m = M.to(torch.float32)
    fin = torch.isfinite(m)
    s = torch.where(fin, m, torch.zeros_like(m)).sum(dim=1)
    c = fin.sum(dim=1)
    return torch.where(c > 0, s / c.clamp(min=1),
                       torch.full_like(s, float("nan")))


def device_rung_scores(all_vals: List[Any], errors: List[Optional[str]],
                       larger_better: bool) -> torch.Tensor:
    """A rung's per-candidate scores as one (C,) tensor on the metrics'
    device.  ``all_vals``/``errors`` are a deferred sweep's raw results
    (``SweepWorkQueue.run_all(..., defer=True)``): a ``_GroupRow`` into a
    metric matrix, a list of metric scalars (tensors or floats), or host
    floats of restored or skipped units.  A group matrix reduces once;
    nothing is fetched.  An errored unit scores the metric direction's
    worst value."""
    from .validators import _GroupRow

    dev = torch.device("cpu")
    for vals in all_vals:
        if isinstance(vals, _GroupRow):
            dev = vals.matrix.device
            break
        found = next((v for v in vals if isinstance(v, torch.Tensor)), None)
        if found is not None:
            dev = found.device
            break
    worst = float("-inf") if larger_better else float("inf")
    row_means: dict = {}
    cols = []
    for vals, err in zip(all_vals, errors):
        if isinstance(vals, _GroupRow):
            mid = id(vals.matrix)
            if mid not in row_means:
                row_means[mid] = _finite_mean_rows(vals.matrix)
            cols.append(row_means[mid][vals.row])
        elif err is not None or not len(vals):
            cols.append(torch.tensor(worst, dtype=torch.float32, device=dev))
        else:
            v = torch.stack([
                x.to(device=dev, dtype=torch.float32)
                if isinstance(x, torch.Tensor)
                else torch.tensor(float(x), dtype=torch.float32, device=dev)
                for x in vals])
            cols.append(_finite_mean_rows(v[None, :])[0])
    return torch.stack(cols)


def device_promote(scores: torch.Tensor, survivors_out: int,
                   larger_better: bool) -> List[int]:
    """The positions of the top ``survivors_out`` of a (C,) score tensor,
    ascending; ties go to the lower position and NaN scores rank worst.
    The rung's only host copy is those ``survivors_out`` int32s, booked
    as a drain under ``halving.promote`` (the next rung's candidates
    depend on it: nothing can overlap it)."""
    from ..utils.profiling import fetch_timed

    v = scores if larger_better else -scores
    v = torch.where(torch.isnan(v), torch.full_like(v, float("-inf")), v)
    order = torch.sort(v, descending=True, stable=True).indices
    top = fetch_timed(order[:int(survivors_out)].to(torch.int32),
                      tag="halving.promote")
    return sorted(int(i) for i in top.tolist())
