"""Bounded streaming histogram (counterpart of
``transmogrifai_tpu.utils.streaming_histogram``, its vectorized numpy
path).

A batch is absorbed whole: its distinct finite values join the bins as
unit bins (counts = multiplicities), and passes merge the smallest-gap
*disjoint* adjacent pairs until the bin budget holds.  A pass takes the
pairs the JAX package's greedy loop takes: visit the gaps in ascending
(gap, index) order and take a pair when neither of its bins is used yet,
up to ``budget = max(1, min(excess, bins // 2))`` pairs.  Two facts make
that selection parallel and exact:

1. With a budget of b, the greedy takes exactly the b smallest-key pairs
   of the set it takes with no budget (a pair's fate depends only on
   pairs of smaller key).
2. With no budget, on a path with distinct keys: a local minimum of the
   keys is taken; a pair on a monotone run is taken iff its distance
   from the run's minimum is even; a local maximum is taken iff neither
   neighbour is taken.

The merge arithmetic is the JAX package's, op for op, in float64
(``(c_l n_l + c_r n_r) / (n_l + n_r)`` as separate multiplies, an add
and a divide), and the pass ends with the same stable re-sort of the kept
bins followed by the merged ones, so centroids and counts come out bit
for bit.  ``StreamingHistogram`` keeps one histogram's bins as host
numpy arrays; ``batched_histograms`` builds the histograms of many
columns at once from a padded (d, n) float64 tensor on any device (the
RawFeatureFilter's numeric profile on the card).  The JAX package's
native C++ backend bins differently (a per-point insert) and is not
used.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["StreamingHistogram", "greedy_pairs", "batched_histograms"]


def greedy_pairs(gaps: np.ndarray, budget: int) -> np.ndarray:
    """Bool mask of the pairs (edge i joins bins i and i + 1) the greedy
    loop over ascending (gap, index) takes with ``budget``."""
    m = gaps.size
    idx = np.arange(m)
    # key(i - 1) < key(i) iff gap(i - 1) <= gap(i): the lower index wins
    up = np.zeros(m, bool)
    up[1:] = gaps[:-1] <= gaps[1:]
    down = np.zeros(m, bool)
    down[:-1] = gaps[1:] < gaps[:-1]
    start = np.maximum.accumulate(np.where(up, 0, idx))
    end = np.minimum.accumulate(np.where(down, m - 1, idx)[::-1])[::-1]
    slope = ((~up & ~down) | (up & ~down & ((idx - start) % 2 == 0))
             | (~up & down & ((end - idx) % 2 == 0)))
    left = np.zeros(m, bool)
    left[1:] = slope[:-1]
    right = np.zeros(m, bool)
    right[:-1] = slope[1:]
    free = slope | (up & down & ~left & ~right)
    order = np.argsort(gaps, kind="stable")
    in_order = free[order]
    take = np.zeros(m, bool)
    take[order[in_order & (np.cumsum(in_order) <= budget)]] = True
    return take


class StreamingHistogram:
    def __init__(self, max_bins: int = 100):
        if max_bins < 2:
            raise ValueError("max_bins must be >= 2")
        self.max_bins = max_bins
        self.centroids = np.zeros(0, np.float64)
        self.counts = np.zeros(0, np.float64)

    # -- updates ------------------------------------------------------------

    def update(self, values) -> "StreamingHistogram":
        """Absorb a batch of finite values (NaN/inf ignored)."""
        v = np.asarray(values, np.float64).ravel()
        v = v[np.isfinite(v)]
        if v.size == 0:
            return self
        uniq, cnt = np.unique(v, return_counts=True)
        self.centroids = np.concatenate([self.centroids, uniq])
        self.counts = np.concatenate([self.counts, cnt.astype(np.float64)])
        order = np.argsort(self.centroids, kind="stable")
        self.centroids = self.centroids[order]
        self.counts = self.counts[order]
        self._shrink()
        return self

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """Monoid combine (the distribution-reduce path)."""
        out = StreamingHistogram(max(self.max_bins, other.max_bins))
        cs = np.concatenate([self.centroids, other.centroids])
        ns = np.concatenate([self.counts, other.counts])
        order = np.argsort(cs, kind="stable")
        out.centroids, out.counts = cs[order], ns[order]
        out._shrink()
        return out

    def _shrink(self) -> None:
        while self.centroids.size > self.max_bins:
            c, n = self.centroids, self.counts
            budget = max(1, min(c.size - self.max_bins, c.size // 2))
            take = greedy_pairs(np.diff(c), budget)
            left = np.where(take)[0]
            tot = n[left] + n[left + 1]
            merged_c = (c[left] * n[left] + c[left + 1] * n[left + 1]) / tot
            used = np.zeros(c.size, bool)
            used[left] = used[left + 1] = True
            keep = ~used
            new_c = np.concatenate([c[keep], merged_c])
            new_n = np.concatenate([n[keep], tot])
            order = np.argsort(new_c, kind="stable")
            self.centroids, self.counts = new_c[order], new_n[order]

    # -- queries ------------------------------------------------------------

    @property
    def total(self) -> float:
        return float(self.counts.sum())

    def density(self, grid: np.ndarray) -> np.ndarray:
        """Probability mass of each cell of a sorted grid (each centroid's
        count falls into the cell containing it)."""
        if self.total == 0:
            return np.zeros(len(grid), np.float64)
        idx = np.clip(np.searchsorted(grid, self.centroids, side="right") - 1,
                      0, len(grid) - 1)
        out = np.zeros(len(grid), np.float64)
        np.add.at(out, idx, self.counts)
        return out / out.sum()

    def quantile(self, q: float) -> float:
        if self.total == 0:
            return float("nan")
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, q * cum[-1]))
        return float(self.centroids[min(i, self.centroids.size - 1)])

    @property
    def bounds(self) -> Tuple[float, float]:
        if self.centroids.size == 0:
            return (float("nan"), float("nan"))
        return float(self.centroids[0]), float(self.centroids[-1])

    def to_json(self) -> dict:
        return {"maxBins": self.max_bins,
                "centroids": self.centroids.tolist(),
                "counts": self.counts.tolist()}

    @staticmethod
    def from_json(d: dict) -> "StreamingHistogram":
        h = StreamingHistogram(d["maxBins"])
        h.centroids = np.asarray(d["centroids"], np.float64)
        h.counts = np.asarray(d["counts"], np.float64)
        return h

    @classmethod
    def from_value_counts(cls, values, counts,
                          max_bins: int = 32) -> "StreamingHistogram":
        """Build from exact (value, count) pairs: the bins are the values
        themselves, shrunk to the budget."""
        h = cls(max_bins)
        v = np.asarray(values, np.float64)
        c = np.asarray(counts, np.float64)
        finite = np.isfinite(v)
        v, c = v[finite], c[finite]
        order = np.argsort(v, kind="stable")
        h.centroids, h.counts = v[order], c[order]
        h._shrink()
        return h

    @classmethod
    def from_bins(cls, centroids: np.ndarray, counts: np.ndarray,
                  max_bins: int) -> "StreamingHistogram":
        """A histogram holding already-shrunk bins (a row of
        ``batched_histograms``)."""
        h = cls(max_bins)
        h.centroids = np.asarray(centroids, np.float64)
        h.counts = np.asarray(counts, np.float64)
        return h


# ---------------------------------------------------------------------------
# many columns at once, on any device
# ---------------------------------------------------------------------------

_INF = float("inf")


def _batched_pass(C: torch.Tensor, N: torch.Tensor, L: torch.Tensor,
                  max_bins: int):
    """One shrink pass over rows that all hold more than ``max_bins`` bins:
    (C, N, L) padded centroids (+inf), counts (0) and lengths."""
    d, w = C.shape
    m = w - 1
    dev = C.device
    idx = torch.arange(m, device=dev).expand(d, m)
    edge = idx < (L - 1)[:, None]
    gaps = torch.where(edge, C[:, 1:] - C[:, :-1], _INF)
    up = torch.zeros_like(edge)
    up[:, 1:] = (gaps[:, :-1] <= gaps[:, 1:]) & edge[:, 1:]
    down = torch.zeros_like(edge)
    down[:, :-1] = (gaps[:, 1:] < gaps[:, :-1]) & edge[:, 1:]
    start = torch.cummax(torch.where(up, 0, idx), dim=1).values
    end = torch.cummin(torch.where(down, m - 1, idx).flip(1),
                       dim=1).values.flip(1)
    even_up = (idx - start) % 2 == 0
    even_down = (end - idx) % 2 == 0
    slope = ((~up & ~down) | (up & ~down & even_up)
             | (~up & down & even_down))
    nb = torch.zeros_like(edge)
    nb[:, 1:] = slope[:, :-1]
    nb[:, :-1] |= slope[:, 1:]
    free = (slope | (up & down & ~nb)) & edge
    budget = torch.clamp(torch.minimum(L - max_bins, L // 2), min=1)
    order = torch.sort(gaps, dim=1, stable=True).indices
    in_order = torch.gather(free, 1, order)
    sel = in_order & (torch.cumsum(in_order, dim=1) <= budget[:, None])
    take = torch.zeros_like(edge).scatter_(1, order, sel)
    used = torch.zeros((d, w), dtype=torch.bool, device=dev)
    used[:, :-1] = take
    used[:, 1:] |= take
    keep = (torch.arange(w, device=dev)[None, :] < L[:, None]) & ~used
    # the JAX package's arithmetic, one rounding per op
    tot = N[:, :-1] + N[:, 1:]
    a = C[:, :-1] * N[:, :-1]
    b = C[:, 1:] * N[:, 1:]
    merged = (a + b) / tot
    cat_c = torch.cat([torch.where(keep, C, _INF),
                       torch.where(take, merged, _INF)], dim=1)
    cat_n = torch.cat([torch.where(keep, N, 0.0),
                       torch.where(take, tot, 0.0)], dim=1)
    C2, perm = torch.sort(cat_c, dim=1, stable=True)
    N2 = torch.gather(cat_n, 1, perm)
    L2 = L - take.sum(dim=1)
    w2 = int(L2.max())
    return C2[:, :w2], N2[:, :w2], L2


def _shrink_batched(C: torch.Tensor, N: torch.Tensor, L: torch.Tensor,
                    max_bins: int):
    while True:
        act = torch.nonzero(L > max_bins).flatten()
        if act.numel() == 0:
            break
        c, n, l2 = _batched_pass(C.index_select(0, act),
                                 N.index_select(0, act),
                                 L.index_select(0, act), max_bins)
        C[act] = _INF
        N[act] = 0.0
        C[act, :c.shape[1]] = c
        N[act, :n.shape[1]] = n
        L = L.index_put((act,), l2)
        w = int(L.max())
        C, N = C[:, :w].contiguous(), N[:, :w].contiguous()
    return C, N, L


def batched_histograms(X: torch.Tensor, valid: Optional[torch.Tensor] = None,
                       max_bins: int = 100):
    """The histograms ``StreamingHistogram(max_bins).update(X[j])`` builds,
    for every row j of ``X`` (d, n) at once, on ``X``'s device.

    ``valid`` (d, n) bool masks values out (non-finite ones always are).
    Returns (centroids (d, w) float64, counts (d, w) float64, lengths
    (d,) int64) with w = max(lengths) <= max_bins; row j's bins are its
    first lengths[j] entries (padding: +inf centroids, zero counts)."""
    if max_bins < 2:
        raise ValueError("max_bins must be >= 2")
    X = X.to(torch.float64)
    ok = torch.isfinite(X)
    if valid is not None:
        ok &= valid
    d, n = X.shape
    dev = X.device
    xs = torch.sort(torch.where(ok, X, _INF), dim=1).values
    cnt = ok.sum(dim=1)
    pos = torch.arange(n, device=dev)[None, :] < cnt[:, None]
    new = pos.clone()
    new[:, 1:] &= xs[:, 1:] != xs[:, :-1]
    gid = torch.cumsum(new, dim=1) - 1
    L = new.sum(dim=1)
    w = max(int(L.max()) if d else 0, 1)
    gid = torch.where(pos, gid, 0)
    # each distinct value to its slot; the other positions write a spare
    # last column, cut off after
    C = torch.full((d, w + 1), _INF, dtype=torch.float64, device=dev)
    C.scatter_(1, torch.where(new, gid, w), xs)
    C = C[:, :w].contiguous()
    N = torch.zeros((d, w), dtype=torch.float64, device=dev)
    N.scatter_add_(1, gid, pos.to(torch.float64))
    return _shrink_batched(C, N, L, max_bins)
