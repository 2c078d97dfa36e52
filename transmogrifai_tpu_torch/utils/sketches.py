"""Mergeable streaming sketches behind the streaming fits (counterpart of
``transmogrifai_tpu.utils.sketches``, host numpy, the same arithmetic op
for op: states, merges and ``to_state``/``from_state`` equal the JAX
package's bit for bit).

* ``WelfordMoments``: per-column (count, mean, M2, min, max) with Chan's
  parallel merge; chunked means differ from numpy's one-shot pairwise
  mean by about 1e-12 relative (another summation order).
* ``PearsonSketch``: adds the label co-moment, for streaming Pearson
  correlations.
* ``TopKSketch``: mergeable value counting with first-seen order; with
  ``capacity=None`` (the vectorizers') counting is exact and ``top_k()``
  gives ``Counter.most_common``'s order, ties by first occurrence; a
  bounded ``capacity`` evicts by space-saving (overestimates bounded by
  the smallest retained count).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["WelfordMoments", "PearsonSketch", "TopKSketch"]


def _chan_merge(n_a: float, mean_a, m2_a, n_b: float, mean_b, m2_b):
    """Merge two (count, mean, M2) moment states (Chan et al. 1979)."""
    n = n_a + n_b
    if n == 0:
        return 0.0, mean_a, m2_a
    delta = mean_b - mean_a
    mean = mean_a + delta * (n_b / n)
    m2 = m2_a + m2_b + delta * delta * (n_a * n_b / n)
    return n, mean, m2


class WelfordMoments:
    """Streaming per-column moments over row chunks.

    Shape-agnostic: the first ``update`` fixes the column shape — a 1-D
    chunk gives scalar stats, an (n, d) chunk gives d-vector stats.  All
    accumulation is float64.
    """

    def __init__(self):
        self.n: float = 0.0
        self.mean = None
        self.m2 = None
        self.min = None
        self.max = None

    def update(self, values) -> "WelfordMoments":
        x = np.asarray(values, dtype=np.float64)
        if x.shape[0] == 0:
            return self
        n_b = float(x.shape[0])
        mean_b = x.mean(axis=0)
        m2_b = ((x - mean_b) ** 2).sum(axis=0)
        return self._merge_stats(n_b, mean_b, m2_b, x.min(axis=0),
                                 x.max(axis=0))

    def _merge_stats(self, n_b, mean_b, m2_b, min_b, max_b
                     ) -> "WelfordMoments":
        """Fold precomputed chunk stats in (the sketches that already hold
        centered chunk data use this to avoid a second pass)."""
        if self.mean is None:
            self.n, self.mean, self.m2 = n_b, mean_b, m2_b
            self.min, self.max = min_b, max_b
        else:
            self.n, self.mean, self.m2 = _chan_merge(
                self.n, self.mean, self.m2, n_b, mean_b, m2_b)
            self.min = np.minimum(self.min, min_b)
            self.max = np.maximum(self.max, max_b)
        return self

    def merge(self, other: "WelfordMoments") -> "WelfordMoments":
        if other.mean is None:
            return self
        if self.mean is None:
            self.n, self.mean, self.m2 = other.n, other.mean, other.m2
            self.min, self.max = other.min, other.max
            return self
        self.n, self.mean, self.m2 = _chan_merge(
            self.n, self.mean, self.m2, other.n, other.mean, other.m2)
        self.min = np.minimum(self.min, other.min)
        self.max = np.maximum(self.max, other.max)
        return self

    def variance(self, ddof: int = 1):
        denom = self.n - ddof
        if self.mean is None or denom <= 0:
            return (np.zeros_like(self.mean)
                    if self.mean is not None else 0.0)
        return self.m2 / denom

    # -- checkpoint codec hooks (workflow/checkpoint.py) --------------------

    def to_state(self) -> dict:
        """Loss-free snapshot for checkpointing: every field is a float,
        ndarray or None, so the persistence array-externalization encoding
        round-trips it bit-exactly (resume parity depends on this)."""
        return {"n": self.n, "mean": self.mean, "m2": self.m2,
                "min": self.min, "max": self.max}

    @classmethod
    def from_state(cls, state: dict) -> "WelfordMoments":
        out = cls()
        out.n = state["n"]
        out.mean = state["mean"]
        out.m2 = state["m2"]
        out.min = state["min"]
        out.max = state["max"]
        return out


class PearsonSketch:
    """Streaming column-vs-label Pearson: x-moments, y-moments, co-moment."""

    def __init__(self):
        self.x = WelfordMoments()
        self.y = WelfordMoments()
        self.c = None  # Σ (x - mean_x)(y - mean_y), shape (d,)

    def update(self, X, y) -> "PearsonSketch":
        # one float64 working copy, centered IN PLACE, then BLAS products —
        # the chunk cost is ~3 passes over the block instead of the naive
        # ~8 temporaries (this runs per chunk on the train hot path)
        if np.asarray(X).shape[0] == 0:
            return self
        min_b = np.asarray(X).min(axis=0).astype(np.float64)
        max_b = np.asarray(X).max(axis=0).astype(np.float64)
        Xd = np.array(X, dtype=np.float64)   # owned copy (centered below)
        yd = np.asarray(y, dtype=np.float64)
        n_b = float(Xd.shape[0])
        mean_xb = Xd.mean(axis=0)
        mean_yb = yd.mean()
        Xd -= mean_xb
        yc = yd - mean_yb
        m2_b = np.einsum("ij,ij->j", Xd, Xd)
        c_b = yc @ Xd
        m2y_b = float(yc @ yc)
        if self.c is None:
            self.c = c_b
        else:
            n_a = self.x.n
            delta_x = mean_xb - self.x.mean
            delta_y = mean_yb - self.y.mean
            self.c = (self.c + c_b
                      + delta_x * delta_y * (n_a * n_b / (n_a + n_b)))
        self.x._merge_stats(n_b, mean_xb, m2_b, min_b, max_b)
        self.y._merge_stats(n_b, mean_yb, m2y_b, float(yd.min()),
                            float(yd.max()))
        return self

    def merge(self, other: "PearsonSketch") -> "PearsonSketch":
        if other.c is None:
            return self
        if self.c is None:
            self.c = other.c
            self.x.merge(other.x)
            self.y.merge(other.y)
            return self
        n_a, n_b = self.x.n, other.x.n
        delta_x = other.x.mean - self.x.mean
        delta_y = other.y.mean - self.y.mean
        self.c = (self.c + other.c
                  + delta_x * delta_y * (n_a * n_b / (n_a + n_b)))
        self.x.merge(other.x)
        self.y.merge(other.y)
        return self

    def to_state(self) -> dict:
        """Checkpoint snapshot (see WelfordMoments.to_state)."""
        return {"x": self.x.to_state(), "y": self.y.to_state(),
                "c": self.c}

    @classmethod
    def from_state(cls, state: dict) -> "PearsonSketch":
        out = cls()
        out.x = WelfordMoments.from_state(state["x"])
        out.y = WelfordMoments.from_state(state["y"])
        out.c = state["c"]
        return out

    def correlation(self) -> np.ndarray:
        """Pearson r per column, mirroring the SanityChecker host path's
        guards: eps-clamped denominators, NaN -> 0."""
        if self.c is None:
            return np.zeros(0, np.float64)
        n = self.x.n
        var_x = self.x.variance(ddof=1)
        den = (np.sqrt(np.maximum(var_x, 1e-30) * max(n - 1, 1))
               * np.sqrt(max(float(self.y.m2), 1e-30)))
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.nan_to_num(self.c / den)


class TopKSketch:
    """Mergeable top-k value counting with Counter-compatible ordering.

    State per key: (count, first_seen) where ``first_seen`` is a global
    monotone position (chunk offset + within-chunk first index), so
    ``top_k()``'s tie-break — smaller first_seen wins — reproduces
    ``Counter.most_common`` (insertion order) exactly when counting is
    exact.  ``add_chunk`` consumes one chunk's values vectorized via
    ``np.unique``; ``offset`` advances by the number of items added.

    ``capacity=None`` (default): exact counting — what the vectorizers use.
    Bounded ``capacity``: space-saving eviction — the smallest-count entry
    is replaced and the newcomer inherits its count as an overestimate
    (``error`` records the worst-case overcount, count-min style).
    """

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity
        self.counts: Dict[object, List[float]] = {}  # key -> [count, first]
        self.offset: int = 0
        self.error: float = 0.0

    def add_chunk(self, values: Sequence) -> "TopKSketch":
        arr = np.asarray(values, dtype=object)
        if arr.size:
            uniq, first_idx, cnt = np.unique(
                arr, return_index=True, return_counts=True)
            self._absorb(uniq, cnt.astype(np.float64),
                         first_idx + self.offset)
        self.offset += int(arr.size)
        return self

    def _absorb(self, keys, counts, first_seen) -> None:
        for k, c, fs in zip(keys, counts, first_seen):
            ent = self.counts.get(k)
            if ent is not None:
                ent[0] += c
                if fs < ent[1]:
                    ent[1] = fs
            elif self.capacity is None or len(self.counts) < self.capacity:
                self.counts[k] = [float(c), float(fs)]
            else:  # space-saving eviction
                victim = min(self.counts, key=lambda v: self.counts[v][0])
                base = self.counts.pop(victim)[0]
                self.error = max(self.error, base)
                self.counts[k] = [base + float(c), float(fs)]

    def merge(self, other: "TopKSketch") -> "TopKSketch":
        # the right operand's first_seen positions shift past this sketch's
        # item span, preserving global first-occurrence order
        keys = list(other.counts)
        counts = [other.counts[k][0] for k in keys]
        firsts = [other.counts[k][1] + self.offset for k in keys]
        self._absorb(np.asarray(keys, object), counts, firsts)
        self.offset += other.offset
        self.error = max(self.error, other.error)
        return self

    def to_state(self) -> dict:
        """Checkpoint snapshot.  Keys and [count, first_seen] pairs are
        kept in dict insertion order: the bounded-capacity eviction picks
        ``min`` over iteration order on ties, so order preservation keeps
        resumed runs byte-identical to uninterrupted ones."""
        return {"capacity": self.capacity, "offset": self.offset,
                "error": self.error,
                "keys": list(self.counts.keys()),
                "entries": [list(v) for v in self.counts.values()]}

    @classmethod
    def from_state(cls, state: dict) -> "TopKSketch":
        out = cls(capacity=state["capacity"])
        out.offset = int(state["offset"])
        out.error = float(state["error"])
        out.counts = {k: [float(c), float(f)]
                      for k, (c, f) in zip(state["keys"], state["entries"])}
        return out

    def top_k(self, k: int, min_support: float = 0.0) -> List:
        """The ``Counter.most_common(k)`` analogue: top k keys by count
        (ties by first occurrence), then min-support filtered — matching
        the vectorizers' ``most_common`` + filter idiom."""
        ordered = sorted(self.counts.items(),
                         key=lambda kv: (-kv[1][0], kv[1][1]))
        return [key for key, (c, _) in ordered[:k] if c >= min_support]
