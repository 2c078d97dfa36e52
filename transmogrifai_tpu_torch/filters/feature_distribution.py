"""Per-raw-feature distribution profiles for RawFeatureFilter (counterpart
of ``transmogrifai_tpu.filters.feature_distribution``).

A profile holds a feature's (or a map key's) count, nulls, the numeric
streaming histogram or the hashed text counts, the value moments and the
null x label co-counts, and adds as a monoid.  ``profile_column`` profiles
one column on the host; ``profile_numeric_batch`` profiles many numeric
columns in one pass of batched tensor ops on any device (the same bins:
``utils/streaming_histogram.py``).  Text hashes each distinct string once
and scatters its count, which gives the JAX package's per-row counts.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..types.columns import FeatureColumn
from ..utils.hashing import murmur3_32_many
from ..utils.streaming_histogram import StreamingHistogram, batched_histograms

__all__ = ["FeatureDistribution", "profile_column", "profile_numeric_batch",
           "merge_distributions", "NUMERIC_STORAGE", "TEXT_BINS",
           "NUMERIC_BINS", "JS_GRID"]

TEXT_BINS = 255          # hashed token buckets for text (reference default)
NUMERIC_BINS = 100
#: cells of the train-vs-score density comparison
JS_GRID = 20
#: storages profiled as numbers (geolocation by its first coordinate)
NUMERIC_STORAGE = ("real", "integral", "binary", "date", "geolocation")
#: columns a batched numeric pass stacks at once
PROFILE_COLS_PER_PASS = 64


@dataclasses.dataclass
class FeatureDistribution:
    name: str
    key: Optional[str] = None          # map key (None for scalar features)
    count: int = 0
    nulls: int = 0
    hist: Optional[StreamingHistogram] = None     # numeric profile
    text_counts: Optional[np.ndarray] = None      # hashed text profile
    moments_n: float = 0.0
    moments_sum: float = 0.0
    moments_sum2: float = 0.0
    #: null x label co-counts: corr(null, label) is a function of (count,
    #: nulls, sum l, sum l^2, sum null*l), so it merges like fill rates
    lab_sum: float = 0.0
    lab_sum2: float = 0.0
    null_lab_sum: float = 0.0
    has_label: bool = False

    @property
    def full_name(self) -> str:
        return f"{self.name}[{self.key}]" if self.key is not None else self.name

    def fill_rate(self) -> float:
        return (self.count - self.nulls) / self.count if self.count else 0.0

    def relative_fill_rate(self, other: "FeatureDistribution") -> float:
        return abs(self.fill_rate() - other.fill_rate())

    def relative_fill_ratio(self, other: "FeatureDistribution") -> float:
        a, b = self.fill_rate(), other.fill_rate()
        lo, hi = min(a, b), max(a, b)
        return float("inf") if lo == 0 else hi / lo

    def __add__(self, other: "FeatureDistribution") -> "FeatureDistribution":
        assert (self.name, self.key) == (other.name, other.key)
        if ((self.hist is not None and other.text_counts is not None)
                or (self.text_counts is not None and other.hist is not None)):
            # a key numeric in one part and textual in another: a
            # fill-rate-only profile (its JS divergence reads 0)
            hist, tc = None, None
        else:
            hist = (self.hist.merge(other.hist)
                    if self.hist is not None and other.hist is not None
                    else self.hist or other.hist)
            tc = None
            if self.text_counts is not None or other.text_counts is not None:
                a = self.text_counts if self.text_counts is not None else 0
                b = other.text_counts if other.text_counts is not None else 0
                tc = a + b
        return FeatureDistribution(
            self.name, self.key, self.count + other.count,
            self.nulls + other.nulls, hist, tc,
            self.moments_n + other.moments_n,
            self.moments_sum + other.moments_sum,
            self.moments_sum2 + other.moments_sum2,
            self.lab_sum + other.lab_sum,
            self.lab_sum2 + other.lab_sum2,
            self.null_lab_sum + other.null_lab_sum,
            self.has_label or other.has_label)

    def null_label_corr(self) -> float:
        """Pearson correlation between the per-row null indicator and the
        label, from the co-counts."""
        n = self.count
        if n == 0 or not self.has_label:
            return 0.0
        p = self.nulls / n
        var_null = p * (1.0 - p)
        mean_l = self.lab_sum / n
        var_l = self.lab_sum2 / n - mean_l * mean_l
        if var_null <= 0.0 or var_l <= 0.0:
            return 0.0
        cov = self.null_lab_sum / n - p * mean_l
        return float(cov / np.sqrt(var_null * var_l))

    def _note_label(self, null_mask: np.ndarray, label: np.ndarray) -> None:
        lab = np.nan_to_num(np.asarray(label, np.float64))
        self.lab_sum += float(lab.sum())
        self.lab_sum2 += float((lab ** 2).sum())
        self.null_lab_sum += float(lab[np.asarray(null_mask, bool)].sum())
        self.has_label = True

    def js_divergence(self, other: "FeatureDistribution") -> float:
        """Jensen-Shannon divergence of two profiles of one feature, in
        [0, 1] (log base 2)."""
        p, q = self._density_pair(other)
        if p is None:
            return 0.0
        m = 0.5 * (p + q)

        def kl(a, b):
            mask = a > 0
            return float(np.sum(a[mask] * np.log2(a[mask] / b[mask])))

        return 0.5 * kl(p, m) + 0.5 * kl(q, m)

    def _density_pair(self, other):
        if self.hist is not None and other.hist is not None:
            lo1, hi1 = self.hist.bounds
            lo2, hi2 = other.hist.bounds
            if np.isnan(lo1) or np.isnan(lo2):
                return None, None
            lo, hi = min(lo1, lo2), max(hi1, hi2)
            if lo == hi:
                return None, None
            grid = np.linspace(lo, hi, JS_GRID)
            return self.hist.density(grid), other.hist.density(grid)
        if self.text_counts is not None and other.text_counts is not None:
            ts, to = self.text_counts.sum(), other.text_counts.sum()
            if ts == 0 or to == 0:
                return None, None
            return self.text_counts / ts, other.text_counts / to
        return None, None

    def to_json(self) -> dict:
        return {
            "name": self.name, "key": self.key, "count": self.count,
            "nulls": self.nulls, "fillRate": self.fill_rate(),
            "moments": {"n": self.moments_n, "sum": self.moments_sum,
                        "sum2": self.moments_sum2},
            "histogram": self.hist.to_json() if self.hist else None,
            "textCounts": (self.text_counts.tolist()
                           if self.text_counts is not None else None),
        }


def _profile_numeric(name, key, vals: np.ndarray, mask: np.ndarray,
                     label: Optional[np.ndarray] = None):
    d = FeatureDistribution(name, key, count=len(vals),
                            nulls=int((~mask).sum()))
    finite = vals[mask & np.isfinite(vals)]
    d.hist = StreamingHistogram(NUMERIC_BINS).update(finite)
    d.moments_n = float(finite.size)
    d.moments_sum = float(finite.sum())
    d.moments_sum2 = float((finite ** 2).sum())
    if label is not None:
        d._note_label(~np.asarray(mask, bool), label)
    return d


def _profile_text(name, key, values,
                  label: Optional[np.ndarray] = None) -> FeatureDistribution:
    """Hashed counts: each distinct value (a str, or None for a null) is
    counted in one pass, hashed once, and its count goes to its bucket."""
    values = values.tolist() if isinstance(values, np.ndarray) else values
    d = FeatureDistribution(name, key, count=len(values))
    distinct = collections.Counter(values)
    d.nulls = distinct.pop(None, 0)
    counts = np.zeros(TEXT_BINS, np.float64)
    np.add.at(counts, murmur3_32_many([str(v) for v in distinct])
              % TEXT_BINS, np.fromiter(distinct.values(), np.float64,
                                       len(distinct)))
    d.text_counts = counts
    if label is not None:
        d._note_label(np.fromiter((v is None for v in values), bool,
                                  len(values)), label)
    return d


def _numeric_view(col: FeatureColumn):
    vals = np.asarray(col.values, np.float64)
    if col.ftype.storage == "geolocation":
        vals = vals[:, 0]
    return vals, np.asarray(col.mask, bool)


def profile_column(name: str, col: FeatureColumn,
                   label: Optional[np.ndarray] = None
                   ) -> List[FeatureDistribution]:
    """Profile one raw column on the host into distributions (one per map
    key for maps).  ``label`` (the response values of the same rows)
    adds the null x label co-counts: pass it on the training side."""
    st = col.ftype.storage
    if st in NUMERIC_STORAGE:
        vals, mask = _numeric_view(col)
        return [_profile_numeric(name, None, vals, mask, label)]
    if st == "text":
        return [_profile_text(name, None, col.values, label)]
    if st in ("text_list", "multi_pick_list", "date_list"):
        flat = [" ".join(map(str, sorted(v))) if v else None
                for v in col.values]
        return [_profile_text(name, None, flat, label)]
    if st == "map":
        keys = sorted({k for row in col.values for k in row})
        out = []
        for k in keys:
            sample = next((row[k] for row in col.values if k in row), None)
            if isinstance(sample, (int, float, bool)) and not isinstance(
                    sample, bool):
                try:
                    vals, mask = [], []
                    for row in col.values:
                        v = row.get(k)
                        mask.append(v is not None)
                        vals.append(float(v) if v is not None else np.nan)
                    out.append(_profile_numeric(
                        name, k, np.asarray(vals), np.asarray(mask), label))
                    continue
                except (TypeError, ValueError):
                    pass  # heterogeneous values: profiled as text below
            out.append(_profile_text(
                name, k, [None if row.get(k) is None else str(row.get(k))
                          for row in col.values], label))
        return out
    # vectors and unknowns: count-only profile
    return [FeatureDistribution(name, None, count=len(col))]


def profile_numeric_batch(names: Sequence[str],
                          cols: Sequence[FeatureColumn],
                          label: Optional[np.ndarray],
                          device: torch.device) -> List[FeatureDistribution]:
    """``profile_column`` of many numeric columns (``NUMERIC_STORAGE``) at
    once: each group of ``PROFILE_COLS_PER_PASS`` columns goes to
    ``device`` as one (d, n) float64 matrix, and its histograms, null
    counts, moments and null x label co-counts come back in one pass of
    batched tensor ops.  Equal to the host profiles: counts, nulls and bins exactly, the
    float64 moment sums up to summation order."""
    out: List[FeatureDistribution] = []
    lab = lab_sum = lab_sum2 = None
    if label is not None:
        host_lab = np.nan_to_num(np.asarray(label, np.float64))
        lab_sum, lab_sum2 = float(host_lab.sum()), float((host_lab ** 2).sum())
        lab = torch.from_numpy(host_lab).to(device)
    step = PROFILE_COLS_PER_PASS
    for a in range(0, len(names), step):
        views = [_numeric_view(c) for c in cols[a:a + step]]
        X = torch.from_numpy(np.stack([v for v, _ in views])).to(device)
        M = torch.from_numpy(np.stack([m for _, m in views])).to(device)
        C, N, L = batched_histograms(X, M, NUMERIC_BINS)
        ok = M & torch.isfinite(X)
        Xf = torch.where(ok, X, 0.0)
        null = ~M
        stats = [null.sum(dim=1).to(torch.float64),
                 ok.sum(dim=1).to(torch.float64),
                 Xf.sum(dim=1), (Xf * Xf).sum(dim=1)]
        if lab is not None:
            stats.append(torch.where(null, lab, 0.0).sum(dim=1))
        host = torch.stack(stats).cpu().numpy()
        C, N, L = C.cpu().numpy(), N.cpu().numpy(), L.cpu().numpy()
        for j, name in enumerate(names[a:a + step]):
            d = FeatureDistribution(name, None, count=X.shape[1],
                                    nulls=int(host[0, j]))
            d.hist = StreamingHistogram.from_bins(
                C[j, :L[j]], N[j, :L[j]], NUMERIC_BINS)
            d.moments_n = float(host[1, j])
            d.moments_sum = float(host[2, j])
            d.moments_sum2 = float(host[3, j])
            if lab is not None:
                d.lab_sum, d.lab_sum2 = lab_sum, lab_sum2
                d.null_lab_sum = float(host[4, j])
                d.has_label = True
            out.append(d)
    return out


def merge_distributions(acc: Dict[tuple, FeatureDistribution],
                        dists: List[FeatureDistribution]) -> None:
    """Fold one part's profiles into a (name, key)-keyed accumulator."""
    for d in dists:
        k = (d.name, d.key)
        prev = acc.get(k)
        acc[k] = d if prev is None else prev + d
