"""Serving-side drift detection: sampled scoring traffic against the
train-side baselines (counterpart of ``transmogrifai_tpu.serving.drift``,
host numpy as there).

The fitted vectorizers carry ``metadata["drift_baseline"]`` (Welford
moments and histogram bins for numerics, the top category counts for
categoricals: ``ops/vectorizers.py``), so a server keeps the same
sketches over sampled traffic and compares per feature:

* **PSI** (population stability index) between the baseline's histogram
  or category frequencies and the window's, on the baseline's decile grid;
  above 0.25 (the default threshold) is the usual "significant shift";
* **moment z-score**: a two-sample z of the means (baseline and window
  variances), which catches a location shift the bins smear.

A window is evaluated once ``min_rows`` sampled rows gathered, then every
``check_every`` rows; a feature past a threshold sets
``refresh_triggered`` and calls ``on_drift``.  Sampling is a seeded
Bernoulli draw per request batch.  The ``drift.window`` fault point
(``utils/faults.py``) fires at each window's evaluation, ``index`` the
windows evaluated before it.  Not ported yet: the flight recorder's drift
events (ROADMAP Queue A item 6.6.7).
"""
from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..utils import faults
from ..utils.sketches import WelfordMoments
from ..utils.streaming_histogram import StreamingHistogram

__all__ = ["DriftMonitor", "DriftConfig", "export_drift_baselines",
           "psi_from_counts"]

#: PSI smoothing epsilon: a category/bin absent on one side contributes a
#: large-but-finite term instead of infinity
_PSI_EPS = 1e-4


def export_drift_baselines(model) -> Dict[str, Dict[str, Any]]:
    """Collect every fitted stage's exported drift baseline from a
    workflow model: {raw feature name -> baseline dict}.  Later stages
    win on (unexpected) name collisions."""
    out: Dict[str, Dict[str, Any]] = {}
    for stage in getattr(model, "stages", []):
        base = (stage.metadata or {}).get("drift_baseline")
        if isinstance(base, dict):
            for name, rec in base.items():
                if isinstance(rec, dict) and "kind" in rec:
                    out[name] = rec
    return out


def _anchored_cdf(centroids, counts, lo, hi):
    """(xs, ys) support points of the Ben-Haim/Tom-Tov interpolated CDF:
    mass linear between adjacent centroids (half a centroid's count on
    each side), ANCHORED at the observed min/max so the curve resolves
    below the first and above the last centroid — a heavy-tailed column
    merges ~30% of its mass into one low centroid, and without the
    anchor the CDF there is a step that reads as drift."""
    c = np.asarray(centroids, np.float64)
    n = np.asarray(counts, np.float64)
    total = n.sum()
    cum_mid = np.cumsum(n) - n / 2.0
    xs, ys = list(c), list(cum_mid)
    if lo is not None and (not xs or lo < xs[0]):
        xs, ys = [float(lo)] + xs, [0.0] + ys
    if hi is not None and (not xs or hi > xs[-1]):
        xs, ys = xs + [float(hi)], ys + [total]
    return np.asarray(xs), np.asarray(ys), total


def _interp_cell_masses(centroids, counts, edges, lo=None,
                        hi=None) -> np.ndarray:
    """Per-cell mass of a merged-centroid histogram on ``edges`` via the
    anchored interpolated CDF.  Whole-centroid cell assignment
    (``StreamingHistogram.density``) books a fat merged centroid
    entirely into one cell, which reads as drift when it is only bin
    quantization; the interpolation spreads it smoothly and the
    artifact cancels between the two sides."""
    edges = np.asarray(edges, np.float64)
    if np.asarray(counts).size == 0 or np.asarray(counts).sum() <= 0:
        return np.zeros(edges.size + 1)
    xs, ys, total = _anchored_cdf(centroids, counts, lo, hi)
    cdf = np.interp(edges, xs, ys, left=0.0, right=total)
    return np.diff(np.concatenate([[0.0], cdf, [total]]))


def psi_from_counts(expected, observed) -> float:
    """PSI between two aligned count vectors (eps-smoothed proportions)."""
    e = np.asarray(expected, np.float64)
    o = np.asarray(observed, np.float64)
    if e.sum() <= 0 or o.sum() <= 0:
        return 0.0
    p = np.maximum(e / e.sum(), _PSI_EPS)
    q = np.maximum(o / o.sum(), _PSI_EPS)
    p, q = p / p.sum(), q / q.sum()
    return float(((q - p) * np.log(q / p)).sum())


class DriftConfig:
    """Thresholds + sampling knobs for a DriftMonitor."""

    def __init__(self, sample_rate: float = 1.0, min_rows: int = 200,
                 check_every: Optional[int] = None,
                 psi_threshold: float = 0.25, z_threshold: float = 8.0,
                 max_bins: int = 32, seed: int = 7):
        self.sample_rate = float(sample_rate)
        self.min_rows = int(min_rows)
        self.check_every = int(check_every or min_rows)
        self.psi_threshold = float(psi_threshold)
        self.z_threshold = float(z_threshold)
        self.max_bins = int(max_bins)
        self.seed = int(seed)

    def to_json(self) -> Dict[str, Any]:
        return {"sampleRate": self.sample_rate, "minRows": self.min_rows,
                "checkEvery": self.check_every,
                "psiThreshold": self.psi_threshold,
                "zThreshold": self.z_threshold}


class _NumericTracker:
    __slots__ = ("mom", "hist")

    def __init__(self, max_bins: int):
        self.mom = WelfordMoments()
        self.hist = StreamingHistogram(max_bins)

    def update(self, values: List[float]) -> None:
        v = np.asarray(values, np.float64)
        v = v[np.isfinite(v)]
        if v.size:
            self.mom.update(v)
            self.hist.update(v)


class _CategoricalTracker:
    __slots__ = ("counts", "n")

    def __init__(self):
        self.counts: Dict[str, float] = {}
        self.n = 0.0

    def update(self, values: List[str]) -> None:
        for v in values:
            self.counts[v] = self.counts.get(v, 0.0) + 1.0
            self.n += 1.0


class DriftMonitor:
    """Compares sampled scoring traffic against train-side baselines.

    Thread-safe: ``observe_rows`` runs on the serving dispatch thread,
    ``snapshot`` on HTTP handler threads.  Evaluation happens inline on
    the observing thread at the ``check_every`` cadence (a few numpy ops
    over <=64-element vectors — cheaper than one scoring batch).
    """

    def __init__(self, baselines: Dict[str, Dict[str, Any]],
                 config: Optional[DriftConfig] = None,
                 on_drift: Optional[Callable[[Dict[str, Any]], None]] = None):
        self.baselines = dict(baselines)
        self.config = config or DriftConfig()
        self.on_drift = on_drift
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(self.config.seed)
        self._trackers: Dict[str, Any] = {}
        self._window_rows = 0
        self._rows_since_eval = 0
        self.rows_observed = 0
        self.windows_evaluated = 0
        self.drift_fires = 0
        self.refresh_triggered = False
        self.last_evaluation: Optional[Dict[str, Any]] = None
        self._reset_trackers()

    @classmethod
    def from_model(cls, model, config: Optional[DriftConfig] = None,
                   on_drift=None) -> "DriftMonitor":
        """Build a monitor from a fitted/loaded workflow model's exported
        baselines (ops/vectorizers.py ``metadata["drift_baseline"]``)."""
        return cls(export_drift_baselines(model), config=config,
                   on_drift=on_drift)

    def _reset_trackers(self) -> None:
        self._trackers = {}
        for name, base in self.baselines.items():
            if base.get("kind") == "numeric":
                self._trackers[name] = _NumericTracker(self.config.max_bins)
            elif base.get("kind") == "categorical":
                self._trackers[name] = _CategoricalTracker()

    # -- observation ---------------------------------------------------------

    def observe_rows(self, rows: Sequence[Dict[str, Any]]) -> None:
        """Fold a scoring batch's raw rows into the current window
        (sampled at ``sample_rate`` per batch, seeded — deterministic for
        a fixed request sequence)."""
        if not rows or not self._trackers:
            return
        with self._lock:
            if (self.config.sample_rate < 1.0
                    and self._rng.random() >= self.config.sample_rate):
                return
            for name, tracker in self._trackers.items():
                if isinstance(tracker, _NumericTracker):
                    vals = [r.get(name) for r in rows]
                    tracker.update([float(v) for v in vals
                                    if isinstance(v, (int, float))])
                else:
                    vals = [r.get(name) for r in rows]
                    flat: List[str] = []
                    for v in vals:
                        if v is None:
                            continue
                        if isinstance(v, (list, tuple, set, frozenset)):
                            flat.extend(str(x) for x in v)
                        else:
                            flat.append(str(v))
                    tracker.update(flat)
            self._window_rows += len(rows)
            self._rows_since_eval += len(rows)
            self.rows_observed += len(rows)
            due = (self._window_rows >= self.config.min_rows
                   and self._rows_since_eval >= self.config.check_every)
        if due:
            self.evaluate()

    # -- evaluation ----------------------------------------------------------

    def _feature_drift(self, name: str, base: Dict[str, Any],
                       tracker) -> Optional[Dict[str, Any]]:
        if isinstance(tracker, _NumericTracker):
            if tracker.mom.mean is None or base.get("n", 0) <= 1:
                return None
            n_b, n_s = float(base["n"]), float(tracker.mom.n)
            var_b = float(base["m2"]) / max(n_b - 1.0, 1.0)
            var_s = float(tracker.mom.variance(ddof=1))
            delta = abs(float(tracker.mom.mean) - float(base["mean"]))
            denom = math.sqrt(max(var_b / n_b + var_s / max(n_s, 1.0),
                                  1e-300))
            z = delta / denom if delta > 0 else 0.0
            # PSI on the baseline's DECILE grid (the conventional ~10
            # PSI buckets): both histograms are merged-centroid sketches,
            # and comparing them cell-per-centroid would book pure bin-
            # boundary quantization as drift — deciles give each cell
            # ~10% expected mass, far above the quantization noise
            psi = 0.0
            centroids = np.asarray(base["histCentroids"], np.float64)
            counts = np.asarray(base["histCounts"], np.float64)
            if centroids.size >= 2 and counts.sum() > 0:
                # decile grid from the baseline's anchored CDF (the
                # conventional ~10 PSI buckets, ~10% expected mass each)
                xs, ys, total = _anchored_cdf(
                    centroids, counts, base.get("min"), base.get("max"))
                grid = np.unique(np.interp(
                    np.linspace(0.1, 0.9, 9) * total, ys, xs))
                if grid.size >= 1:
                    psi = psi_from_counts(
                        _interp_cell_masses(centroids, counts, grid,
                                            base.get("min"),
                                            base.get("max")),
                        _interp_cell_masses(
                            tracker.hist.centroids, tracker.hist.counts,
                            grid, tracker.mom.min, tracker.mom.max))
            drifted = (psi > self.config.psi_threshold
                       or z > self.config.z_threshold)
            return {"kind": "numeric", "psi": round(psi, 4),
                    "z": round(min(z, 1e9), 3),
                    "baselineMean": float(base["mean"]),
                    "windowMean": float(tracker.mom.mean),
                    "rows": int(n_s), "drifted": drifted}
        # categorical: align the window counts onto the baseline's
        # category list; everything unseen at train time pools into OTHER
        if tracker.n <= 0 or base.get("n", 0) <= 0:
            return None
        values = list(base.get("values", []))
        base_counts = np.asarray(base.get("counts", []), np.float64)
        known = set(values)
        obs = np.array([tracker.counts.get(v, 0.0) for v in values]
                       + [sum(c for k, c in tracker.counts.items()
                              if k not in known)], np.float64)
        exp_other = max(float(base["n"]) - float(base_counts.sum()), 0.0)
        exp = np.concatenate([base_counts, [exp_other]])
        psi = psi_from_counts(exp, obs)
        drifted = psi > self.config.psi_threshold
        return {"kind": "categorical", "psi": round(psi, 4),
                "rows": int(tracker.n), "drifted": drifted}

    def evaluate(self) -> Dict[str, Any]:
        """Score the current window against the baselines; rolls the
        window forward (trackers reset) and records the result."""
        with self._lock:
            faults.fire("drift.window", index=self.windows_evaluated)
            features: Dict[str, Any] = {}
            for name, base in self.baselines.items():
                tracker = self._trackers.get(name)
                if tracker is None:
                    continue
                rec = self._feature_drift(name, base, tracker)
                if rec is not None:
                    features[name] = rec
            drifted = sorted(n for n, r in features.items() if r["drifted"])
            result = {
                "at": time.time(),
                "windowRows": self._window_rows,
                "features": features,
                "driftedFeatures": drifted,
                "drifted": bool(drifted),
            }
            self.windows_evaluated += 1
            self._window_rows = 0
            self._rows_since_eval = 0
            self._reset_trackers()
            self.last_evaluation = result
            fired = bool(drifted) and not self.refresh_triggered
            if drifted:
                self.drift_fires += 1
                self.refresh_triggered = True
            cb = self.on_drift if fired else None
        if cb is not None:
            try:
                cb(result)
            except Exception:  # callbacks must not break the serving path
                pass
        return result

    def clear_refresh_trigger(self) -> None:
        """Acknowledge a handled refresh trigger (the refresh driver calls
        this after a successful guarded swap)."""
        with self._lock:
            self.refresh_triggered = False

    # -- reading -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view for ``/metrics``."""
        with self._lock:
            return {
                "config": self.config.to_json(),
                "trackedFeatures": len(self._trackers),
                "rowsObserved": self.rows_observed,
                "windowRows": self._window_rows,
                "windowsEvaluated": self.windows_evaluated,
                "driftFires": self.drift_fires,
                "refreshTriggered": self.refresh_triggered,
                "lastEvaluation": self.last_evaluation,
            }
