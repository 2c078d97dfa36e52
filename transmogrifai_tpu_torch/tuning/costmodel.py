"""Learned per-stage cost model (counterpart of the fit/predict half of
``transmogrifai_tpu.tuning.costmodel``): a log-space ridge per (stage
kind, backend) over ``(rows, cols, devices)`` features, with a per-kind
bucket as the first fallback and an analytic elements-per-second law as
the cold start.

The straggler watchdog reads it (``ModelSelector.with_watchdog``): a
unit's deadline is a factor times the fitted prediction, and a cold tier
keeps the watchdog off.  Observations live in a JSON history at
``TMOG_COST_HISTORY`` (no path, no history); the port neither reads nor
writes the JAX-era ``benchmarks/`` history, whose walls were taken on
another backend.  Every train records its plan profiler's stage
observations there (``record_train_observations``), bucketed by the
backend names the JAX package uses ("gpu", "cpu";
``utils.profiling.backend_name``).  ``ServingCostLookup`` predicts a
serving batch's wall per shape bucket for the micro-batcher and the
multi-tenant dispatcher: a measured EWMA, else the fitted
``Serving:batch`` kind, else the analytic law.
"""
from __future__ import annotations

import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["StageObservation", "CostModel", "ServingCostLookup",
           "load_observations",
           "append_observations", "default_history_path",
           "observations_from_profiler", "record_train_observations",
           "HISTORY_OBSERVATION_CAP"]

#: FIFO cap on persisted stage observations
HISTORY_OBSERVATION_CAP = 4000

#: key of the stage observations inside the history file
HISTORY_STAGES_KEY = "stage_observations"

#: analytic cold-start law: matrix elements a second
DEFAULT_ELEMS_PER_S = 5e7

#: no stage is free: floor on any prediction (seconds)
PREDICTION_FLOOR_S = 1e-4


@dataclass
class StageObservation:
    """One observed stage execution: the cost model's training row."""

    stage_kind: str          # "OpClass:kind", e.g. "ModelSelector:fit"
    rows: int
    cols: int
    dtype: str
    backend: str             # the platform that ran it ("gpu", "cpu")
    wall_s: float
    t: int = 0               # unix seconds (0 = unknown)
    n_devices: int = 1
    mesh_shape: str = ""
    #: the stage's kernel mix from a traced run (``StageProfile.hlo``,
    #: ``obs/kernel_mix.py``); empty untraced.  The ridge ignores it.
    hlo: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        out = {"stageKind": self.stage_kind, "rows": self.rows,
               "cols": self.cols, "dtype": self.dtype,
               "backend": self.backend, "wallSecs": round(self.wall_s, 6),
               "t": self.t}
        if self.n_devices != 1:
            out["nDevices"] = self.n_devices
        if self.mesh_shape:
            out["meshShape"] = self.mesh_shape
        if self.hlo:
            out["hlo"] = dict(self.hlo)
        return out

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "StageObservation":
        return StageObservation(
            stage_kind=str(d.get("stageKind", "")),
            rows=int(d.get("rows", 0)), cols=int(d.get("cols", 0)),
            dtype=str(d.get("dtype", "")),
            backend=str(d.get("backend", "")),
            wall_s=float(d.get("wallSecs", 0.0)), t=int(d.get("t", 0)),
            n_devices=int(d.get("nDevices", 1)),
            mesh_shape=str(d.get("meshShape", "")),
            hlo=dict(d.get("hlo", {}) or {}))


def _features(rows: int, cols: int, n_devices: int = 1) -> np.ndarray:
    lr = math.log1p(max(rows, 0))
    lc = math.log1p(max(cols, 0))
    ld = math.log2(max(n_devices, 1))
    return np.array([1.0, lr, lc, lr * lc, ld], dtype=np.float64)


class CostModel:
    """Per-stage-kind fitted wall predictor with an analytic fallback
    (a closed-form ridge per bucket)."""

    def __init__(self, ridge: float = 1e-3, min_obs: int = 1,
                 elems_per_s: float = DEFAULT_ELEMS_PER_S):
        self.ridge = ridge
        self.min_obs = min_obs
        self.elems_per_s = elems_per_s
        #: coefficients by (stage_kind, backend), and by (stage_kind, None)
        self._coef: Dict[Tuple[str, Optional[str]], np.ndarray] = {}
        self._n_obs: Dict[Tuple[str, Optional[str]], int] = {}

    def fit(self, observations: Sequence[StageObservation]) -> "CostModel":
        """Refit every bucket; repeats at one (kind, backend, shape)
        collapse to their least wall (a first run pays set-up that later
        ones do not)."""
        buckets: Dict[Tuple[str, Optional[str]],
                      Dict[Tuple[int, int, int], float]] = {}
        for o in observations:
            if o.wall_s <= 0 or not o.stage_kind:
                continue
            for key in ((o.stage_kind, o.backend or None),
                        (o.stage_kind, None)):
                pts = buckets.setdefault(key, {})
                loc = (o.rows, o.cols, max(o.n_devices, 1))
                pts[loc] = min(pts.get(loc, float("inf")), o.wall_s)
        self._coef.clear()
        self._n_obs.clear()
        for key, pts in buckets.items():
            if len(pts) < self.min_obs:
                continue
            A = np.stack([_features(r, c, nd) for r, c, nd in pts])
            b = np.log(np.array(list(pts.values())) + 1e-6)
            G = A.T @ A + self.ridge * np.eye(A.shape[1])
            self._coef[key] = np.linalg.solve(G, A.T @ b)
            self._n_obs[key] = len(pts)
        return self

    @property
    def fitted_kinds(self) -> List[str]:
        return sorted({k for k, be in self._coef if be is None})

    def analytic(self, rows: int, cols: int) -> float:
        """Cold-start fallback: an elements/throughput law."""
        elems = max(rows, 1) * max(cols, 1)
        return max(elems / self.elems_per_s, PREDICTION_FLOOR_S)

    def predict(self, stage_kind: str, rows: int, cols: int,
                dtype: str = "float32",
                backend: Optional[str] = None,
                n_devices: int = 1) -> float:
        """Predicted wall seconds; never raises, never returns <= 0."""
        for key in ((stage_kind, backend or None), (stage_kind, None)):
            w = self._coef.get(key)
            if w is not None:
                pred = float(np.exp(
                    w @ _features(rows, cols, n_devices))) - 1e-6
                return max(pred, PREDICTION_FLOOR_S)
        return self.analytic(rows, cols)

    def source(self, stage_kind: str,
               backend: Optional[str] = None) -> str:
        """'fitted' (the backend's or the kind's ridge) or 'analytic'."""
        if ((stage_kind, backend or None) in self._coef
                or (stage_kind, None) in self._coef):
            return "fitted"
        return "analytic"

    def predict_total(self, rows: int, cols: int,
                      backend: Optional[str] = None,
                      n_devices: int = 1) -> float:
        """The sum of the predictions of every fitted kind (0.0 when the
        model is cold)."""
        return float(sum(self.predict(k, rows, cols, backend=backend,
                                      n_devices=n_devices)
                         for k in self.fitted_kinds))

    def within_factor(self, observations: Sequence[StageObservation],
                      factor: float = 2.0,
                      noise_floor_s: float = 0.005) -> Tuple[float, int]:
        """(share of the observations predicted within ``factor`` x their
        wall, or within ``noise_floor_s`` of it; the count evaluated)."""
        hits, n = 0, 0
        for o in observations:
            if o.wall_s <= 0 or not o.stage_kind:
                continue
            pred = self.predict(o.stage_kind, o.rows, o.cols,
                                dtype=o.dtype, backend=o.backend,
                                n_devices=o.n_devices)
            n += 1
            ratio = max(pred, o.wall_s) / max(min(pred, o.wall_s), 1e-9)
            if ratio <= factor or abs(pred - o.wall_s) <= noise_floor_s:
                hits += 1
        return (hits / n if n else 0.0), n

    @classmethod
    def from_history(cls, path: Optional[str] = None,
                     **kwargs) -> "CostModel":
        path = path or default_history_path()
        obs = load_observations(path) if path else []
        return cls(**kwargs).fit(obs)


def default_history_path() -> Optional[str]:
    """``TMOG_COST_HISTORY`` (empty or "0": none), else None."""
    env = os.environ.get("TMOG_COST_HISTORY")
    if env is None or env in ("", "0"):
        return None
    return env


def load_observations(path: Optional[str]) -> List[StageObservation]:
    from ..utils.jsonio import read_json_tolerant

    if not path:
        return []
    hist = read_json_tolerant(path, {})
    if not isinstance(hist, dict):
        return []
    raw = hist.get(HISTORY_STAGES_KEY, [])
    out = []
    for d in raw if isinstance(raw, list) else []:
        try:
            out.append(StageObservation.from_json(d))
        except (TypeError, ValueError):
            continue
    return out


def append_observations(path: Optional[str],
                        observations: Sequence[StageObservation],
                        cap: int = HISTORY_OBSERVATION_CAP) -> bool:
    """Append observations to the history file, FIFO-capped, atomically;
    every other key of the file is kept.  True when it wrote."""
    from ..utils.jsonio import read_json_tolerant, write_json_atomic

    if not path or not observations:
        return False
    hist = read_json_tolerant(path, {})
    if not isinstance(hist, dict):
        hist = {}
    raw = hist.get(HISTORY_STAGES_KEY, [])
    if not isinstance(raw, list):
        raw = []
    raw.extend(o.to_json() for o in observations)
    hist[HISTORY_STAGES_KEY] = raw[-cap:]
    try:
        write_json_atomic(path, hist, indent=2, sort_keys=True)
    except OSError:
        return False
    return True


class ServingCostLookup:
    """Per-bucket predicted wall seconds of one served batch, for the
    continuous batch formation (``serving/batcher.py``) and the
    multi-tenant dispatcher.  Three tiers, sharpest first: the EWMA of the
    walls measured at that bucket (the batcher feeds every executed batch
    back), else the nearest measured bucket's level scaled by the
    analytic law's slope, else the fitted ``CostModel`` under the
    ``Serving:batch`` kind, else the analytic per-row law.  Thread-safe:
    read by the dispatch thread, written after every batch."""

    STAGE_KIND = "Serving:batch"

    def __init__(self, cost_model: Optional[CostModel] = None,
                 cols: int = 0, alpha: float = 0.3):
        self.cost_model = cost_model
        self.cols = int(cols)
        self.alpha = float(alpha)
        self._ewma: Dict[int, float] = {}
        self._counts: Dict[int, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_history(cls, cols: int = 0,
                     path: Optional[str] = None) -> "ServingCostLookup":
        return cls(cost_model=CostModel.from_history(path), cols=cols)

    def observe(self, bucket: int, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            prev = self._ewma.get(bucket)
            self._ewma[bucket] = seconds if prev is None else (
                self.alpha * seconds + (1.0 - self.alpha) * prev)
            self._counts[bucket] = self._counts.get(bucket, 0) + 1

    @staticmethod
    def _analytic(bucket: int) -> float:
        # a dispatch floor plus a per-row cost
        return PREDICTION_FLOOR_S + bucket * 2e-5

    def predict_s(self, bucket: int) -> float:
        """Predicted wall seconds of one batch at ``bucket``.  Once any
        bucket is measured, an unmeasured one extrapolates from the
        nearest measured (in log space): measured level, analytic slope,
        so that it never looks spuriously cheap beside a measured one."""
        with self._lock:
            measured = self._ewma.get(bucket)
            ewma = dict(self._ewma) if measured is None else None
        if measured is not None:
            return max(measured, PREDICTION_FLOOR_S)
        if ewma:
            near = min(ewma, key=lambda b: abs(
                math.log(max(b, 1) / max(bucket, 1))))
            scaled = ewma[near] * (self._analytic(bucket)
                                   / self._analytic(near))
            return max(scaled, PREDICTION_FLOOR_S)
        if self.cost_model is not None:
            return self.cost_model.predict(self.STAGE_KIND, rows=bucket,
                                           cols=max(self.cols, 1))
        return self._analytic(bucket)

    def source(self, bucket: int) -> str:
        """'measured', 'fitted' or 'analytic': the tier ``predict_s``
        reads for ``bucket`` before any extrapolation."""
        with self._lock:
            if bucket in self._ewma:
                return "measured"
        if self.cost_model is not None and self.cost_model.source(
                self.STAGE_KIND) == "fitted":
            return "fitted"
        return "analytic"

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"ewmaMs": {str(b): round(v * 1000.0, 4)
                               for b, v in sorted(self._ewma.items())},
                    "observedBatches": dict(sorted(
                        (str(k), v) for k, v in self._counts.items()))}


def observations_from_profiler(profiler,
                               backend: str = "") -> List[StageObservation]:
    """The stage observations of a ``PlanProfiler``'s records (those
    with a positive wall)."""
    now = int(time.time())
    out: List[StageObservation] = []
    for sp in getattr(profiler, "stages", []):
        if sp.wall_s <= 0:
            continue
        out.append(StageObservation(
            stage_kind=sp.stage_kind or f"{sp.op}:{sp.kind}",
            rows=sp.rows, cols=max(sp.cols, 1), dtype=sp.dtype or "",
            backend=sp.backend or backend, wall_s=sp.wall_s, t=now,
            n_devices=max(int(sp.n_devices or 1), 1),
            mesh_shape=sp.mesh_shape or "", hlo=dict(sp.hlo or {})))
    return out


def record_train_observations(profiler, path: Optional[str] = None,
                              backend: str = "") -> bool:
    """Append a train's stage observations to the cost history (``path``,
    else ``TMOG_COST_HISTORY``; no path, no write).  Never raises: the
    record must not break a train."""
    try:
        path = path if path is not None else default_history_path()
        if not path or profiler is None:
            return False
        return append_observations(
            path, observations_from_profiler(profiler, backend=backend))
    except Exception:
        return False
