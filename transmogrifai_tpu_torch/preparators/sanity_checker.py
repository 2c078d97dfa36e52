"""SanityChecker — automated feature validation against the label.

Counterpart of ``transmogrifai_tpu.preparators.sanity_checker`` with the
same drop rules: low variance, label correlation above
``max_correlation`` (leakage) or below ``min_correlation``, and Cramér's V
of a categorical group above ``max_cramers_v``.  Statistics are device
reductions (``ops.stats``); the label correlation is Pearson's or, with
``correlation_type="spearman"``, Spearman's (Pearson on the float32
average ranks, ``ops.stats.spearman_with_label``).  The fitted model
gathers the kept columns of the device matrix, and its metadata carries
``drift_baseline_vector``: the kept slots' names, mean and variance (the
drift monitor's feature-space view).  ``MinVarianceFilter`` drops the
columns whose variance is below ``min_variance``, with no label.

Both stream (``begin_fit``..``finish_fit``) as in the JAX package, with
its host sketches: each chunk's matrix comes to the host, where a
``PearsonSketch`` (``WelfordMoments`` for the filter) and, for a
categorical label, float64 per-label column sums (Cramér's V) accumulate.
The results equal the JAX package's streaming fit bit for bit, and the
in-core fit's within the float64 summation order (about 1e-12
relative); the keep decisions are the same.  Spearman needs a global
rank sort and does not stream; a sampled checker (``check_sample < 1``)
draws one PCG64 stream across the chunks, so it keeps the in-core fit's
rows.  ``export_fit_state``/``import_fit_state`` carry the streaming
state through a checkpoint exactly, the generator's position included,
so a resumed sampled fit draws the rows it would have drawn
uninterrupted.  A raw ``OPVector`` input (a host array) moves to the
device once, where the stage takes it (``device.device_vector``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import device_vector
from ..ops.stats import (ColStats, col_stats, col_stats_with_label,
                         contingency_stats, cramers_v, spearman_with_label)
from ..ops.vector_metadata import VectorMetadata
from ..stages.base import BinaryEstimator, BinaryModel
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import OPNumeric, OPVector
from ..utils.sketches import PearsonSketch, WelfordMoments

__all__ = ["SanityChecker", "SanityCheckerModel", "MinVarianceFilter",
           "MinVarianceFilterModel"]


def _label_tensor(label_col: FeatureColumn, dev) -> torch.Tensor:
    y = np.nan_to_num(np.asarray(label_col.values, dtype=np.float32))
    return torch.from_numpy(y).to(dev)


def _host_matrix(features_col: FeatureColumn) -> np.ndarray:
    """A chunk's feature matrix as float32 on the host (the sketches'
    side)."""
    X = features_col.values
    if isinstance(X, torch.Tensor):
        return X.detach().to(torch.float32).cpu().numpy()
    return np.asarray(X, dtype=np.float32)


class _StreamState:
    """The checker's streaming state: the Pearson sketch, the label values
    seen, the per-label column sums (None once the label cannot be
    categorical), the vector metadata, the width and the sampling rng."""

    __slots__ = ("pearson", "label_values", "label_sums", "vmeta", "d",
                 "rng")

    def __init__(self, rng):
        self.pearson = PearsonSketch()
        self.label_values = np.zeros(0, np.float64)
        self.label_sums: Optional[Dict[float, np.ndarray]] = {}
        self.vmeta = None
        self.d: Optional[int] = None
        self.rng = rng


class SanityChecker(BinaryEstimator):
    """Inputs: (label RealNN, features OPVector) -> cleaned OPVector."""

    device_heavy = True
    input_types = (OPNumeric, OPVector)
    label_input_positions = (0,)
    #: per-label column sums stop past this many label values when the
    #: label is declared categorical (else past ``max_label_classes``)
    _STREAM_LABEL_CAP_HARD = 4096

    @property
    def supports_streaming_fit(self) -> bool:  # type: ignore[override]
        return self.correlation_type != "spearman"

    def __init__(self, check_sample: float = 1.0, sample_seed: int = 42,
                 min_variance: float = 1e-5, min_correlation: float = 0.0,
                 max_correlation: float = 0.95, max_cramers_v: float = 0.95,
                 correlation_type: str = "pearson",
                 remove_bad_features: bool = True,
                 remove_feature_group: bool = True,
                 categorical_label: Optional[bool] = None,
                 max_label_classes: int = 100, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="sanityCheck", output_type=OPVector,
                         uid=uid)
        if correlation_type not in ("pearson", "spearman"):
            raise ValueError(f"unknown correlation_type {correlation_type!r}")
        self.check_sample = check_sample
        self.sample_seed = sample_seed
        self.min_variance = min_variance
        self.min_correlation = min_correlation
        self.max_correlation = max_correlation
        self.max_cramers_v = max_cramers_v
        self.correlation_type = correlation_type
        self.remove_bad_features = remove_bad_features
        #: taken and recorded (``get_params``), read nowhere: the JAX
        #: package stores it and reads it nowhere either
        self.remove_feature_group = remove_feature_group
        self.categorical_label = categorical_label
        self.max_label_classes = max_label_classes
        self.device = device

    def fit_columns(self, data: ColumnarDataset, label_col: FeatureColumn,
                    features_col: FeatureColumn):
        X = device_vector(features_col, self.device).values
        y = _label_tensor(label_col, X.device)
        n, d = X.shape
        if self.check_sample < 1.0:
            # the JAX package's numpy draw, so both keep the same rows
            rng = np.random.default_rng(self.sample_seed)
            idx = torch.from_numpy(np.flatnonzero(
                rng.random(n) < self.check_sample)).to(X.device)
            X, y = X[idx], y[idx]
            n = len(y)
        vmeta = features_col.vmeta or VectorMetadata("features", [])
        stats = col_stats_with_label(X, y)
        if self.correlation_type == "spearman":
            stats = stats._replace(corr=np.nan_to_num(
                spearman_with_label(X, y)))

        uniq = torch.unique(y)
        is_cat_label = (self.categorical_label
                        if self.categorical_label is not None
                        else len(uniq) <= min(self.max_label_classes, n // 2))
        group_cv: Dict[Tuple[str, Optional[str]], float] = {}
        if is_cat_label and vmeta.size == d:
            labels_int = torch.searchsorted(uniq, y)
            for key, idxs in _indicator_groups(vmeta).items():
                cols = torch.as_tensor(idxs, device=X.device)
                group_cv[key] = cramers_v(labels_int, X[:, cols],
                                          len(uniq))["cramersV"]
        return self._finalize(stats, group_cv, vmeta, n, d)

    def _finalize(self, stats, group_cv, vmeta, n: int, d: int
                  ) -> "SanityCheckerModel":
        to_drop = np.zeros(d, dtype=bool)
        reasons: List[List[str]] = [[] for _ in range(d)]
        for j in range(d):
            if stats.variance[j] < self.min_variance:
                to_drop[j] = True
                reasons[j].append("low variance")
            a = abs(stats.corr[j])
            if a > self.max_correlation:
                to_drop[j] = True
                reasons[j].append(
                    f"label correlation {a:.3f} > {self.max_correlation} "
                    f"(leakage)")
            elif 0 < self.min_correlation and a < self.min_correlation:
                to_drop[j] = True
                reasons[j].append("correlation below minimum")
        if vmeta.size == d:
            for j, c in enumerate(vmeta.columns):
                cv = group_cv.get((c.parent_feature, c.grouping))
                if cv is not None and cv > self.max_cramers_v:
                    to_drop[j] = True
                    reasons[j].append(
                        f"group Cramér's V {cv:.3f} > {self.max_cramers_v}")
        names = (vmeta.column_names() if vmeta.size == d
                 else [f"f_{j}" for j in range(d)])
        keep = ([j for j in range(d) if not to_drop[j]]
                if self.remove_bad_features else list(range(d)))
        parents = ([c.parent_feature for c in vmeta.columns]
                   if vmeta.size == d else ["features"] * d)
        group_of = ([group_cv.get((c.parent_feature, c.grouping))
                     for c in vmeta.columns]
                    if vmeta.size == d else [None] * d)
        self.metadata["summary"] = {
            "correlationType": self.correlation_type,
            "sampleSize": float(n),
            "dropped": [names[j] for j in range(d) if to_drop[j]],
            "columnStats": [
                {"name": names[j], "parent_feature": parents[j],
                 "mean": float(stats.mean[j]),
                 "variance": float(stats.variance[j]),
                 "min": float(stats.min[j]), "max": float(stats.max[j]),
                 "corr_label": float(stats.corr[j]),
                 "cramers_v": group_of[j],
                 "dropped": bool(to_drop[j]), "reasons": reasons[j]}
                for j in range(d)],
        }
        self.metadata["drift_baseline_vector"] = {
            "names": [names[j] for j in keep], "n": float(n),
            "mean": np.asarray(stats.mean, np.float64)[keep],
            "variance": np.asarray(stats.variance, np.float64)[keep]}
        model = SanityCheckerModel(keep_indices=keep)
        model.new_vmeta = vmeta.select(keep) if vmeta.size == d else None
        return model

    # -- streaming fit ------------------------------------------------------

    def begin_fit(self) -> _StreamState:
        if self.correlation_type == "spearman":
            raise ValueError(
                "SanityChecker streaming fit requires a streamable "
                "correlation (spearman needs a global rank sort)")
        return _StreamState(np.random.default_rng(self.sample_seed)
                            if self.check_sample < 1.0 else None)

    def export_fit_state(self, state: _StreamState) -> dict:
        """The state as the checkpoint codec takes it (the JAX package's
        keys; the generator is persisted by its bit generator's state)."""
        return {"pearson": state.pearson,
                "label_values": state.label_values,
                "label_sums": state.label_sums,
                "vmeta": state.vmeta,
                "d": state.d,
                "rng": state.rng}

    def import_fit_state(self, payload: dict) -> _StreamState:
        state = _StreamState(payload["rng"])
        state.pearson = payload["pearson"]
        state.label_values = np.asarray(payload["label_values"],
                                        dtype=np.float64)
        sums = payload["label_sums"]
        state.label_sums = (None if sums is None
                            else {float(k): np.asarray(v, np.float64)
                                  for k, v in sums.items()})
        state.vmeta = payload["vmeta"]
        state.d = None if payload["d"] is None else int(payload["d"])
        return state

    def update_chunk(self, state, data, label_col, features_col):
        X = _host_matrix(features_col)
        y = np.nan_to_num(np.asarray(label_col.values, dtype=np.float32))
        if state.rng is not None:
            # successive chunk-length draws continue one PCG64 stream: the
            # rows the in-core fit keeps
            sel = state.rng.random(len(y)) < self.check_sample
            X, y = X[sel], y[sel]
        if state.d is None:
            state.d = X.shape[1]
            state.vmeta = features_col.vmeta
        if len(y) == 0:
            return state
        state.pearson.update(X, y)
        uniq = np.unique(y)
        state.label_values = np.union1d(state.label_values, uniq)
        cap = (self._STREAM_LABEL_CAP_HARD if self.categorical_label
               else self.max_label_classes)
        if self.categorical_label is False or len(state.label_values) > cap:
            state.label_sums = None
        if state.label_sums is not None:
            for uv in uniq:
                sums = X[y == uv].sum(axis=0, dtype=np.float64)
                prev = state.label_sums.get(float(uv))
                state.label_sums[float(uv)] = (sums if prev is None
                                               else prev + sums)
        return state

    def merge_states(self, a, b):
        if b.d is None:
            return a
        if a.d is None:
            return b
        a.pearson.merge(b.pearson)
        a.label_values = np.union1d(a.label_values, b.label_values)
        if a.label_sums is None or b.label_sums is None:
            a.label_sums = None
        else:
            for k, v in b.label_sums.items():
                prev = a.label_sums.get(k)
                a.label_sums[k] = v if prev is None else prev + v
        return a

    def finish_fit(self, state) -> "SanityCheckerModel":
        d = state.d or 0
        n = int(state.pearson.x.n) if state.pearson.c is not None else 0
        if n == 0 or d == 0:
            raise ValueError("SanityChecker streaming fit saw no rows")
        vmeta = state.vmeta or VectorMetadata("features", [])
        x = state.pearson.x
        stats = ColStats(np.asarray(x.mean), np.asarray(x.variance(ddof=1)),
                         np.asarray(x.min), np.asarray(x.max),
                         state.pearson.correlation())
        uniq = state.label_values
        is_cat_label = (self.categorical_label
                        if self.categorical_label is not None
                        else len(uniq) <= min(self.max_label_classes,
                                              n // 2))
        group_cv: Dict[Tuple[str, Optional[str]], float] = {}
        if is_cat_label and vmeta.size == d and state.label_sums is not None:
            tbl = np.stack([state.label_sums[float(v)] for v in uniq])
            for key, idxs in _indicator_groups(vmeta).items():
                group_cv[key] = contingency_stats(tbl[:, idxs])["cramersV"]
        return self._finalize(stats, group_cv, vmeta, n, d)


def _indicator_groups(vmeta: VectorMetadata
                      ) -> Dict[Tuple[str, Optional[str]], List[int]]:
    groups: Dict[Tuple[str, Optional[str]], List[int]] = {}
    for i, c in enumerate(vmeta.columns):
        if c.indicator_value is not None:
            groups.setdefault((c.parent_feature, c.grouping), []).append(i)
    return groups


class _KeepColumns:
    """The fitted index filter of SanityChecker and MinVarianceFilter: the
    kept columns of the last input's device matrix, with the filtered
    vector metadata persisted under the JAX package's extra-state key."""

    keep_indices: List[int]
    new_vmeta: Optional[VectorMetadata] = None

    def extra_state(self):
        return ({"new_vmeta": self.new_vmeta.to_json()}
                if self.new_vmeta is not None else {})

    def set_extra_state(self, state):
        if "new_vmeta" in state:
            self.new_vmeta = VectorMetadata.from_json(state["new_vmeta"])

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        features_col = device_vector(cols[-1])
        X = features_col.values
        idx = torch.as_tensor(self.keep_indices, dtype=torch.long,
                              device=X.device)
        vmeta = self.new_vmeta
        if vmeta is None and features_col.vmeta is not None:
            vmeta = features_col.vmeta.select(self.keep_indices)
        return FeatureColumn(OPVector, X.index_select(1, idx).contiguous(),
                             vmeta=vmeta)


class SanityCheckerModel(_KeepColumns, BinaryModel):
    """Index-filter on the feature vector."""

    input_types = (OPNumeric, OPVector)
    label_input_positions = (0,)

    def __init__(self, keep_indices: List[int], uid: Optional[str] = None):
        super().__init__(operation_name="sanityCheck", output_type=OPVector,
                         uid=uid)
        self.keep_indices = list(keep_indices)
        self.new_vmeta = None


class MinVarianceFilter(BinaryEstimator):
    """Drops the feature columns whose variance (ddof=1) is below
    ``min_variance``.  Inputs (anything, features OPVector) or (features):
    the first of two is ignored, so the stage wires like SanityChecker."""

    input_arity = (1, 2)
    label_input_positions = (0,)
    supports_streaming_fit = True

    def __init__(self, min_variance: float = 1e-5,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="minVariance", output_type=OPVector,
                         uid=uid)
        self.min_variance = min_variance
        self.device = device

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        features_col = device_vector(cols[-1], self.device)
        return self._keep(col_stats(features_col.values).variance,
                          features_col.vmeta)

    def begin_fit(self):
        return {"moments": WelfordMoments(), "vmeta": None, "d": None}

    def update_chunk(self, state, data, *cols):
        X = _host_matrix(cols[-1])
        if state["d"] is None:
            state["d"] = X.shape[1]
            state["vmeta"] = cols[-1].vmeta
        state["moments"].update(X)
        return state

    def merge_states(self, a, b):
        if b["d"] is None:
            return a
        if a["d"] is None:
            return b
        a["moments"].merge(b["moments"])
        return a

    def finish_fit(self, state) -> "MinVarianceFilterModel":
        if state["d"] is None:
            raise ValueError("MinVarianceFilter streaming fit saw no rows")
        return self._keep(np.asarray(state["moments"].variance(ddof=1)),
                          state["vmeta"])

    def _keep(self, variance, vmeta) -> "MinVarianceFilterModel":
        d = len(variance)
        keep = [j for j in range(d) if variance[j] >= self.min_variance]
        named = vmeta is not None and vmeta.size == d
        kept = set(keep)
        self.metadata["summary"] = {
            "dropped": ([n for j, n in enumerate(vmeta.column_names())
                         if j not in kept] if named else [])}
        model = MinVarianceFilterModel(keep_indices=keep)
        model.new_vmeta = vmeta.select(keep) if named else None
        return model


class MinVarianceFilterModel(_KeepColumns, BinaryModel):
    input_arity = (1, 2)
    label_input_positions = (0,)

    def __init__(self, keep_indices: List[int], uid: Optional[str] = None):
        super().__init__(operation_name="minVariance", output_type=OPVector,
                         uid=uid)
        self.keep_indices = list(keep_indices)
        self.new_vmeta = None
