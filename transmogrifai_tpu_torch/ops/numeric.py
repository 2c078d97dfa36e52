"""Numeric preparation stages (counterpart of ``transmogrifai_tpu.ops.numeric``).

 * ``NumericBucketizer`` — fixed split points -> one-hot buckets
 * ``DecisionTreeNumericBucketizer`` — the split points of a shallow
   single-feature decision tree grown against the label
 * ``FillMissingWithMean``, ``OpScalarStandardScaler``
 * ``ScalerTransformer`` / ``DescalerTransformer`` — an invertible scaling
 * ``PercentileCalibrator`` — a score's training percentile bucket

Fits and scalar outputs are the JAX package's float64 numpy on the host;
bucket blocks reach the stage's device in one copy.  The tree
bucketizer bins the feature and grows its tree on the stage's device
through ``gbdt_kernels.grow_tree`` with a count channel, so every level's
histograms come from the ``seg_hist`` kernel at d = 1 on 2K + 1 channels.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.gbdt_kernels import (HistFn, apply_bins, grow_tree,
                                   quantile_bins, seg_level_hists)
from ..stages.base import (BinaryEstimator, BinaryModel, UnaryEstimator,
                           UnaryModel, UnaryTransformer)
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import OPNumeric, OPVector, Real, RealNN
from .vector_metadata import (NULL_INDICATOR, VectorColumnMetadata,
                              VectorMetadata)
from .vectorizers import _host_vec_column

__all__ = [
    "NumericBucketizer", "DecisionTreeNumericBucketizer",
    "FillMissingWithMean", "OpScalarStandardScaler", "ScalerTransformer",
    "DescalerTransformer", "PercentileCalibrator", "tree_split_points",
]


def _bucketize(vals: np.ndarray, mask: np.ndarray, splits: Sequence[float],
               parent: str, ptype: str, track_nulls: bool,
               track_invalid: bool, device) -> FeatureColumn:
    """One-hot bucket membership + optional out-of-bounds and null
    indicators."""
    splits = np.asarray(sorted(splits), np.float64)
    nb = len(splits) - 1
    idx = np.clip(np.searchsorted(splits, vals, side="right") - 1, 0, nb - 1)
    valid = mask & (vals >= splits[0]) & (vals <= splits[-1])
    parts = np.zeros((len(vals), nb), np.float32)
    parts[np.arange(len(vals))[valid], idx[valid]] = 1.0
    meta = [VectorColumnMetadata(parent, ptype, grouping=parent,
                                 indicator_value=f"{splits[i]}-{splits[i+1]}")
            for i in range(nb)]
    blocks = [parts]
    if track_invalid:
        blocks.append((mask & ~valid).astype(np.float32)[:, None])
        meta.append(VectorColumnMetadata(parent, ptype, grouping=parent,
                                         indicator_value="OutOfBounds"))
    if track_nulls:
        blocks.append((~mask).astype(np.float32)[:, None])
        meta.append(VectorColumnMetadata(parent, ptype, grouping=parent,
                                         indicator_value=NULL_INDICATOR))
    return _host_vec_column(np.concatenate(blocks, axis=1),
                            VectorMetadata(f"{parent}_buckets", meta), device)


class NumericBucketizer(UnaryTransformer):
    """Buckets between fixed, sorted split points."""

    input_types = (OPNumeric,)

    def __init__(self, split_points: Sequence[float],
                 track_nulls: bool = True, track_invalid: bool = False,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="numericBucketizer",
                         output_type=OPVector, uid=uid)
        if len(split_points) < 2 or list(split_points) != sorted(split_points):
            raise ValueError("split_points must be sorted with >= 2 entries")
        self.split_points = list(split_points)
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid
        self.device = device

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        f = self.input_features[0]
        vals = np.nan_to_num(np.asarray(col.values, np.float64))
        return _bucketize(vals, np.asarray(col.mask), self.split_points,
                          f.name, f.ftype.type_name(), self.track_nulls,
                          self.track_invalid, self.device)


class _BucketizerModel(BinaryModel):
    """The tree bucketizer's fitted stage: inputs (label, numeric)."""

    input_types = (OPNumeric, OPNumeric)
    label_input_positions = (0,)

    def __init__(self, split_points: List[float], track_nulls: bool = True,
                 track_invalid: bool = False, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="dtBucketizer", output_type=OPVector,
                         uid=uid)
        self.split_points = list(split_points)
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid
        self.device = device

    def transform_columns(self, label_col, col) -> FeatureColumn:
        f = self.input_features[1]
        vals = np.nan_to_num(np.asarray(col.values, np.float64))
        mask = np.asarray(col.mask)
        if len(self.split_points) < 2:      # the tree found no split
            meta = []
            block = np.zeros((len(vals), 0), np.float32)
            if self.track_nulls:
                block = (~mask).astype(np.float32)[:, None]
                meta = [VectorColumnMetadata(f.name, f.ftype.type_name(),
                                             grouping=f.name,
                                             indicator_value=NULL_INDICATOR)]
            return _host_vec_column(block,
                                    VectorMetadata(f"{f.name}_buckets", meta),
                                    self.device)
        return _bucketize(vals, mask, self.split_points, f.name,
                          f.ftype.type_name(), self.track_nulls,
                          self.track_invalid, self.device)


def tree_split_points(values: np.ndarray, label: np.ndarray, max_depth: int,
                      max_bins: int, min_info_gain: float,
                      min_instances: float, device=None,
                      hist_fn: HistFn = seg_level_hists) -> List[float]:
    """The finite bin edges at the thresholds a single-feature tree uses,
    ascending: the feature's ``max_bins`` quantile bins on ``device``, a
    tree of ``max_depth`` grown on one-hot class targets (K classes when
    there are at most 20, else K = 1 on the raw label) with a count
    channel (2K + 1 histogram channels, ``hist_fn`` building each level),
    information-gain gates ``min_info_gain`` and ``min_instances``, and
    mean leaves."""
    dev = resolve_device(device)
    X = torch.from_numpy(np.ascontiguousarray(values, np.float32)[:, None])
    X = X.to(dev)
    classes = np.unique(label)
    k = len(classes) if len(classes) <= 20 else 1
    if k > 1:
        Y = np.equal(label[:, None], classes[None, :]).astype(np.float32)
    else:
        Y = label[:, None].astype(np.float32)
    edges = quantile_bins(X, max_bins)
    binned = apply_bins(X, edges)
    G = torch.from_numpy(Y).to(dev)
    w = torch.ones(len(label), dtype=torch.float32, device=dev)
    H = w[:, None].expand(-1, G.shape[1])
    tree = grow_tree(binned, G, H, max_depth, max_bins, C=w, lam=1e-3,
                     min_info_gain=min_info_gain,
                     min_instances=min_instances, newton_leaf=False,
                     hist_fn=hist_fn)
    used = sorted({int(t) for t in tree.thresh.cpu().numpy()
                   if t < max_bins - 1})
    return [float(edges[0][b]) for b in used if np.isfinite(edges[0][b])]


class DecisionTreeNumericBucketizer(BinaryEstimator):
    """Supervised buckets: the split points (at most ``max_splits``) of a
    single-feature decision tree grown against the label on the rows
    where the feature is present, with infinite outer bounds.  Inputs
    (label, numeric)."""

    input_types = (OPNumeric, OPNumeric)
    label_input_positions = (0,)

    def __init__(self, max_splits: int = 16, max_depth: int = 4,
                 min_info_gain: float = 0.01, min_instances_per_node: int = 1,
                 track_nulls: bool = True, track_invalid: bool = False,
                 max_bins: int = 32, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="dtBucketizer", output_type=OPVector,
                         uid=uid)
        self.max_splits = max_splits
        self.max_depth = max_depth
        self.min_info_gain = min_info_gain
        self.min_instances_per_node = min_instances_per_node
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid
        self.max_bins = max_bins
        self.device = device

    def fit_columns(self, data: ColumnarDataset, label_col, col):
        mask = np.asarray(col.mask)
        x = np.asarray(col.values, np.float64)[mask]
        y = np.nan_to_num(np.asarray(label_col.values, np.float64))[mask]
        splits: List[float] = []
        if x.size >= 2 and np.unique(x).size > 1:
            splits = tree_split_points(
                x, y, self.max_depth, self.max_bins, self.min_info_gain,
                float(self.min_instances_per_node),
                self.device)[: self.max_splits]
        # infinite outer bounds: values past the training range land in
        # the first or last bucket
        points = [-np.inf] + splits + [np.inf] if splits else []
        self.metadata["summary"] = {"splits": points,
                                    "foundSplits": bool(splits)}
        return _BucketizerModel(points, self.track_nulls, self.track_invalid,
                                device=self.device)


class FillMissingWithMean(UnaryEstimator):
    """RealNN: missing values take the training mean (``default_value``
    when nothing is present)."""

    input_types = (OPNumeric,)

    def __init__(self, default_value: float = 0.0, uid: Optional[str] = None):
        super().__init__(operation_name="fillWithMean", output_type=RealNN,
                         uid=uid)
        self.default_value = default_value

    def fit_columns(self, data: ColumnarDataset, col: FeatureColumn):
        vals = np.asarray(col.values, np.float64)
        mask = np.asarray(col.mask)
        mean = float(vals[mask].mean()) if mask.any() else self.default_value
        return _FillModel(fill=mean)


class _FillModel(UnaryModel):
    input_types = (OPNumeric,)

    def __init__(self, fill: float, uid: Optional[str] = None):
        super().__init__(operation_name="fillWithMean", output_type=RealNN,
                         uid=uid)
        self.fill = fill

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        vals = np.nan_to_num(np.asarray(col.values, np.float64),
                             nan=self.fill)
        out = np.where(np.asarray(col.mask), vals, self.fill)
        return FeatureColumn(RealNN, out, np.ones(len(out), bool))


class OpScalarStandardScaler(UnaryEstimator):
    """The z-score of one numeric feature (population std; missing rows
    score 0)."""

    input_types = (OPNumeric,)

    def __init__(self, with_mean: bool = True, with_std: bool = True,
                 uid: Optional[str] = None):
        super().__init__(operation_name="stdScaler", output_type=RealNN,
                         uid=uid)
        self.with_mean = with_mean
        self.with_std = with_std

    def fit_columns(self, data: ColumnarDataset, col: FeatureColumn):
        vals = np.asarray(col.values, np.float64)
        mask = np.asarray(col.mask)
        mean = float(vals[mask].mean()) if mask.any() else 0.0
        std = float(vals[mask].std()) if mask.any() else 1.0
        return _ScalerModel(mean=mean if self.with_mean else 0.0,
                            scale=(std if std > 0 else 1.0)
                            if self.with_std else 1.0)


class _ScalerModel(UnaryModel):
    input_types = (OPNumeric,)

    def __init__(self, mean: float, scale: float, uid: Optional[str] = None):
        super().__init__(operation_name="stdScaler", output_type=RealNN,
                         uid=uid)
        self.mean = mean
        self.scale = scale

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        vals = np.nan_to_num(np.asarray(col.values, np.float64),
                             nan=self.mean)
        vals = np.where(np.asarray(col.mask), vals, self.mean)
        out = (vals - self.mean) / self.scale
        return FeatureColumn(RealNN, out, np.ones(len(out), bool))


_SCALERS = {
    "linear": (lambda v, a, b: a * v + b, lambda v, a, b: (v - b) / a),
    "log": (lambda v, a, b: np.log(np.maximum(v, 1e-12)),
            lambda v, a, b: np.exp(v)),
}


def _scaled(col: FeatureColumn, fn, slope: float,
            intercept: float) -> FeatureColumn:
    """``fn`` of the values; a non-finite result is missing (downstream
    vectorizers read NaN as masked)."""
    vals = np.asarray(col.values, np.float64)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        out = fn(vals, slope, intercept)
    mask = (np.isfinite(out) if col.mask is None
            else np.asarray(col.mask) & np.isfinite(out))
    return FeatureColumn(Real, out, mask)


class ScalerTransformer(UnaryTransformer):
    """A linear (``slope * v + intercept``) or log scaling, recorded in
    the stage's metadata so that ``DescalerTransformer`` can undo it."""

    input_types = (OPNumeric,)

    def __init__(self, scaling_type: str = "linear", slope: float = 1.0,
                 intercept: float = 0.0, uid: Optional[str] = None):
        super().__init__(operation_name="scaler", output_type=Real, uid=uid)
        if scaling_type not in _SCALERS:
            raise ValueError(f"unknown scaling_type {scaling_type!r}")
        self.scaling_type = scaling_type
        self.slope = slope
        self.intercept = intercept

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        self.metadata["scaler"] = {"type": self.scaling_type,
                                   "slope": self.slope,
                                   "intercept": self.intercept}
        return _scaled(col, _SCALERS[self.scaling_type][0], self.slope,
                       self.intercept)


class DescalerTransformer(BinaryModel):
    """The inverse of a ``ScalerTransformer``: inputs (scaled value, and
    optionally the scaled source)."""

    input_arity = (1, 2)

    def __init__(self, scaling_type: str = "linear", slope: float = 1.0,
                 intercept: float = 0.0, uid: Optional[str] = None):
        super().__init__(operation_name="descaler", output_type=Real, uid=uid)
        self.scaling_type = scaling_type
        self.slope = slope
        self.intercept = intercept

    def transform_columns(self, col: FeatureColumn, *_rest) -> FeatureColumn:
        return _scaled(col, _SCALERS[self.scaling_type][1], self.slope,
                       self.intercept)


class PercentileCalibrator(UnaryEstimator):
    """A score -> its training percentile bucket 0..buckets-1."""

    input_types = (OPNumeric,)

    def __init__(self, buckets: int = 100, uid: Optional[str] = None):
        super().__init__(operation_name="percentileCalibrator",
                         output_type=RealNN, uid=uid)
        self.buckets = buckets

    def fit_columns(self, data: ColumnarDataset, col: FeatureColumn):
        vals = np.asarray(col.values, np.float64)
        mask = np.asarray(col.mask)
        qs = np.linspace(0, 1, self.buckets + 1)[1:-1]
        splits = (np.quantile(vals[mask], qs) if mask.any()
                  else np.zeros(len(qs)))
        model = _PercentileModel(splits=list(map(float, splits)),
                                 buckets=self.buckets)
        self.metadata["summary"] = {"splits": model.splits}
        return model


class _PercentileModel(UnaryModel):
    input_types = (OPNumeric,)

    def __init__(self, splits: List[float], buckets: int = 100,
                 uid: Optional[str] = None):
        super().__init__(operation_name="percentileCalibrator",
                         output_type=RealNN, uid=uid)
        self.splits = list(splits)
        self.buckets = buckets

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        vals = np.nan_to_num(np.asarray(col.values, np.float64))
        out = np.searchsorted(np.asarray(self.splits), vals,
                              side="right").astype(np.float64)
        return FeatureColumn(RealNN, out, np.ones(len(out), bool))
