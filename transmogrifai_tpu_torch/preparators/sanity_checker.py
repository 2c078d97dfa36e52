"""SanityChecker — automated feature validation against the label.

Counterpart of ``transmogrifai_tpu.preparators.sanity_checker`` with the
same drop rules: low variance, label correlation above
``max_correlation`` (leakage) or below ``min_correlation``, and Cramér's V
of a categorical group above ``max_cramers_v``.  Statistics are device
reductions (``ops.stats``); the fitted model gathers the kept columns of
the device matrix.  Spearman correlation and the streaming fit are not
ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.stats import col_stats_with_label, cramers_v
from ..ops.vector_metadata import VectorMetadata
from ..stages.base import BinaryEstimator, BinaryModel
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import OPNumeric, OPVector

__all__ = ["SanityChecker", "SanityCheckerModel"]


def _label_tensor(label_col: FeatureColumn, dev) -> torch.Tensor:
    y = np.nan_to_num(np.asarray(label_col.values, dtype=np.float32))
    return torch.from_numpy(y).to(dev)


class SanityChecker(BinaryEstimator):
    """Inputs: (label RealNN, features OPVector) -> cleaned OPVector."""

    input_types = (OPNumeric, OPVector)

    def __init__(self, check_sample: float = 1.0, sample_seed: int = 42,
                 min_variance: float = 1e-5, min_correlation: float = 0.0,
                 max_correlation: float = 0.95, max_cramers_v: float = 0.95,
                 correlation_type: str = "pearson",
                 remove_bad_features: bool = True,
                 categorical_label: Optional[bool] = None,
                 max_label_classes: int = 100, uid: Optional[str] = None):
        super().__init__(operation_name="sanityCheck", output_type=OPVector,
                         uid=uid)
        if correlation_type != "pearson":
            raise NotImplementedError(
                "only Pearson correlation is ported (ROADMAP Queue A)")
        self.check_sample = check_sample
        self.sample_seed = sample_seed
        self.min_variance = min_variance
        self.min_correlation = min_correlation
        self.max_correlation = max_correlation
        self.max_cramers_v = max_cramers_v
        self.correlation_type = correlation_type
        self.remove_bad_features = remove_bad_features
        self.categorical_label = categorical_label
        self.max_label_classes = max_label_classes

    def fit_columns(self, data: ColumnarDataset, label_col: FeatureColumn,
                    features_col: FeatureColumn):
        X = features_col.values
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
        self.metadata["summary"] = {
            "correlationType": self.correlation_type,
            "sampleSize": float(n),
            "dropped": [names[j] for j in range(d) if to_drop[j]],
            "columnStats": [
                {"name": names[j], "mean": float(stats.mean[j]),
                 "variance": float(stats.variance[j]),
                 "min": float(stats.min[j]), "max": float(stats.max[j]),
                 "corr_label": float(stats.corr[j]),
                 "dropped": bool(to_drop[j]), "reasons": reasons[j]}
                for j in range(d)],
        }
        model = SanityCheckerModel(keep_indices=keep)
        model.new_vmeta = vmeta.select(keep) if vmeta.size == d else None
        return model


def _indicator_groups(vmeta: VectorMetadata
                      ) -> Dict[Tuple[str, Optional[str]], List[int]]:
    groups: Dict[Tuple[str, Optional[str]], List[int]] = {}
    for i, c in enumerate(vmeta.columns):
        if c.indicator_value is not None:
            groups.setdefault((c.parent_feature, c.grouping), []).append(i)
    return groups


class SanityCheckerModel(BinaryModel):
    """Index-filter on the feature vector."""

    input_types = (OPNumeric, OPVector)

    def __init__(self, keep_indices: List[int], uid: Optional[str] = None):
        super().__init__(operation_name="sanityCheck", output_type=OPVector,
                         uid=uid)
        self.keep_indices = list(keep_indices)
        self.new_vmeta: Optional[VectorMetadata] = None

    def transform_columns(self, label_col, features_col) -> FeatureColumn:
        X = features_col.values
        idx = torch.as_tensor(self.keep_indices, dtype=torch.long,
                              device=X.device)
        vmeta = self.new_vmeta
        if vmeta is None and features_col.vmeta is not None:
            vmeta = features_col.vmeta.select(self.keep_indices)
        return FeatureColumn(OPVector, X.index_select(1, idx).contiguous(),
                             vmeta=vmeta)
