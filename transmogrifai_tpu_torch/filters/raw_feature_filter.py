"""RawFeatureFilter: workflow-level raw-feature QA before the DAG runs
(counterpart of ``transmogrifai_tpu.filters.raw_feature_filter``).

Profiles every raw predictor (and map key) of the training data and, when
given, of the scoring data, then drops the features whose training fill
rate is too low, whose train/score fill rates differ too much (absolute
difference or ratio), whose train/score distributions diverge
(Jensen-Shannon), or whose null indicator correlates with the label
(leakage).  The numeric columns are profiled in one batched pass on the
card (``profile_numeric_batch``); text and map columns on the host.
The decisions are a pure function of the profiles, as in the JAX
package.  Not ported: ``with_mesh`` (multi-device) and
``filter_streaming`` (chunked ingestion), ROADMAP Queue A item 6.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..types.columns import ColumnarDataset, FeatureColumn
from .feature_distribution import (NUMERIC_STORAGE, FeatureDistribution,
                                   profile_column, profile_numeric_batch)

__all__ = ["RawFeatureFilter", "RawFeatureFilterResults", "ExclusionReasons"]


@dataclasses.dataclass
class ExclusionReasons:
    """Why a feature (or map key) was, or was not, dropped."""
    name: str
    key: Optional[str]
    train_fill_rate: float
    low_fill: bool = False
    fill_difference: bool = False
    fill_ratio: bool = False
    js_divergence: bool = False
    null_label_leakage: bool = False

    @property
    def excluded(self) -> bool:
        return (self.low_fill or self.fill_difference or self.fill_ratio
                or self.js_divergence or self.null_label_leakage)

    def to_json(self) -> dict:
        return dataclasses.asdict(self) | {"excluded": self.excluded}


@dataclasses.dataclass
class RawFeatureFilterResults:
    """Config, distributions and decisions of one filter run."""
    config: Dict[str, Any]
    train_distributions: List[FeatureDistribution]
    score_distributions: List[FeatureDistribution]
    exclusion_reasons: List[ExclusionReasons]
    dropped_features: List[str]
    dropped_map_keys: Dict[str, List[str]]
    #: wall seconds of the profiles: numeric (the batched pass) and text
    #: (host); not part of the JSON form
    profile_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def to_json(self) -> dict:
        return {
            "config": self.config,
            "trainDistributions": [d.to_json() for d in self.train_distributions],
            "scoreDistributions": [d.to_json() for d in self.score_distributions],
            "exclusionReasons": [r.to_json() for r in self.exclusion_reasons],
            "droppedFeatures": self.dropped_features,
            "droppedMapKeys": self.dropped_map_keys,
        }


class RawFeatureFilter:
    def __init__(self,
                 min_fill_rate: float = 0.001,
                 max_fill_difference: float = 0.90,
                 max_fill_ratio_diff: float = 20.0,
                 max_js_divergence: float = 0.90,
                 max_correlation: float = 0.95,
                 protected_features: Sequence[str] = (),
                 js_divergence_protected_features: Sequence[str] = (),
                 scoring_data=None):
        if not 0.0 <= min_fill_rate <= 1.0:
            raise ValueError(f"invalid min_fill_rate {min_fill_rate}")
        if not 0.0 <= max_fill_difference <= 1.0:
            raise ValueError(f"invalid max_fill_difference {max_fill_difference}")
        if max_fill_ratio_diff < 0:
            raise ValueError(f"invalid max_fill_ratio_diff {max_fill_ratio_diff}")
        if not 0.0 <= max_js_divergence <= 1.0:
            raise ValueError(f"invalid max_js_divergence {max_js_divergence}")
        self.min_fill_rate = min_fill_rate
        self.max_fill_difference = max_fill_difference
        self.max_fill_ratio_diff = max_fill_ratio_diff
        self.max_js_divergence = max_js_divergence
        self.max_correlation = max_correlation
        self.protected_features: Set[str] = set(protected_features)
        self.js_protected: Set[str] = set(js_divergence_protected_features)
        self.scoring_data = scoring_data

    def with_mesh(self, mesh) -> "RawFeatureFilter":
        raise NotImplementedError(
            "RawFeatureFilter.with_mesh (multi-device profiles) is not "
            "ported yet (ROADMAP Queue A item 6, multi-device)")

    def filter_streaming(self, reader, raw_features, chunk_rows: int,
                         pod=None):
        raise NotImplementedError(
            "RawFeatureFilter.filter_streaming (chunked ingestion) is not "
            "ported yet (ROADMAP Queue A item 6, chunked ingestion)")

    # -- profiling ----------------------------------------------------------

    def _profiles(self, data: ColumnarDataset, names: Sequence[str],
                  label: Optional[np.ndarray], device,
                  seconds: Dict[str, float]) -> List[FeatureDistribution]:
        """Every present column's profiles in ``names`` order: the numeric
        ones in one batched pass on ``device``, the rest on the host."""
        present = [n for n in names if n in data]
        numeric = [n for n in present
                   if data[n].ftype.storage in NUMERIC_STORAGE]
        t0 = time.perf_counter()
        by_name = {n: [d] for n, d in zip(numeric, profile_numeric_batch(
            numeric, [data[n] for n in numeric], label,
            resolve_device(device)))}
        t1 = time.perf_counter()
        for n in present:
            if n not in by_name:
                by_name[n] = profile_column(n, data[n], label)
        seconds["numeric"] = seconds.get("numeric", 0.0) + t1 - t0
        seconds["text"] = (seconds.get("text", 0.0)
                           + time.perf_counter() - t1)
        return [d for n in present for d in by_name[n]]

    # -- decision + data cleaning ------------------------------------------

    def _decide(self, train_dists: List[FeatureDistribution],
                score_dists: List[FeatureDistribution]
                ) -> Tuple[List[ExclusionReasons], List[str],
                           Dict[str, List[str]]]:
        """Drop decisions as a pure function of the distributions."""
        score_by_key = {(d.name, d.key): d for d in score_dists}
        reasons: List[ExclusionReasons] = []
        for d in train_dists:
            r = ExclusionReasons(d.name, d.key, d.fill_rate())
            if d.name not in self.protected_features:
                r.low_fill = d.fill_rate() < self.min_fill_rate
                s = score_by_key.get((d.name, d.key))
                if s is not None and s.count > 0:
                    r.fill_difference = (d.relative_fill_rate(s)
                                         > self.max_fill_difference)
                    r.fill_ratio = (d.relative_fill_ratio(s)
                                    > self.max_fill_ratio_diff)
                    if d.name not in self.js_protected:
                        r.js_divergence = (d.js_divergence(s)
                                           > self.max_js_divergence)
                if d.has_label:
                    r.null_label_leakage = (abs(d.null_label_corr())
                                            > self.max_correlation)
            reasons.append(r)

        dropped_features: List[str] = []
        dropped_map_keys: Dict[str, List[str]] = {}
        by_feature: Dict[str, List[ExclusionReasons]] = {}
        for r in reasons:
            by_feature.setdefault(r.name, []).append(r)
        for name, rs in by_feature.items():
            keyed = [r for r in rs if r.key is not None]
            if keyed:
                bad = [r.key for r in keyed if r.excluded]
                if bad:
                    if len(bad) == len(keyed):
                        dropped_features.append(name)
                    else:
                        dropped_map_keys[name] = bad
            elif any(r.excluded for r in rs):
                dropped_features.append(name)
        return reasons, dropped_features, dropped_map_keys

    def _results(self, train_dists, score_dists, reasons, dropped_features,
                 dropped_map_keys) -> RawFeatureFilterResults:
        return RawFeatureFilterResults(
            config={
                "minFillRate": self.min_fill_rate,
                "maxFillDifference": self.max_fill_difference,
                "maxFillRatioDiff": self.max_fill_ratio_diff,
                "maxJSDivergence": self.max_js_divergence,
                "maxCorrelation": self.max_correlation,
            },
            train_distributions=train_dists,
            score_distributions=score_dists,
            exclusion_reasons=reasons,
            dropped_features=dropped_features,
            dropped_map_keys=dropped_map_keys,
        )

    def clean_chunk(self, data: ColumnarDataset,
                    dropped_features: Sequence[str],
                    dropped_map_keys: Dict[str, List[str]]
                    ) -> ColumnarDataset:
        """Apply drop decisions to a dataset: the dropped columns go, the
        dropped keys leave their maps (``data`` is not mutated)."""
        cleaned = data.drop([n for n in dropped_features if n in data])
        for name, keys in dropped_map_keys.items():
            if name not in cleaned:
                continue
            col = cleaned[name]
            bad = set(keys)
            vals = np.empty(len(col.values), dtype=object)
            for i, row in enumerate(col.values):
                vals[i] = {k: v for k, v in row.items() if k not in bad}
            cleaned = cleaned.with_columns({name: FeatureColumn(col.ftype,
                                                                vals)})
        return cleaned

    def filter_raw_data(self, data: ColumnarDataset, raw_features,
                        device: DeviceLike = None
                        ) -> Tuple[ColumnarDataset, RawFeatureFilterResults]:
        """Profile ``data`` (and the scoring data), decide, and return the
        cleaned data with the results.  The numeric profiles run on
        ``device`` (else the default device)."""
        predictors = [f for f in raw_features if not f.is_response]
        responses = [f for f in raw_features if f.is_response]
        pred_names = [f.name for f in predictors]

        label = None
        if responses and responses[0].name in data:
            label = np.nan_to_num(
                np.asarray(data[responses[0].name].values, np.float64))

        seconds: Dict[str, float] = {}
        train_dists = self._profiles(data, pred_names, label, device,
                                     seconds)
        score_dists: List[FeatureDistribution] = []
        if self.scoring_data is not None:
            from ..readers.base import reader_for

            score_data = reader_for(self.scoring_data).generate_dataset(
                predictors)
            score_dists = self._profiles(score_data, pred_names, None,
                                         device, seconds)

        reasons, dropped_features, dropped_map_keys = self._decide(
            train_dists, score_dists)
        cleaned = self.clean_chunk(data, dropped_features, dropped_map_keys)
        results = self._results(train_dists, score_dists, reasons,
                                dropped_features, dropped_map_keys)
        results.profile_seconds = seconds
        return cleaned, results
