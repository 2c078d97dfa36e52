"""Map-typed feature vectorizers — the ``map`` group of ``transmogrify()``
(counterpart of ``transmogrifai_tpu.ops.map_vectorizers``).

A map feature holds {key -> value}; the fit discovers the key set and
each (map, key) pair becomes a column group
vectorized like its scalar value type, the key recorded as the slot's
``grouping``: numeric maps (fill + null indicator), pivoted text maps,
multi-pick-list maps, geolocation maps and SmartText maps (pivot, hash or
ignore per key).  Every estimator takes ``allow_keys`` (keep only these
keys) and ``block_keys`` (drop these); the kept keys are sorted, as in
the JAX package, which sets the column order.  The blocks are built on
the host with the JAX package's arithmetic and moved to the stage's
device in one copy.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..features.feature import Feature
from ..stages.base import SequenceEstimator, SequenceModel
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types import feature_types as ft
from ..types.feature_types import OPMap, OPVector
from ..utils.hashing import murmur3_32
from .vector_metadata import (
    NULL_INDICATOR, OTHER_INDICATOR, VectorColumnMetadata, VectorMetadata,
)
from .vectorizers import TextStats, _host_vec_column, _row_tokens

__all__ = ["NumericMapVectorizer", "NumericMapVectorizerModel",
           "TextMapPivotVectorizer", "TextMapPivotVectorizerModel",
           "MultiPickListMapVectorizer", "MultiPickListMapVectorizerModel",
           "SmartTextMapVectorizer", "SmartTextMapVectorizerModel",
           "GeoMapVectorizer", "GeoMapVectorizerModel",
           "GeolocationMapVectorizer", "GeolocationMapVectorizerModel",
           "transmogrify_map_group"]


def _key_filter(allow: Optional[Sequence[str]], block: Sequence[str]):
    """The key test of ``allow_keys``/``block_keys`` (an empty allow list
    allows every key, as in the JAX package)."""
    allow_set = set(allow) if allow else None
    block_set = set(block)
    return lambda k: k not in block_set and (allow_set is None
                                             or k in allow_set)


def _discover_keys(col: FeatureColumn, allow: Optional[Sequence[str]],
                   block: Sequence[str]) -> List[str]:
    ok = _key_filter(allow, block)
    return sorted(k for k in {k for m in col.values for k in m} if ok(k))


class NumericMapVectorizer(SequenceEstimator):
    """RealMap/IntegralMap/BinaryMap... -> per-key fill (the key's mean,
    or 0 with ``fill_with_mean=False``) + null indicators."""

    input_types = (OPMap,)

    def __init__(self, fill_with_mean: bool = True, track_nulls: bool = True,
                 allow_keys: Optional[List[str]] = None,
                 block_keys: Sequence[str] = (),
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="vecNumMap", output_type=OPVector,
                         uid=uid)
        self.device = device
        self.fill_with_mean = fill_with_mean
        self.track_nulls = track_nulls
        self.allow_keys = list(allow_keys) if allow_keys else None
        self.block_keys = list(block_keys)

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        keysets, fills = [], []
        for c in cols:
            keys = _discover_keys(c, self.allow_keys, self.block_keys)
            keysets.append(keys)
            kf = {}
            for k in keys:
                vals = [float(m[k]) for m in c.values
                        if k in m and m[k] is not None]
                kf[k] = (float(np.mean(vals))
                         if vals and self.fill_with_mean else 0.0)
            fills.append(kf)
        return NumericMapVectorizerModel(keysets=keysets, fills=fills,
                                         track_nulls=self.track_nulls,
                                         device=self.device)


class NumericMapVectorizerModel(SequenceModel):

    input_types = (OPMap,)
    def __init__(self, keysets: List[List[str]], fills: List[Dict[str, float]],
                 track_nulls: bool = True, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="vecNumMap", output_type=OPVector,
                         uid=uid)
        self.device = device
        self.keysets = keysets
        self.fills = fills
        self.track_nulls = track_nulls

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        n = len(cols[0])
        parts, meta = [], []
        for f, keys, kf, c in zip(self.input_features, self.keysets,
                                  self.fills, cols):
            tname = f.ftype.type_name()
            width = len(keys) * (2 if self.track_nulls else 1)
            block = np.zeros((n, width), dtype=np.float32)
            for j, k in enumerate(keys):
                base = j * (2 if self.track_nulls else 1)
                fill = kf.get(k, 0.0)
                for row, m in enumerate(c.values):
                    v = m.get(k)
                    if v is None:
                        block[row, base] = fill
                        if self.track_nulls:
                            block[row, base + 1] = 1.0
                    else:
                        block[row, base] = float(v)
                meta.append(VectorColumnMetadata(f.name, tname, grouping=k))
                if self.track_nulls:
                    meta.append(VectorColumnMetadata(
                        f.name, tname, grouping=k,
                        indicator_value=NULL_INDICATOR))
            parts.append(block)
        return _host_vec_column(np.concatenate(parts, axis=1) if parts
                                else np.zeros((n, 0), np.float32),
                                VectorMetadata("num_map_vec", meta),
                                self.device)


class TextMapPivotVectorizer(SequenceEstimator):
    """TextMap/PickListMap -> per-key TopK pivot with OTHER + null columns."""

    input_types = (OPMap,)

    def __init__(self, top_k: int = 20, min_support: int = 10,
                 track_nulls: bool = True,
                 allow_keys: Optional[List[str]] = None,
                 block_keys: Sequence[str] = (),
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="pivotTextMap",
                         output_type=OPVector, uid=uid)
        self.device = device
        self.top_k = top_k
        self.min_support = min_support
        self.track_nulls = track_nulls
        self.allow_keys = list(allow_keys) if allow_keys else None
        self.block_keys = list(block_keys)

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        keysets, vocabs = [], []
        for c in cols:
            keys = _discover_keys(c, self.allow_keys, self.block_keys)
            keysets.append(keys)
            kv = {}
            for k in keys:
                counts = Counter(
                    str(m[k]) for m in c.values if k in m and m[k] is not None
                )
                kv[k] = [v for v, cnt in counts.most_common(self.top_k)
                         if cnt >= self.min_support]
            vocabs.append(kv)
        return TextMapPivotVectorizerModel(keysets=keysets, vocabs=vocabs,
                                           track_nulls=self.track_nulls,
                                           device=self.device)


class TextMapPivotVectorizerModel(SequenceModel):

    input_types = (OPMap,)
    def __init__(self, keysets: List[List[str]],
                 vocabs: List[Dict[str, List[str]]],
                 track_nulls: bool = True, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="pivotTextMap",
                         output_type=OPVector, uid=uid)
        self.device = device
        self.keysets = keysets
        self.vocabs = vocabs
        self.track_nulls = track_nulls

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        n = len(cols[0])
        parts, meta = [], []
        for f, keys, kv, c in zip(self.input_features, self.keysets,
                                  self.vocabs, cols):
            tname = f.ftype.type_name()
            for k in keys:
                vocab = kv.get(k, [])
                index = {v: i for i, v in enumerate(vocab)}
                w = len(vocab) + 1 + (1 if self.track_nulls else 0)
                block = np.zeros((n, w), dtype=np.float32)
                for row, m in enumerate(c.values):
                    v = m.get(k)
                    if v is None:
                        if self.track_nulls:
                            block[row, w - 1] = 1.0
                    else:
                        j = index.get(str(v))
                        if j is None:
                            block[row, len(vocab)] = 1.0
                        else:
                            block[row, j] = 1.0
                parts.append(block)
                for v in vocab:
                    meta.append(VectorColumnMetadata(f.name, tname, grouping=k,
                                                     indicator_value=v))
                meta.append(VectorColumnMetadata(
                    f.name, tname, grouping=k,
                    indicator_value=OTHER_INDICATOR))
                if self.track_nulls:
                    meta.append(VectorColumnMetadata(
                        f.name, tname, grouping=k,
                        indicator_value=NULL_INDICATOR))
        return _host_vec_column(np.concatenate(parts, axis=1) if parts
                                else np.zeros((n, 0), np.float32),
                                VectorMetadata("text_map_vec", meta),
                                self.device)


class MultiPickListMapVectorizer(TextMapPivotVectorizer):
    """MultiPickListMap -> per-key multi-hot pivot."""

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        keysets, vocabs = [], []
        for c in cols:
            keys = _discover_keys(c, self.allow_keys, self.block_keys)
            keysets.append(keys)
            kv = {}
            for k in keys:
                counts: Counter = Counter()
                for m in c.values:
                    if k in m and m[k] is not None:
                        counts.update(str(x) for x in m[k])
                kv[k] = [v for v, cnt in counts.most_common(self.top_k)
                         if cnt >= self.min_support]
            vocabs.append(kv)
        return MultiPickListMapVectorizerModel(keysets=keysets, vocabs=vocabs,
                                               track_nulls=self.track_nulls,
                                               device=self.device)


class MultiPickListMapVectorizerModel(TextMapPivotVectorizerModel):
    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        n = len(cols[0])
        parts, meta = [], []
        for f, keys, kv, c in zip(self.input_features, self.keysets,
                                  self.vocabs, cols):
            tname = f.ftype.type_name()
            for k in keys:
                vocab = kv.get(k, [])
                index = {v: i for i, v in enumerate(vocab)}
                w = len(vocab) + 1 + (1 if self.track_nulls else 0)
                block = np.zeros((n, w), dtype=np.float32)
                for row, m in enumerate(c.values):
                    vs = m.get(k)
                    if not vs:
                        if self.track_nulls:
                            block[row, w - 1] = 1.0
                        continue
                    hit = False
                    for v in vs:
                        j = index.get(str(v))
                        if j is not None:
                            block[row, j] = 1.0
                            hit = True
                    if not hit:
                        block[row, len(vocab)] = 1.0
                parts.append(block)
                for v in vocab:
                    meta.append(VectorColumnMetadata(f.name, tname, grouping=k,
                                                     indicator_value=v))
                meta.append(VectorColumnMetadata(
                    f.name, tname, grouping=k,
                    indicator_value=OTHER_INDICATOR))
                if self.track_nulls:
                    meta.append(VectorColumnMetadata(
                        f.name, tname, grouping=k,
                        indicator_value=NULL_INDICATOR))
        return _host_vec_column(np.concatenate(parts, axis=1) if parts
                                else np.zeros((n, 0), np.float32),
                                VectorMetadata("mpl_map_vec", meta),
                                self.device)


_NUMERIC_MAPS = (ft.RealMap, ft.IntegralMap, ft.BinaryMap, ft.CurrencyMap,
                 ft.PercentMap, ft.DateMap, ft.DateTimeMap)


def transmogrify_map_group(feats: List[Feature], top_k: int, min_support: int,
                           num_hash_features: int,
                           track_nulls: bool) -> List[Feature]:
    """The map group's vectorizers, one per map family present."""
    numeric = [f for f in feats if issubclass(f.ftype, _NUMERIC_MAPS)]
    mpl = [f for f in feats if issubclass(f.ftype, ft.MultiPickListMap)]
    text = [f for f in feats
            if issubclass(f.ftype, ft.OPMap)
            and f not in numeric and f not in mpl
            and not issubclass(f.ftype, ft.GeolocationMap)]
    geo = [f for f in feats if issubclass(f.ftype, ft.GeolocationMap)]
    out: List[Feature] = []
    if numeric:
        s = NumericMapVectorizer(track_nulls=track_nulls)
        s.set_input(*numeric)
        out.append(s.get_output())
    if text:
        s = SmartTextMapVectorizer(top_k=top_k, min_support=min_support,
                                   num_hash_features=num_hash_features,
                                   track_nulls=track_nulls)
        s.set_input(*text)
        out.append(s.get_output())
    if mpl:
        s = MultiPickListMapVectorizer(top_k=top_k, min_support=min_support,
                                       track_nulls=track_nulls)
        s.set_input(*mpl)
        out.append(s.get_output())
    if geo:
        s = GeoMapVectorizer(track_nulls=track_nulls)
        s.set_input(*geo)
        out.append(s.get_output())
    return out


class GeoMapVectorizer(SequenceEstimator):
    """GeolocationMap -> per-key (lat, lon, accuracy) + null indicator."""

    input_types = (OPMap,)

    def __init__(self, track_nulls: bool = True,
                 allow_keys: Optional[List[str]] = None,
                 block_keys: Sequence[str] = (),
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="vecGeoMap", output_type=OPVector,
                         uid=uid)
        self.device = device
        self.track_nulls = track_nulls
        self.allow_keys = list(allow_keys) if allow_keys else None
        self.block_keys = list(block_keys)

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        keysets = [_discover_keys(c, self.allow_keys, self.block_keys)
                   for c in cols]
        return GeoMapVectorizerModel(keysets=keysets,
                                     track_nulls=self.track_nulls,
                                     device=self.device)


class GeoMapVectorizerModel(SequenceModel):

    input_types = (OPMap,)
    def __init__(self, keysets: List[List[str]], track_nulls: bool = True,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="vecGeoMap", output_type=OPVector,
                         uid=uid)
        self.device = device
        self.keysets = keysets
        self.track_nulls = track_nulls

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        n = len(cols[0])
        parts, meta = [], []
        for f, keys, c in zip(self.input_features, self.keysets, cols):
            tname = f.ftype.type_name()
            for k in keys:
                w = 3 + (1 if self.track_nulls else 0)
                block = np.zeros((n, w), dtype=np.float32)
                for row, m in enumerate(c.values):
                    v = m.get(k)
                    if v is None or len(v) != 3:
                        if self.track_nulls:
                            block[row, 3] = 1.0
                    else:
                        block[row, :3] = v
                parts.append(block)
                for d in ("lat", "lon", "accuracy"):
                    meta.append(VectorColumnMetadata(f.name, tname, grouping=k,
                                                     descriptor_value=d))
                if self.track_nulls:
                    meta.append(VectorColumnMetadata(
                        f.name, tname, grouping=k,
                        indicator_value=NULL_INDICATOR))
        return _host_vec_column(np.concatenate(parts, axis=1) if parts
                                else np.zeros((n, 0), np.float32),
                                VectorMetadata("geo_map_vec", meta),
                                self.device)


#: the reference's names (GeolocationMapVectorizer.scala)
GeolocationMapVectorizer = GeoMapVectorizer
GeolocationMapVectorizerModel = GeoMapVectorizerModel


# ---------------------------------------------------------------------------
# SmartTextMapVectorizer
# ---------------------------------------------------------------------------

class SmartTextMapVectorizer(SequenceEstimator):
    """Per-key cardinality-driven text strategy for TextMap-family features.

    Reference ``SmartTextMapVectorizer`` (core/.../impl/feature/
    SmartTextMapVectorizer.scala) — the map analogue of SmartTextVectorizer:
    computes ``TextStats`` per (map feature, key), then per key picks
    categorical pivot (cardinality <= max_cardinality), murmur3 hashing, or
    ignore (fill rate below min_fill_rate); emits per-key null indicators.
    """

    input_types = (OPMap,)

    PIVOT, HASH, IGNORE = "pivot", "hash", "ignore"

    def __init__(self, max_cardinality: int = 100, top_k: int = 20,
                 min_support: int = 10, num_hash_features: int = 512,
                 min_fill_rate: float = 0.001, track_nulls: bool = True,
                 seed: int = 42, allow_keys: Optional[List[str]] = None,
                 block_keys: Sequence[str] = (),
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="smartTxtMapVec",
                         output_type=OPVector, uid=uid)
        self.device = device
        self.max_cardinality = max_cardinality
        self.top_k = top_k
        self.min_support = min_support
        self.num_hash_features = num_hash_features
        self.min_fill_rate = min_fill_rate
        self.track_nulls = track_nulls
        self.seed = seed
        self.allow_keys = list(allow_keys) if allow_keys else None
        self.block_keys = list(block_keys)

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        keysets, strategies, vocabs = [], [], []
        key_ok = _key_filter(self.allow_keys, self.block_keys)
        for c in cols:
            # single pass: one TextStats per key encountered (present values
            # only; null counts derive from per-key presence vs row count)
            n = len(c)
            stats_by_key: Dict[str, TextStats] = {}
            for m in c.values:
                if not m:
                    continue
                for k, v in m.items():
                    if not key_ok(k):
                        continue
                    st = stats_by_key.get(k)
                    if st is None:
                        st = stats_by_key[k] = TextStats(self.max_cardinality)
                    st.update(None if v is None else str(v))
            keys = sorted(stats_by_key)
            keysets.append(keys)
            strat: Dict[str, str] = {}
            vocab: Dict[str, List[str]] = {}
            for k in keys:
                strat[k], vocab[k] = stats_by_key[k].strategy(
                    n, self.min_fill_rate, self.top_k, self.min_support)
            strategies.append(strat)
            vocabs.append(vocab)
        self.metadata["text_strategies"] = {
            f.name: s for f, s in zip(self.input_features, strategies)}
        return SmartTextMapVectorizerModel(
            keysets=keysets, strategies=strategies, vocabs=vocabs,
            num_hash_features=self.num_hash_features,
            track_nulls=self.track_nulls, seed=self.seed, device=self.device)


class SmartTextMapVectorizerModel(SequenceModel):

    input_types = (OPMap,)
    def __init__(self, keysets: List[List[str]],
                 strategies: List[Dict[str, str]],
                 vocabs: List[Dict[str, List[str]]],
                 num_hash_features: int = 512, track_nulls: bool = True,
                 seed: int = 42, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="smartTxtMapVec",
                         output_type=OPVector, uid=uid)
        self.device = device
        self.keysets = keysets
        self.strategies = strategies
        self.vocabs = vocabs
        self.num_hash_features = num_hash_features
        self.track_nulls = track_nulls
        self.seed = seed

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        n = len(cols[0])
        nf = self.num_hash_features
        blocks, meta = [], []
        for f, keys, strat, kv, c in zip(self.input_features, self.keysets,
                                         self.strategies, self.vocabs, cols):
            tname = f.ftype.type_name()
            # lay out the output block per key, then fill in ONE pass over the
            # rows (sparse maps touch only their present keys)
            layout: Dict[str, tuple] = {}   # key -> (strategy, offset, index)
            width = 0
            for k in keys:
                s = strat.get(k, SmartTextMapVectorizer.IGNORE)
                if s == SmartTextMapVectorizer.IGNORE:
                    continue
                if s == SmartTextMapVectorizer.PIVOT:
                    vocab = kv.get(k, [])
                    index = {v: i for i, v in enumerate(vocab)}
                    layout[k] = (s, width, index)
                    for v in vocab:
                        meta.append(VectorColumnMetadata(
                            f.name, tname, grouping=k, indicator_value=v))
                    meta.append(VectorColumnMetadata(
                        f.name, tname, grouping=k,
                        indicator_value=OTHER_INDICATOR))
                    width += len(vocab) + 1
                else:  # HASH
                    layout[k] = (s, width, None)
                    for b in range(nf):
                        meta.append(VectorColumnMetadata(
                            f.name, tname, grouping=k,
                            descriptor_value=f"hash_{b}"))
                    width += nf
                if self.track_nulls:
                    meta.append(VectorColumnMetadata(
                        f.name, tname, grouping=k,
                        indicator_value=NULL_INDICATOR))
                    # null indicator sits right after the key's value slots
                    layout[k] = (*layout[k][:2], layout[k][2], width)
                    width += 1
            block = np.zeros((n, width), dtype=np.float32)
            if self.track_nulls:
                for k, lay in layout.items():
                    block[:, lay[3]] = 1.0     # default null; cleared if seen
            hash_cache: Dict[str, int] = {}
            for row, m in enumerate(c.values):
                if not m:
                    continue
                for k, v in m.items():
                    lay = layout.get(k)
                    if lay is None or v is None:
                        continue
                    skind, off, index = lay[0], lay[1], lay[2]
                    if self.track_nulls:
                        block[row, lay[3]] = 0.0
                    sv = str(v)
                    if skind == SmartTextMapVectorizer.PIVOT:
                        j = index.get(sv)
                        j = len(index) if j is None else j
                        block[row, off + j] = 1.0
                    else:
                        for tok in _row_tokens(sv):
                            b = hash_cache.get(tok)
                            if b is None:
                                b = murmur3_32(tok, self.seed) % nf
                                hash_cache[tok] = b
                            block[row, off + b] += 1.0
            blocks.append(block)
        return _host_vec_column(np.concatenate(blocks, axis=1) if blocks
                                else np.zeros((n, 0), np.float32),
                                VectorMetadata("smart_text_map_vec", meta),
                                self.device)
