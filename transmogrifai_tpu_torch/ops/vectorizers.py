"""Default vectorizers of ``transmogrify()`` for the ported types.

Counterparts of ``transmogrifai_tpu.ops.vectorizers``:
 * ``RealVectorizer`` — fill missing reals with the mean + null-indicator slots
 * ``OneHotVectorizer`` — TopK pivot of categorical text with OTHER and
   null-indicator slots
 * ``VectorsCombiner`` — concatenates OPVectors and merges their metadata

Fits run on the host over the raw numpy columns (the same float64
arithmetic as the JAX package, so fill values and vocabularies match
exactly).  Transforms emit the (N, D) float32 matrix as a tensor on the
stage's device.  Drift baselines and the streaming-fit protocol are not
ported yet.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..stages.base import SequenceEstimator, SequenceModel, SequenceTransformer
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import OPNumeric, OPVector, Text
from .vector_metadata import (
    NULL_INDICATOR, OTHER_INDICATOR, VectorColumnMetadata, VectorMetadata,
)

__all__ = ["RealVectorizer", "RealVectorizerModel", "OneHotVectorizer",
           "OneHotVectorizerModel", "VectorsCombiner"]


def _vec_column(mat: torch.Tensor, meta: VectorMetadata) -> FeatureColumn:
    return FeatureColumn(OPVector, mat, vmeta=meta)


def _pivot_vocab(values, top_k: int, min_support: int) -> List:
    """TopK pivot vocabulary: ``Counter.most_common(top_k)`` order (ties by
    first occurrence), keeping values seen at least ``min_support`` times."""
    arr = np.asarray(values, dtype=object)
    if arr.size == 0:
        return []
    try:
        uniq, first, cnt = np.unique(arr, return_index=True,
                                     return_counts=True)
    except TypeError:  # non-comparable mix
        counts = Counter(arr.tolist())
        return [v for v, n in counts.most_common(top_k) if n >= min_support]
    order = np.lexsort((first, -cnt))
    return [uniq[i] for i in order[:top_k] if cnt[i] >= min_support]


class RealVectorizer(SequenceEstimator):
    """Fill missing reals (mean or constant) + optional null-indicator slots."""

    input_types = (OPNumeric,)

    def __init__(self, fill_with_mean: bool = True, fill_value: float = 0.0,
                 track_nulls: bool = True, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="vecReal", output_type=OPVector,
                         uid=uid)
        self.fill_with_mean = fill_with_mean
        self.fill_value = fill_value
        self.track_nulls = track_nulls
        self.device = device

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        fills = []
        for c in cols:
            m = np.asarray(c.mask)
            present = np.nan_to_num(np.asarray(c.values, np.float64))[m]
            fills.append(float(present.mean())
                         if self.fill_with_mean and m.any()
                         else float(self.fill_value))
        return RealVectorizerModel(fills=fills, track_nulls=self.track_nulls,
                                   device=self.device)


class RealVectorizerModel(SequenceModel):
    input_types = (OPNumeric,)

    def __init__(self, fills: List[float], track_nulls: bool = True,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="vecReal", output_type=OPVector,
                         uid=uid)
        self.fills = fills
        self.track_nulls = track_nulls
        self.device = device

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        dev = resolve_device(self.device)
        n = len(cols[0])
        step = 2 if self.track_nulls else 1
        out = torch.empty((n, len(cols) * step), dtype=torch.float32,
                          device=dev)
        meta = []
        for j, (f, fill, c) in enumerate(zip(self.input_features, self.fills,
                                             cols)):
            vals = torch.from_numpy(np.asarray(c.values, np.float32)).to(dev)
            m = torch.from_numpy(np.asarray(c.mask, bool)).to(dev)
            row = torch.where(m, vals, float(np.float32(fill)))
            # non-finite survivors: NaN -> 0, inf -> the float32 extremes
            out[:, j * step] = torch.nan_to_num(row)
            meta.append(VectorColumnMetadata(f.name, f.ftype.type_name()))
            if self.track_nulls:
                out[:, j * step + 1] = (~m).to(torch.float32)
                meta.append(VectorColumnMetadata(
                    f.name, f.ftype.type_name(),
                    indicator_value=NULL_INDICATOR))
        return _vec_column(out, VectorMetadata(self.get_output().name, meta))


class OneHotVectorizer(SequenceEstimator):
    """TopK pivot of categorical text with OTHER + null indicator columns
    (defaults TopK=20, minSupport=10)."""

    input_types = (Text,)

    def __init__(self, top_k: int = 20, min_support: int = 10,
                 track_nulls: bool = True, unseen_to_other: bool = True,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="pivotText", output_type=OPVector,
                         uid=uid)
        self.top_k = top_k
        self.min_support = min_support
        self.track_nulls = track_nulls
        self.unseen_to_other = unseen_to_other
        self.device = device

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        vocabs = [_pivot_vocab(c.values[np.not_equal(c.values, None)],
                               self.top_k, self.min_support) for c in cols]
        return OneHotVectorizerModel(
            vocabs=vocabs, track_nulls=self.track_nulls,
            unseen_to_other=self.unseen_to_other, device=self.device)


class OneHotVectorizerModel(SequenceModel):
    input_types = (Text,)

    def __init__(self, vocabs: List[List[str]], track_nulls: bool = True,
                 unseen_to_other: bool = True, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="pivotText", output_type=OPVector,
                         uid=uid)
        self.vocabs = vocabs
        self.track_nulls = track_nulls
        self.unseen_to_other = unseen_to_other
        self.device = device

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        dev = resolve_device(self.device)
        n = len(cols[0])
        parts, meta = [], []
        for f, vocab, c in zip(self.input_features, self.vocabs, cols):
            index = {v: i for i, v in enumerate(vocab)}
            k = len(vocab)
            width = (k + (1 if self.unseen_to_other else 0)
                     + (1 if self.track_nulls else 0))
            # slot per row on the host (-1 = no slot), one-hot on the device
            slot = np.fromiter(
                ((width - 1 if self.track_nulls else -1) if v is None
                 else index.get(v, k if self.unseen_to_other else -1)
                 for v in c.values), dtype=np.int64, count=n)
            s = torch.from_numpy(slot).to(dev)
            block = (s[:, None] == torch.arange(width, device=dev)[None, :])
            parts.append(block.to(torch.float32))
            tname = f.ftype.type_name()
            names = list(vocab)
            if self.unseen_to_other:
                names.append(OTHER_INDICATOR)
            if self.track_nulls:
                names.append(NULL_INDICATOR)
            meta += [VectorColumnMetadata(f.name, tname, grouping=f.name,
                                          indicator_value=v) for v in names]
        out = (torch.cat(parts, dim=1) if parts
               else torch.zeros((n, 0), dtype=torch.float32, device=dev))
        return _vec_column(out, VectorMetadata("onehot_vec", meta))


class VectorsCombiner(SequenceTransformer):
    """Concatenate OPVector inputs + merge their metadata."""

    input_types = (OPVector,)

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="combineVecs", output_type=OPVector,
                         uid=uid)

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        metas = []
        for c, f in zip(cols, self.input_features):
            metas.append(c.vmeta if c.vmeta is not None else VectorMetadata(
                f.name, [VectorColumnMetadata(f.name, f.ftype.type_name(),
                                              descriptor_value=f"slot_{i}")
                         for i in range(c.values.shape[1])]))
        vm = VectorMetadata.flatten(self.get_output().name, metas)
        self.metadata["vector_metadata"] = vm.to_json()
        return _vec_column(torch.cat([c.values for c in cols], dim=1), vm)
