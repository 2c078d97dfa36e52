"""Default vectorizers of ``transmogrify()``.

Counterparts of ``transmogrifai_tpu.ops.vectorizers``:
 * ``RealVectorizer`` — fill missing reals with the mean + null-indicator slots
 * ``IntegralVectorizer`` — fill missing integrals with the mode (ties go
   to the smallest value) + null-indicator slots; its fitted stage is a
   ``RealVectorizerModel``, as in the JAX package
 * ``BinaryVectorizer`` — Binary -> {0, 1} with a fill + null indicators
 * ``OneHotVectorizer`` — TopK pivot of categorical text with OTHER and
   null-indicator slots
 * ``MultiPickListVectorizer`` — TopK multi-hot pivot of sets
 * ``TextHashingVectorizer`` — murmur3 hashing of tokenized text
 * ``SmartTextVectorizer`` — per text field, pivot, hash or ignore by its
   cardinality and fill rate (``TextStats``)
 * ``VectorsCombiner`` — concatenates OPVectors and merges their metadata

Fits run on the host over the raw numpy columns (the same float64
arithmetic and the same counting order as the JAX package, so fill
values, vocabularies, strategies and bucket ids match exactly).
Transforms emit the (N, D) float32 matrix as a tensor on the stage's
device; the blocks of the host-built vectorizers are made as one host
array and moved in one copy.  The pivots (OneHot, MultiPickList and
SmartText's pivoted fields and null indicators) are made by one
function, ``pivot_block``: the host computes only the int32 (row,
column) indices of the ones, and the device scatters them into a zeroed
block, bitwise the host-built block (``pivot_block_host``).  A raw ``OPVector`` column
(a host array) moves to the device once, where it enters a device stage
(``device.device_vector``).

Every fit also leaves ``metadata["drift_baseline"]``: {raw feature name:
baseline}, the train-side distribution a serving ``DriftMonitor``
(``serving/drift.py``) compares traffic with.  A numeric baseline holds
the Welford moments and a ``_BASELINE_BINS``-bin histogram (the in-core
fit's on a stride sample of at most about ``_BASELINE_SAMPLE`` values,
built on the stage's device by ``batched_histograms``, bin for bin the
JAX package's numpy histogram), a categorical one the top
``_BASELINE_CATEGORIES`` counts; both equal the JAX package's bit for
bit.  The fills, vocabularies and strategies also stream
(``begin_fit``..``finish_fit``): Welford moments for the reals, merged
value counts for the integrals, ``TopKSketch`` for the pivots and merged
``TextStats`` for SmartText, equal to the in-core fit (exactly, the
reals' means within ``streaming_fit_tol``).
"""
from __future__ import annotations

import itertools
import os
import re
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import device_vector, resolve_device
from ..stages.base import SequenceEstimator, SequenceModel, SequenceTransformer
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import OPNumeric, OPSet, OPVector, Text
from ..utils.hashing import murmur3_32
from ..utils.sketches import TopKSketch, WelfordMoments
from ..utils.streaming_histogram import StreamingHistogram, batched_histograms
from .vector_metadata import (
    NULL_INDICATOR, OTHER_INDICATOR, VectorColumnMetadata, VectorMetadata,
)

__all__ = ["pivot_block", "pivot_block_host",
           "RealVectorizer", "RealVectorizerModel", "IntegralVectorizer",
           "BinaryVectorizer", "OneHotVectorizer", "OneHotVectorizerModel",
           "MultiPickListVectorizer", "MultiPickListVectorizerModel",
           "TextHashingVectorizer", "TextStats", "SmartTextVectorizer",
           "SmartTextVectorizerModel", "VectorsCombiner"]


def _vec_column(mat: torch.Tensor, meta: VectorMetadata) -> FeatureColumn:
    return FeatureColumn(OPVector, mat, vmeta=meta)


def _host_vec_column(arr: np.ndarray, meta: VectorMetadata,
                     device) -> FeatureColumn:
    """A host-built block as float32 on the stage's device: one copy."""
    block = np.ascontiguousarray(arr, dtype=np.float32)
    return _vec_column(torch.from_numpy(block).to(resolve_device(device)),
                       meta)


def pivot_block(n: int, width: int, rows: np.ndarray, cols: np.ndarray,
                device=None) -> torch.Tensor:
    """The (n, width) float32 block with a one at each (``rows[i]``,
    ``cols[i]``) and zeros elsewhere, built on ``device``: the indices
    cross as one int32 copy and the device scatters them into a zeroed
    block (a repeated index is one one)."""
    dev = resolve_device(device)
    out = torch.zeros((n, width), dtype=torch.float32, device=dev)
    if len(rows):
        idx = torch.from_numpy(np.stack([np.asarray(rows, np.int32),
                                         np.asarray(cols, np.int32)]))
        idx = idx.to(dev).to(torch.int64)
        out.view(-1).index_fill_(0, idx[0] * width + idx[1], 1.0)
    return out


def pivot_block_host(n: int, width: int, rows: np.ndarray,
                     cols: np.ndarray) -> np.ndarray:
    """``pivot_block``'s block built on the host (the reference)."""
    out = np.zeros((n, width), dtype=np.float32)
    out[np.asarray(rows, np.intp), np.asarray(cols, np.intp)] = 1.0
    return out


def _slot_ones(slot: np.ndarray, offset: int) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    """(rows, columns) of the ones of a one-slot-a-row pivot: the rows
    whose slot is not -1, at ``offset`` + their slot."""
    rows = np.flatnonzero(slot >= 0)
    return rows, offset + slot[rows]


# ---------------------------------------------------------------------------
# Drift baselines
# ---------------------------------------------------------------------------

#: histogram bins of a numeric baseline (the PSI grid's source)
_BASELINE_BINS = 32
#: stride-sample cap of the in-core baseline histogram (the moments are
#: exact: the histogram needs only the distribution's shape)
_BASELINE_SAMPLE = 65536
#: categories a categorical baseline keeps (the rest count as OTHER)
_BASELINE_CATEGORIES = 64
#: columns a ``batched_histograms`` call takes at once (512 columns of
#: 65 536 samples: about 2 GB of device scratch)
_BASELINE_COLS_PER_PASS = 512


def _numeric_baseline(mom: WelfordMoments, hist: StreamingHistogram
                      ) -> Dict[str, Any]:
    """A numeric baseline from moments and a histogram (ndarrays, which
    persistence keeps bit for bit in ``arrays.npz``)."""
    empty = mom.mean is None
    return {
        "kind": "numeric", "n": float(mom.n),
        "mean": 0.0 if empty else float(mom.mean),
        "m2": 0.0 if empty else float(mom.m2),
        "min": 0.0 if empty else float(mom.min),
        "max": 0.0 if empty else float(mom.max),
        "histCentroids": np.asarray(hist.centroids, np.float64),
        "histCounts": np.asarray(hist.counts, np.float64),
    }


def _categorical_baseline(values, counts, total) -> Dict[str, Any]:
    return {"kind": "categorical", "n": float(total),
            "values": [str(v) for v in values],
            "counts": np.asarray(counts, np.float64)}


def _baseline_sample(present: np.ndarray) -> np.ndarray:
    """The in-core histogram's stride sample of a column's values."""
    return present[::max(1, len(present) // _BASELINE_SAMPLE)]


def _sample_histograms(samples: Sequence[np.ndarray], device
                       ) -> List[StreamingHistogram]:
    """``StreamingHistogram(_BASELINE_BINS).update(sample)`` of every
    sample, built ``_BASELINE_COLS_PER_PASS`` columns a pass on
    ``device``; the same bins as the host histogram."""
    out: List[StreamingHistogram] = []
    dev = resolve_device(device)
    step = _BASELINE_COLS_PER_PASS
    for a in range(0, len(samples), step):
        group = samples[a:a + step]
        width = max(len(v) for v in group)
        if width == 0:
            out += [StreamingHistogram(_BASELINE_BINS) for _ in group]
            continue
        X = np.zeros((len(group), width), np.float64)
        M = np.zeros((len(group), width), bool)
        for j, v in enumerate(group):
            X[j, :len(v)] = v
            M[j, :len(v)] = True
        C, N, L = batched_histograms(torch.from_numpy(X).to(dev),
                                     torch.from_numpy(M).to(dev),
                                     _BASELINE_BINS)
        C, N, L = C.cpu().numpy(), N.cpu().numpy(), L.cpu().numpy()
        out += [StreamingHistogram.from_bins(C[j, :L[j]], N[j, :L[j]],
                                             _BASELINE_BINS)
                for j in range(len(group))]
    return out


def _numeric_baseline_from_counts(counts: Dict[float, int]
                                  ) -> Dict[str, Any]:
    """An exact numeric baseline from a value -> count map (the integral
    vectorizer's mode counts)."""
    if not counts:
        return _numeric_baseline(WelfordMoments(),
                                 StreamingHistogram(_BASELINE_BINS))
    v = np.asarray(list(counts.keys()), np.float64)
    c = np.asarray(list(counts.values()), np.float64)
    n = float(c.sum())
    mean = float((v * c).sum() / n)
    hist = StreamingHistogram.from_value_counts(v, c, _BASELINE_BINS)
    return {
        "kind": "numeric", "n": n, "mean": mean,
        "m2": float((c * (v - mean) ** 2).sum()),
        "min": float(v.min()), "max": float(v.max()),
        "histCentroids": np.asarray(hist.centroids, np.float64),
        "histCounts": np.asarray(hist.counts, np.float64),
    }


def _categorical_baseline_from_sketch(sk: TopKSketch) -> Dict[str, Any]:
    """The top categories of a ``TopKSketch`` by (count, first seen)."""
    ordered = sorted(sk.counts.items(),
                     key=lambda kv: (-kv[1][0], kv[1][1]))
    top = ordered[:_BASELINE_CATEGORIES]
    return _categorical_baseline([k for k, _ in top],
                                 [ent[0] for _, ent in top], sk.offset)


def _pivot_fit(values, top_k: int, min_support: int):
    """(TopK pivot vocabulary, categorical baseline) from one ``np.unique``
    pass: ``Counter.most_common(top_k)`` order (ties by first occurrence),
    keeping values seen at least ``min_support`` times."""
    arr = np.asarray(values, dtype=object)
    total = int(arr.size)
    if total == 0:
        return [], _categorical_baseline([], [], 0)
    try:
        uniq, first, cnt = np.unique(arr, return_index=True,
                                     return_counts=True)
    except TypeError:  # non-comparable mix
        counts = Counter(arr.tolist())
        top = counts.most_common(_BASELINE_CATEGORIES)
        return ([v for v, n in counts.most_common(top_k) if n >= min_support],
                _categorical_baseline([v for v, _ in top],
                                      [n for _, n in top], total))
    order = np.lexsort((first, -cnt))
    keep = order[:_BASELINE_CATEGORIES]
    return ([uniq[i] for i in order[:top_k] if cnt[i] >= min_support],
            _categorical_baseline(uniq[keep], cnt[keep], total))


def _host_map(fn: Callable, items: Sequence) -> List:
    """``[fn(x) for x in items]`` on a pool of host threads (numpy drops
    the GIL in its loops; the results are those of the serial loop)."""
    workers = min(len(items), os.cpu_count() or 1, 8)
    if workers <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(fn, items))


def _cat_ints(parts: List[np.ndarray]) -> np.ndarray:
    return (np.concatenate(parts).astype(np.int32) if parts
            else np.zeros(0, np.int32))


def _present(c: FeatureColumn) -> np.ndarray:
    return np.nan_to_num(np.asarray(c.values, np.float64))[
        np.asarray(c.mask)]


class RealVectorizer(SequenceEstimator):
    """Fill missing reals (mean or constant) + optional null-indicator slots.
    The streaming fit's Welford means match the in-core means within
    about 1e-12 relative (chunked float64 sums in another order).
    ``fit_seconds`` splits the last in-core fit into ``moments_s`` (the
    fills and the exact moments, on host threads) and ``histograms_s``
    (the baselines' histograms on the stage's device)."""

    input_types = (OPNumeric,)
    supports_streaming_fit = True
    streaming_order_insensitive = True

    def __init__(self, fill_with_mean: bool = True, fill_value: float = 0.0,
                 track_nulls: bool = True, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="vecReal", output_type=OPVector,
                         uid=uid)
        self.fill_with_mean = fill_with_mean
        self.fill_value = fill_value
        self.track_nulls = track_nulls
        self.device = device
        self.fit_seconds: Dict[str, float] = {}

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        def one(c):
            present = _present(c)
            return WelfordMoments().update(present), _baseline_sample(present)

        t0 = time.perf_counter()
        fitted = _host_map(one, cols)
        t1 = time.perf_counter()
        hists = _sample_histograms([s for _, s in fitted], self.device)
        self.fit_seconds = {"moments_s": t1 - t0,
                            "histograms_s": time.perf_counter() - t1}
        self.metadata["drift_baseline"] = {
            f.name: _numeric_baseline(mom, h)
            for f, (mom, _), h in zip(self.input_features, fitted, hists)}
        return self._model([mom for mom, _ in fitted])

    def _model(self, moms: List[WelfordMoments]) -> "RealVectorizerModel":
        fills = [float(m.mean) if self.fill_with_mean and m.n > 0
                 else float(self.fill_value) for m in moms]
        return RealVectorizerModel(fills=fills, track_nulls=self.track_nulls,
                                   device=self.device)

    def begin_fit(self):
        return [{"mom": WelfordMoments(),
                 "hist": StreamingHistogram(_BASELINE_BINS)}
                for _ in self.input_features]

    def update_chunk(self, state, data, *cols):
        for st, c in zip(state, cols):
            present = _present(c)
            st["mom"].update(present)
            st["hist"].update(present)
        return state

    def merge_states(self, a, b):
        return [{"mom": sa["mom"].merge(sb["mom"]),
                 "hist": sa["hist"].merge(sb["hist"])}
                for sa, sb in zip(a, b)]

    def finish_fit(self, state):
        self.metadata["drift_baseline"] = {
            f.name: _numeric_baseline(st["mom"], st["hist"])
            for f, st in zip(self.input_features, state)}
        return self._model([st["mom"] for st in state])


class RealVectorizerModel(SequenceModel):
    input_types = (OPNumeric,)

    def __init__(self, fills: List[float], track_nulls: bool = True,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="vecReal", output_type=OPVector,
                         uid=uid)
        self.fills = fills
        self.track_nulls = track_nulls
        self.device = device

    #: elements of the block of columns stacked on the host and filled on
    #: the device at once: a single-row request fills every column in one
    #: pass, a large matrix in blocks of columns
    _BLOCK_ELEMS = 1 << 24

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        dev = resolve_device(self.device)
        n, k = len(cols[0]), len(cols)
        step = 2 if self.track_nulls else 1
        out = torch.empty((n, k * step), dtype=torch.float32, device=dev)
        fills = torch.from_numpy(np.asarray(self.fills, np.float32)).to(dev)
        per = max(1, self._BLOCK_ELEMS // max(n, 1))
        # a block is gathered column by column into contiguous host rows
        # (a column-interleaved stack costs ~4x the copy) and turned to
        # (rows, columns) on the device; each copy to the device is
        # synchronous, so the buffers serve the next block
        vals_h = np.empty((min(per, k), n), np.float32)
        mask_h = np.empty((min(per, k), n), bool)
        for lo in range(0, k, per):
            blk = cols[lo:lo + per]
            hi = lo + len(blk)
            for i, c in enumerate(blk):
                vals_h[i] = c.values
                mask_h[i] = c.mask
            vals = torch.from_numpy(vals_h[:len(blk)]).to(dev).T
            m = torch.from_numpy(mask_h[:len(blk)]).to(dev).T
            # non-finite survivors: NaN -> 0, inf -> the float32 extremes
            out[:, lo * step:hi * step:step] = torch.nan_to_num(
                torch.where(m, vals, fills[lo:hi]))
            if self.track_nulls:
                out[:, lo * step + 1:hi * step:step] = (~m).to(torch.float32)
        meta = []
        for f in self.input_features:
            meta.append(VectorColumnMetadata(f.name, f.ftype.type_name()))
            if self.track_nulls:
                meta.append(VectorColumnMetadata(
                    f.name, f.ftype.type_name(),
                    indicator_value=NULL_INDICATOR))
        return _vec_column(out, VectorMetadata(self.get_output().name, meta))


class IntegralVectorizer(SequenceEstimator):
    """Fill missing integrals with the mode (``fill_value`` for a column
    with no value, or for every column with ``fill_with_mode=False``) +
    optional null-indicator slots.  The streaming fit merges exact value
    counts: the same modes (ties to the smallest value)."""

    input_types = (OPNumeric,)
    supports_streaming_fit = True
    streaming_order_insensitive = True

    def __init__(self, fill_with_mode: bool = True, fill_value: int = 0,
                 track_nulls: bool = True, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="vecIntegral", output_type=OPVector,
                         uid=uid)
        self.fill_with_mode = fill_with_mode
        self.fill_value = fill_value
        self.track_nulls = track_nulls
        self.device = device

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        return self.finish_fit(self.update_chunk(self.begin_fit(), data,
                                                 *cols))

    def begin_fit(self):
        return [dict() for _ in self.input_features]

    def update_chunk(self, state, data, *cols):
        for counts, c in zip(state, cols):
            vals = np.asarray(c.values)[np.asarray(c.mask)]
            if len(vals):
                uniq, cnt = np.unique(vals, return_counts=True)
                for v, n in zip(uniq, cnt):
                    counts[float(v)] = counts.get(float(v), 0) + int(n)
        return state

    def merge_states(self, a, b):
        for ca, cb in zip(a, b):
            for v, n in cb.items():
                ca[v] = ca.get(v, 0) + n
        return a

    def finish_fit(self, state):
        # the highest count, ties to the smallest value (the in-core
        # argmax over ascending unique values)
        fills = [float(max(counts.items(), key=lambda kv: (kv[1], -kv[0]))[0])
                 if counts and self.fill_with_mode
                 else float(self.fill_value) for counts in state]
        self.metadata["drift_baseline"] = {
            f.name: _numeric_baseline_from_counts(counts)
            for f, counts in zip(self.input_features, state)}
        return RealVectorizerModel(fills=fills, track_nulls=self.track_nulls,
                                   device=self.device)


class BinaryVectorizer(SequenceTransformer):
    """Binary -> {0, 1} with ``fill_value`` for missing values + optional
    null-indicator slots (stateless)."""

    input_types = (OPNumeric,)

    def __init__(self, fill_value: bool = False, track_nulls: bool = True,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="vecBinary", output_type=OPVector,
                         uid=uid)
        self.fill_value = fill_value
        self.track_nulls = track_nulls
        self.device = device

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        parts, meta = [], []
        for f, c in zip(self.input_features, cols):
            vals = np.nan_to_num(np.asarray(c.values, dtype=np.float64))
            m = np.asarray(c.mask)
            parts.append(np.where(m, vals, float(self.fill_value)))
            meta.append(VectorColumnMetadata(f.name, f.ftype.type_name()))
            if self.track_nulls:
                parts.append(~m)
                meta.append(VectorColumnMetadata(
                    f.name, f.ftype.type_name(),
                    indicator_value=NULL_INDICATOR))
        return _host_vec_column(np.stack(parts, axis=1),
                                VectorMetadata("binary_vec", meta),
                                self.device)


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

    supports_streaming_fit = True

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        fits = [_pivot_fit(c.values[np.not_equal(c.values, None)],
                           self.top_k, self.min_support) for c in cols]
        self.metadata["drift_baseline"] = {
            f.name: base for f, (_, base) in zip(self.input_features, fits)}
        return self._model([vocab for vocab, _ in fits])

    def _model(self, vocabs) -> "OneHotVectorizerModel":
        return OneHotVectorizerModel(
            vocabs=vocabs, track_nulls=self.track_nulls,
            unseen_to_other=self.unseen_to_other, device=self.device)

    def begin_fit(self):
        return [TopKSketch() for _ in self.input_features]

    def update_chunk(self, state, data, *cols):
        for sk, c in zip(state, cols):
            sk.add_chunk(c.values[np.not_equal(c.values, None)])
        return state

    def merge_states(self, a, b):
        return [sa.merge(sb) for sa, sb in zip(a, b)]

    def finish_fit(self, state):
        self.metadata["drift_baseline"] = {
            f.name: _categorical_baseline_from_sketch(sk)
            for f, sk in zip(self.input_features, state)}
        return self._model([sk.top_k(self.top_k, self.min_support)
                            for sk in state])


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

    def pivot_ones(self, *cols: FeatureColumn):
        """(rows, width, row indices, column indices) of the block's ones:
        one slot a row and field (-1, no one, for a missing value without
        a null column or an unseen one without OTHER)."""
        n = len(cols[0])
        rows, idx, off = [], [], 0
        for vocab, c in zip(self.vocabs, cols):
            index = {v: i for i, v in enumerate(vocab)}
            k = len(vocab)
            width = (k + (1 if self.unseen_to_other else 0)
                     + (1 if self.track_nulls else 0))
            slot = np.fromiter(
                ((width - 1 if self.track_nulls else -1) if v is None
                 else index.get(v, k if self.unseen_to_other else -1)
                 for v in c.values), dtype=np.int64, count=n)
            r, j = _slot_ones(slot, off)
            rows.append(r)
            idx.append(j)
            off += width
        return n, off, _cat_ints(rows), _cat_ints(idx)

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        meta = []
        for f, vocab in zip(self.input_features, self.vocabs):
            tname = f.ftype.type_name()
            names = list(vocab)
            if self.unseen_to_other:
                names.append(OTHER_INDICATOR)
            if self.track_nulls:
                names.append(NULL_INDICATOR)
            meta += [VectorColumnMetadata(f.name, tname, grouping=f.name,
                                          indicator_value=v) for v in names]
        out = pivot_block(*self.pivot_ones(*cols), device=self.device)
        return _vec_column(out, VectorMetadata("onehot_vec", meta))


class MultiPickListVectorizer(SequenceEstimator):
    """TopK multi-hot pivot of MultiPickList sets with OTHER + null
    indicator columns."""

    input_types = (OPSet,)

    def __init__(self, top_k: int = 20, min_support: int = 10,
                 track_nulls: bool = True, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="pivotSet", output_type=OPVector,
                         uid=uid)
        self.top_k = top_k
        self.min_support = min_support
        self.track_nulls = track_nulls
        self.device = device

    supports_streaming_fit = True

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        # the cells flattened in iteration order: the first occurrence
        # breaks count ties, as Counter.update over the sets would
        fits = [_pivot_fit([v for s in c.values for v in s], self.top_k,
                           self.min_support) for c in cols]
        self.metadata["drift_baseline"] = {
            f.name: base for f, (_, base) in zip(self.input_features, fits)}
        return self._model([vocab for vocab, _ in fits])

    def _model(self, vocabs) -> "MultiPickListVectorizerModel":
        return MultiPickListVectorizerModel(
            vocabs=vocabs, track_nulls=self.track_nulls, device=self.device)

    def begin_fit(self):
        return [TopKSketch() for _ in self.input_features]

    def update_chunk(self, state, data, *cols):
        for sk, c in zip(state, cols):
            sk.add_chunk([v for s in c.values for v in s])
        return state

    def merge_states(self, a, b):
        return [sa.merge(sb) for sa, sb in zip(a, b)]

    def finish_fit(self, state):
        self.metadata["drift_baseline"] = {
            f.name: _categorical_baseline_from_sketch(sk)
            for f, sk in zip(self.input_features, state)}
        return self._model([sk.top_k(self.top_k, self.min_support)
                            for sk in state])


class MultiPickListVectorizerModel(SequenceModel):
    input_types = (OPSet,)

    def __init__(self, vocabs: List[List[str]], track_nulls: bool = True,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="pivotSet", output_type=OPVector,
                         uid=uid)
        self.vocabs = vocabs
        self.track_nulls = track_nulls
        self.device = device

    def pivot_ones(self, *cols: FeatureColumn):
        """(rows, width, row indices, column indices) of the block's ones:
        each vocabulary value of a row's set, OTHER when none is, the
        null column (with ``track_nulls``) for an empty set."""
        n = len(cols[0])
        step = 1 + (1 if self.track_nulls else 0)
        rows: List[int] = []
        idx: List[int] = []
        off = 0
        for vocab, c in zip(self.vocabs, cols):
            index = {v: i for i, v in enumerate(vocab)}
            k = len(vocab)
            w = k + step
            for row, s in enumerate(c.values):
                if not s:
                    if self.track_nulls:
                        rows.append(row)
                        idx.append(off + w - 1)
                    continue
                hits = {index[v] for v in s if v in index}
                rows += [row] * max(len(hits), 1)
                idx += [off + j for j in hits] if hits else [off + k]
            off += w
        return (n, off, np.asarray(rows, np.int32),
                np.asarray(idx, np.int32))

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        meta = []
        for f, vocab in zip(self.input_features, self.vocabs):
            tname = f.ftype.type_name()
            names = list(vocab) + [OTHER_INDICATOR]
            if self.track_nulls:
                names.append(NULL_INDICATOR)
            meta += [VectorColumnMetadata(f.name, tname, grouping=f.name,
                                          indicator_value=v) for v in names]
        out = pivot_block(*self.pivot_ones(*cols), device=self.device)
        return _vec_column(out, VectorMetadata("set_vec", meta))


# ---------------------------------------------------------------------------
# Hashing
# ---------------------------------------------------------------------------

_TOKEN_SPLIT = re.compile(r"[^\w']+", re.UNICODE)


def _tokenize(v: Optional[str]) -> List[str]:
    """Lowercased word tokens of a text value (none for a missing one)."""
    if v is None:
        return []
    return [t for t in _TOKEN_SPLIT.split(v.lower()) if t]


def _row_tokens(v) -> List[str]:
    """Tokens of one cell: a string is word-tokenized; a collection cell
    (a list or set of any values, e.g. DateList epoch ints) hashes its
    elements' string forms."""
    if v is None:
        return []
    if isinstance(v, str):
        return _tokenize(v)
    return [str(t) for t in v]


def _hash_rows(values, block: np.ndarray, offset: int, nf: int, seed: int,
               binary_freq: bool = False) -> np.ndarray:
    """Add the token counts of one column into ``block[:, offset:offset +
    nf]`` (set them to 1 under ``binary_freq``); returns a bool array of
    the rows with no token.  Each distinct string is tokenized and hashed
    once; the counts land in one scatter-add (small integers, exact in
    float32), so the block equals a per-token ``+= 1`` loop's."""
    bucket_of: Dict[str, int] = {}
    by_value: Dict[str, List[int]] = {}

    def buckets(toks: List[str]) -> List[int]:
        out = []
        for t in toks:
            b = bucket_of.get(t)
            if b is None:
                b = bucket_of[t] = murmur3_32(t, seed) % nf
            out.append(b)
        return out

    per_row = []
    for v in values:
        if isinstance(v, str):
            bs = by_value.get(v)
            if bs is None:
                bs = by_value[v] = buckets(_tokenize(v))
        else:
            bs = buckets(_row_tokens(v))
        per_row.append(bs)
    n = len(per_row)
    lens = np.fromiter(map(len, per_row), dtype=np.int64, count=n)
    cols = np.fromiter(itertools.chain.from_iterable(per_row),
                       dtype=np.int64, count=int(lens.sum())) + offset
    rows = np.repeat(np.arange(n), lens)
    if binary_freq:
        block[rows, cols] = 1.0
    else:
        np.add.at(block, (rows, cols), np.float32(1.0))
    return lens == 0


class TextHashingVectorizer(SequenceTransformer):
    """Murmur3 feature hashing of tokenized text (stateless): 512 buckets
    a feature by default, or one bucket space shared by all inputs
    (``shared_hash_space``), + null indicators."""

    def __init__(self, num_features: int = 512, binary_freq: bool = False,
                 shared_hash_space: bool = False, track_nulls: bool = True,
                 seed: int = 42, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="textHash", output_type=OPVector,
                         uid=uid)
        self.num_features = num_features
        self.binary_freq = binary_freq
        self.shared_hash_space = shared_hash_space
        self.track_nulls = track_nulls
        self.seed = seed
        self.device = device

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        n = len(cols[0])
        nf = self.num_features
        n_spaces = 1 if self.shared_hash_space else len(cols)
        n_nulls = len(cols) if self.track_nulls else 0
        out = np.zeros((n, n_spaces * nf + n_nulls), dtype=np.float32)
        for ci, c in enumerate(cols):
            offset = 0 if self.shared_hash_space else ci * nf
            empty = _hash_rows(c.values, out, offset, nf, self.seed,
                               self.binary_freq)
            if self.track_nulls:
                out[:, n_spaces * nf + ci] = empty
        meta: List[VectorColumnMetadata] = []
        if self.shared_hash_space:
            pf = ",".join(f.name for f in self.input_features)
            meta += [VectorColumnMetadata(pf, "Text", grouping=None,
                                          descriptor_value=f"hash_{b}")
                     for b in range(nf)]
        else:
            meta += [VectorColumnMetadata(f.name, f.ftype.type_name(),
                                          descriptor_value=f"hash_{b}")
                     for f in self.input_features for b in range(nf)]
        if self.track_nulls:
            meta += [VectorColumnMetadata(f.name, f.ftype.type_name(),
                                          indicator_value=NULL_INDICATOR)
                     for f in self.input_features]
        return _host_vec_column(out, VectorMetadata("hash_vec", meta),
                                self.device)


# ---------------------------------------------------------------------------
# SmartTextVectorizer
# ---------------------------------------------------------------------------

class TextStats:
    """Text statistics of one field: value counts (until more than
    ``max_card`` distinct values are seen: saturated), value lengths,
    rows and nulls.  Counting stops at saturation and the ``Counter``'s
    insertion order breaks ``most_common`` ties, both as in the JAX
    package.  ``to_state``/``from_state`` are the checkpoint codec's
    hooks (``workflow/checkpoint.py``), key for key the JAX package's."""

    def __init__(self, max_card: int = 100):
        self.max_card = max_card
        self.value_counts: Counter = Counter()
        self.length_counts: Counter = Counter()
        self.n = 0
        self.n_null = 0
        self.saturated = False

    def update(self, v: Optional[str]):
        self.n += 1
        if v is None:
            self.n_null += 1
            return
        self.length_counts[len(v)] += 1
        if not self.saturated:
            self.value_counts[v] += 1
            if len(self.value_counts) > self.max_card:
                self.saturated = True

    @property
    def cardinality(self) -> int:
        return len(self.value_counts)

    def merge(self, other: "TextStats") -> "TextStats":
        """Monoid combine: ``Counter`` addition keeps the left side's
        first-occurrence order, then the right side's new values."""
        out = TextStats(self.max_card)
        out.value_counts = self.value_counts + other.value_counts
        out.length_counts = self.length_counts + other.length_counts
        out.n = self.n + other.n
        out.n_null = self.n_null + other.n_null
        out.saturated = (self.saturated or other.saturated
                         or len(out.value_counts) > out.max_card)
        return out

    def to_state(self) -> dict:
        """The counters as parallel ordered lists (their insertion order
        is the ``most_common`` tie order)."""
        return {"max_card": self.max_card,
                "values": list(self.value_counts.keys()),
                "value_ns": list(self.value_counts.values()),
                "lengths": list(self.length_counts.keys()),
                "length_ns": list(self.length_counts.values()),
                "n": self.n, "n_null": self.n_null,
                "saturated": self.saturated}

    @classmethod
    def from_state(cls, state: dict) -> "TextStats":
        out = cls(int(state["max_card"]))
        out.value_counts = Counter(dict(zip(state["values"],
                                            state["value_ns"])))
        out.length_counts = Counter(dict(zip(
            (int(k) for k in state["lengths"]), state["length_ns"])))
        out.n = int(state["n"])
        out.n_null = int(state["n_null"])
        out.saturated = bool(state["saturated"])
        return out

    def strategy(self, n_rows: int, min_fill_rate: float,
                 top_k: int, min_support: int) -> Tuple[str, List[str]]:
        """SmartText's rule for one field (or map key) of ``n_rows`` rows:
        ignore below ``min_fill_rate``, pivot on the top values while not
        saturated, hash otherwise; with the pivot's vocabulary."""
        if (self.n - self.n_null) / max(n_rows, 1) < min_fill_rate:
            return SmartTextVectorizer.IGNORE, []
        if not self.saturated and self.cardinality <= self.max_card:
            return SmartTextVectorizer.PIVOT, [
                v for v, cnt in self.value_counts.most_common(top_k)
                if cnt >= min_support]
        return SmartTextVectorizer.HASH, []


class SmartTextVectorizer(SequenceEstimator):
    """Per text field: a categorical pivot when its cardinality is at most
    ``max_cardinality``, murmur3 hashing when above it, nothing when its
    fill rate is below ``min_fill_rate``; + null indicators.
    ``metadata["text_strategies"]`` records the choice per field.  The
    streaming fit merges each chunk's ``TextStats`` left to right: the
    same strategies and vocabularies (a chunk that saturates makes the
    field hash in both paths).  ``auto_detect_languages`` is taken and
    recorded (``get_params``) and changes nothing: the JAX package stores
    it and reads it nowhere either."""

    input_types = (Text,)
    supports_streaming_fit = True

    PIVOT, HASH, IGNORE = "pivot", "hash", "ignore"

    def __init__(self, max_cardinality: int = 100, top_k: int = 20,
                 min_support: int = 10, num_hash_features: int = 512,
                 auto_detect_languages: bool = False,
                 min_fill_rate: float = 0.001, track_nulls: bool = True,
                 track_text_len: bool = False, seed: int = 42,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="smartTxtVec", output_type=OPVector,
                         uid=uid)
        self.max_cardinality = max_cardinality
        self.top_k = top_k
        self.min_support = min_support
        self.num_hash_features = num_hash_features
        self.auto_detect_languages = auto_detect_languages
        self.min_fill_rate = min_fill_rate
        self.track_nulls = track_nulls
        self.track_text_len = track_text_len
        self.seed = seed
        self.device = device
        #: seconds of the last fit's statistics pass (host)
        self.fit_seconds: Optional[float] = None

    def _stats(self, c: FeatureColumn) -> TextStats:
        stats = TextStats(self.max_cardinality)
        for v in c.values:
            stats.update(v)
        return stats

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        t0 = time.perf_counter()
        model = self._decide([self._stats(c) for c in cols])
        self.fit_seconds = time.perf_counter() - t0
        return model

    def begin_fit(self):
        return [TextStats(self.max_cardinality) for _ in self.input_features]

    def update_chunk(self, state, data, *cols):
        return [st.merge(self._stats(c)) for st, c in zip(state, cols)]

    def merge_states(self, a, b):
        return [sa.merge(sb) for sa, sb in zip(a, b)]

    def finish_fit(self, state):
        return self._decide(state)

    def _decide(self, stats_list: List[TextStats]
                ) -> "SmartTextVectorizerModel":
        """Strategy and vocabulary per field, and the categorical drift
        baseline of each unsaturated field (hashed text has no bounded
        category space)."""
        strategies, vocabs, baseline = [], [], {}
        for f, stats in zip(self.input_features, stats_list):
            strat, vocab = stats.strategy(stats.n, self.min_fill_rate,
                                          self.top_k, self.min_support)
            strategies.append(strat)
            vocabs.append(vocab)
            if not stats.saturated and stats.value_counts:
                top = stats.value_counts.most_common(_BASELINE_CATEGORIES)
                baseline[f.name] = _categorical_baseline(
                    [v for v, _ in top], [cnt for _, cnt in top],
                    stats.n - stats.n_null)
        self.metadata["text_strategies"] = dict(
            zip([f.name for f in self.input_features], strategies))
        self.metadata["drift_baseline"] = baseline
        return SmartTextVectorizerModel(
            strategies=strategies, vocabs=vocabs,
            num_hash_features=self.num_hash_features,
            track_nulls=self.track_nulls, track_text_len=self.track_text_len,
            seed=self.seed, device=self.device)


class SmartTextVectorizerModel(SequenceModel):
    input_types = (Text,)

    def __init__(self, strategies: List[str], vocabs: List[List[str]],
                 num_hash_features: int = 512, track_nulls: bool = True,
                 track_text_len: bool = False, seed: int = 42,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="smartTxtVec", output_type=OPVector,
                         uid=uid)
        self.strategies = strategies
        self.vocabs = vocabs
        self.num_hash_features = num_hash_features
        self.track_nulls = track_nulls
        self.track_text_len = track_text_len
        self.seed = seed
        self.device = device
        #: host seconds of the last transform: the pivot's indices (with
        #: the null indicators'), hashing (with the text lengths) and the
        #: block's build on the device
        self.transform_seconds: Dict[str, float] = {}

    def _widths(self) -> List[int]:
        extra = int(self.track_text_len) + int(self.track_nulls)
        return [extra + (0 if s == SmartTextVectorizer.IGNORE
                         else len(v) + 1 if s == SmartTextVectorizer.PIVOT
                         else self.num_hash_features)
                for s, v in zip(self.strategies, self.vocabs)]

    def pivot_ones(self, *cols: FeatureColumn):
        """(rows, width, row indices, column indices) of the block's ones:
        the pivoted fields' slots and the null indicators; the hashed
        fields' counts and the text lengths are not ones (``_dense``)."""
        n = len(cols[0])
        rows, idx = [], []
        off = 0
        for strat, vocab, c, w in zip(self.strategies, self.vocabs, cols,
                                      self._widths()):
            vals = c.values
            if strat == SmartTextVectorizer.PIVOT:
                index = {v: i for i, v in enumerate(vocab)}
                k = len(vocab)
                slot = np.fromiter((-1 if v is None else index.get(v, k)
                                    for v in vals), dtype=np.int64, count=n)
                r, j = _slot_ones(slot, off)
                rows.append(r)
                idx.append(j)
            if self.track_nulls:
                r = np.flatnonzero(np.equal(vals, None))
                rows.append(r)
                idx.append(np.full(len(r), off + w - 1, np.int64))
            off += w
        return n, off, _cat_ints(rows), _cat_ints(idx)

    def _dense(self, *cols: FeatureColumn):
        """[(first column, host block)] of the parts that are not ones:
        each hashed field's token counts and the text lengths."""
        n = len(cols[0])
        nf = self.num_hash_features
        parts = []
        off = 0
        for strat, vocab, c, w in zip(self.strategies, self.vocabs, cols,
                                      self._widths()):
            j = off
            if strat == SmartTextVectorizer.PIVOT:
                j += len(vocab) + 1
            elif strat == SmartTextVectorizer.HASH:
                block = np.zeros((n, nf), dtype=np.float32)
                _hash_rows(c.values, block, 0, nf, self.seed)
                parts.append((j, block))
                j += nf
            if self.track_text_len:
                parts.append((j, np.fromiter(
                    (0.0 if v is None else float(len(v)) for v in c.values),
                    dtype=np.float32, count=n)[:, None]))
            off += w
        return parts

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        nf = self.num_hash_features
        meta: List[VectorColumnMetadata] = []
        for f, strat, vocab in zip(self.input_features, self.strategies,
                                   self.vocabs):
            tname = f.ftype.type_name()
            if strat == SmartTextVectorizer.PIVOT:
                meta += [VectorColumnMetadata(f.name, tname, grouping=f.name,
                                              indicator_value=v)
                         for v in list(vocab) + [OTHER_INDICATOR]]
            elif strat == SmartTextVectorizer.HASH:
                meta += [VectorColumnMetadata(f.name, tname,
                                              descriptor_value=f"hash_{b}")
                         for b in range(nf)]
            if self.track_text_len:
                meta.append(VectorColumnMetadata(f.name, tname,
                                                 descriptor_value="textLen"))
            if self.track_nulls:
                meta.append(VectorColumnMetadata(
                    f.name, tname, grouping=f.name,
                    indicator_value=NULL_INDICATOR))
        t0 = time.perf_counter()
        ones = self.pivot_ones(*cols)
        t1 = time.perf_counter()
        dense = self._dense(*cols)
        t2 = time.perf_counter()
        out = pivot_block(*ones, device=self.device)
        for j, block in dense:
            out[:, j:j + block.shape[1]] = torch.from_numpy(block).to(
                out.device)
        self.transform_seconds = {"pivot_s": t1 - t0, "hash_s": t2 - t1,
                                  "copy_s": time.perf_counter() - t2}
        return _vec_column(out, VectorMetadata("smart_text_vec", meta))


# ---------------------------------------------------------------------------
# Combiner
# ---------------------------------------------------------------------------

class VectorsCombiner(SequenceTransformer):
    """Concatenate OPVector inputs + merge their metadata.  A raw vector
    input (a host array) is moved to the stage's device first."""

    input_types = (OPVector,)

    def __init__(self, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="combineVecs", output_type=OPVector,
                         uid=uid)
        self.device = device

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        metas = []
        for c, f in zip(cols, self.input_features):
            metas.append(c.vmeta if c.vmeta is not None else VectorMetadata(
                f.name, [VectorColumnMetadata(f.name, f.ftype.type_name(),
                                              descriptor_value=f"slot_{i}")
                         for i in range(c.values.shape[1])]))
        vm = VectorMetadata.flatten(self.get_output().name, metas)
        self.metadata["vector_metadata"] = vm.to_json()
        mats = [device_vector(c, self.device).values for c in cols]
        return _vec_column(torch.cat(mats, dim=1), vm)
