"""Aggregate / conditional / joined readers (counterpart of
``transmogrifai_tpu.readers.aggregates``, with no pandas: the join's
row indices come from a hash match that gives pandas' merge order).

Reference: ``AggregateDataReader``/``ConditionalDataReader`` run the monoid
aggregation of SURVEY §2.4 keyed by entity with response/predictor cutoffs
(readers/DataReader.scala:206-351); ``JoinedDataReader`` joins readers on
keys with inner/left/outer semantics plus post-join aggregation
(readers/JoinedDataReader.scala:119-223, readers/JoinTypes.scala); factory
catalogue ``DataReaders.{Simple,Aggregate,Conditional}``
(readers/DataReaders.scala:44-270).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..aggregators import (
    AGGREGATOR_REGISTRY, CutOffTime, default_aggregator,
)
from ..features.feature import Feature
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import ID
from .base import Reader

__all__ = ["AggregateDataReader", "ConditionalDataReader",
           "JoinedDataReader", "JoinedAggregateDataReader",
           "TimeBasedFilter"]


def _records_of(source) -> List[dict]:
    if hasattr(source, "to_dict"):          # a pandas frame
        return source.to_dict("records")
    if hasattr(source, "records"):          # AvroReader-like: lazy + cached
        return list(source.records)
    return list(source)


class AggregateDataReader(Reader):
    """Group records by entity key, monoid-aggregate each feature's events
    around a cutoff (DataReader.scala:206-278).

    Since the event-time ingestion algebra landed (readers/events.py) this
    class is a facade over the ONE streamed aggregation code path: every
    dataset generation — in-core or chunked — delegates to the equivalent
    :class:`~.events.StreamingAggregateReader`, whose full-range fold is
    asserted byte-identical to the historical in-core grouping
    (tests/test_events_streaming.py, tests/test_aggregators_readers.py).
    The streamed twin is cached so the key-scan pass (which also backs the
    EXACT ``estimate_rows``) runs once per reader, not once per call.
    """

    def __init__(self, source, key_fn: Callable[[dict], Any],
                 time_fn: Callable[[dict], int],
                 cutoff: Optional[CutOffTime] = None,
                 predictor_window_ms: Optional[int] = None,
                 response_window_ms: Optional[int] = None):
        self.source = source
        self.key_fn = key_fn
        self.time_fn = time_fn
        self.cutoff = cutoff or CutOffTime.no_cutoff()
        self.predictor_window_ms = predictor_window_ms
        self.response_window_ms = response_window_ms
        self._streamed = None

    def _streaming(self):
        from .events import streaming_view

        if self._streamed is None:
            self._streamed = streaming_view(self)
        # resilience can be attached after construction (with_resilience
        # returns self) — re-sync on every use so both views share ONE
        # config and therefore one dedup-ing quarantine sink
        self._streamed.resilience = self.resilience
        return self._streamed

    def generate_dataset(self, raw_features: Sequence[Feature]) -> ColumnarDataset:
        return self._streaming().generate_dataset(raw_features)

    def iter_chunks(self, raw_features: Sequence[Feature],
                    chunk_rows: int, host_range=None):
        """True streamed chunks (the fold buffers only in-window events of
        owned keys — never the record log); ``host_range`` slices the
        sorted KEY universe, the row grid of aggregate readers."""
        return self._streaming().iter_chunks(raw_features, chunk_rows,
                                             host_range=host_range)

    def estimate_rows(self) -> Optional[int]:
        """EXACT: one output row per distinct post-policy entity key
        (counted by the cached key scan)."""
        return self._streaming().estimate_rows()

    def estimate_rows_exact(self) -> bool:
        return True


class ConditionalDataReader(AggregateDataReader):
    """Entity cutoff = time of the first record matching ``target_condition``
    (DataReader.scala:280-351); entities with no match are dropped
    (drop_if_no_target)."""

    def __init__(self, source, key_fn, time_fn,
                 target_condition: Callable[[dict], bool],
                 drop_if_no_target: bool = True,
                 predictor_window_ms: Optional[int] = None,
                 response_window_ms: Optional[int] = None):
        super().__init__(source, key_fn, time_fn,
                         cutoff=CutOffTime.no_cutoff(),
                         predictor_window_ms=predictor_window_ms,
                         response_window_ms=response_window_ms)
        self.target_condition = target_condition
        self.drop_if_no_target = drop_if_no_target


class TimeBasedFilter:
    """Window spec for post-join aggregation (JoinedDataReader.scala:69-74):
    keep a child row when its ``condition`` time falls inside ``window_ms``
    before the entity's ``primary`` time."""

    def __init__(self, condition: str, primary: str, window_ms: int,
                 keep_condition: bool = False, keep_primary: bool = False):
        self.condition = condition
        self.primary = primary
        self.window_ms = int(window_ms)
        self.keep_condition = keep_condition
        self.keep_primary = keep_primary


def _masked_values(col: FeatureColumn) -> np.ndarray:
    """A numeric column's values as float64, NaN where missing."""
    vals = np.asarray(col.values, dtype=np.float64)
    return np.where(np.asarray(col.mask), np.nan_to_num(vals), np.nan)


_EMPTY_BY_STORAGE = {"text_list": (), "date_list": (), "map": {},
                     "multi_pick_list": frozenset()}


def _gather(col: FeatureColumn, idx: np.ndarray) -> FeatureColumn:
    """Vectorized gather with -1 = missing (masked / empty per storage).

    Missing object-storage rows get the SAME empty value ``from_values``
    uses ((), {}, frozenset(), None for text) so downstream vectorizers
    keep their iteration invariants.
    """
    missing = idx < 0
    if missing.all() or len(col.values) == 0:
        # one join side empty (or no matches at all): synthesize an
        # all-missing column without touching the empty source array
        return FeatureColumn.from_values(col.ftype, [None] * len(idx))
    safe = np.where(missing, 0, idx)
    out = FeatureColumn(col.ftype, col.values[safe],
                        col.mask[safe] if col.mask is not None else None,
                        col.vmeta)
    if missing.any():
        vals = out.values
        if isinstance(vals, np.ndarray) and vals.dtype == object:
            vals = vals.copy()
            empty = _EMPTY_BY_STORAGE.get(col.ftype.storage)
            for i in np.where(missing)[0]:
                # fresh dict per row (a shared mutable empty would alias)
                vals[i] = dict() if isinstance(empty, dict) else empty
        elif isinstance(vals, np.ndarray) and vals.dtype.kind == "f":
            vals = vals.copy()
            vals[missing] = np.nan
        mask = (out.mask if out.mask is not None
                else np.ones(len(idx), bool)) & ~missing
        return FeatureColumn(col.ftype, vals, mask, col.vmeta)
    return out


class JoinedDataReader(Reader):
    """Join two readers' datasets on key columns
    (JoinedDataReader.scala:119-223, JoinTypes.scala).

    Per-side row indices are matched by a hash of the key strings
    (duplicate right keys fan out like a SQL join, rows in pandas' merge
    order) and every feature column is gathered once by index.  ``left_key`` / ``right_key`` accept a
    single name or a sequence (multi-key joins).
    """

    def __init__(self, left: Reader, right: Reader,
                 left_features: Sequence[Feature],
                 right_features: Sequence[Feature],
                 join_type: str = "outer",
                 left_key="key", right_key="key"):
        if join_type not in ("inner", "left", "outer"):
            raise ValueError(f"unknown join type {join_type!r}")
        self.left = left
        self.right = right
        self.left_features = list(left_features)
        self.right_features = list(right_features)
        self.join_type = join_type
        self.left_key = ([left_key] if isinstance(left_key, str)
                         else list(left_key))
        self.right_key = ([right_key] if isinstance(right_key, str)
                          else list(right_key))
        if len(self.left_key) != len(self.right_key):
            raise ValueError("left_key and right_key must have the same "
                             "number of columns")

    def with_secondary_aggregation(
            self, time_filter: TimeBasedFilter) -> "JoinedAggregateDataReader":
        """Post-join aggregation (JoinedDataReader.scala:225-236)."""
        return JoinedAggregateDataReader(
            self.left, self.right, self.left_features, self.right_features,
            join_type=self.join_type, left_key=self.left_key,
            right_key=self.right_key, time_filter=time_filter)

    @staticmethod
    def _with_key(reader: Reader, features: Sequence[Feature],
                  keys: Sequence[str]) -> ColumnarDataset:
        data = reader.generate_dataset(list(features))
        missing = [k for k in keys if k not in data]
        if missing:
            from ..features.builder import FeatureBuilder

            # one batched pass for ALL missing key columns (each extra
            # generate_dataset can be a full file re-parse)
            key_data = reader.generate_dataset(
                [FeatureBuilder.ID(k).as_predictor() for k in missing])
            data = data.with_columns({k: key_data[k] for k in missing})
        return data

    def _join_indices(self, ldata: ColumnarDataset, rdata: ColumnarDataset):
        """(left_idx, right_idx, key strings), -1 marking a missing side,
        in the row order of pandas' ``merge(how=..., sort=False)``: inner
        and left joins follow the left rows, each matched left row fanned
        out over its right rows in their order; the outer join sorts the
        keys and, within a key, pairs the left rows with the right rows
        (or stands either side alone)."""
        def key_tuples(data, keys):
            parts = [[str(v) for v in data[k].to_list()] for k in keys]
            return list(zip(*parts)) if parts else []

        lkeys = key_tuples(ldata, self.left_key)
        rkeys = key_tuples(rdata, self.right_key)
        rpos: Dict[tuple, List[int]] = {}
        for j, k in enumerate(rkeys):
            rpos.setdefault(k, []).append(j)
        li: List[int] = []
        ri: List[int] = []
        keys: List[tuple] = []
        if self.join_type in ("inner", "left"):
            for i, k in enumerate(lkeys):
                js = rpos.get(k)
                if js:
                    li += [i] * len(js)
                    ri += js
                    keys += [k] * len(js)
                elif self.join_type == "left":
                    li.append(i)
                    ri.append(-1)
                    keys.append(k)
        else:
            lpos: Dict[tuple, List[int]] = {}
            for i, k in enumerate(lkeys):
                lpos.setdefault(k, []).append(i)
            for k in sorted(lpos.keys() | rpos.keys()):
                ls, js = lpos.get(k, []), rpos.get(k, [])
                for i in ls or [-1]:
                    for j in js or [-1]:
                        li.append(i)
                        ri.append(j)
                        keys.append(k)
        # composite keys join on \x1f (unit separator): a printable
        # separator like '|' would let distinct tuples collide, merging
        # entities in the post-join aggregation
        out_keys = np.asarray(["\x1f".join(k) for k in keys], dtype=object)
        return (np.asarray(li, dtype=np.int64),
                np.asarray(ri, dtype=np.int64), out_keys)

    def generate_dataset(self, raw_features: Sequence[Feature]) -> ColumnarDataset:
        lnames = {f.name for f in self.left_features}
        ldata = self._with_key(self.left, self.left_features, self.left_key)
        rdata = self._with_key(self.right, self.right_features,
                               self.right_key)
        li, ri, keys = self._join_indices(ldata, rdata)
        cols: Dict[str, FeatureColumn] = {}
        for f in raw_features:
            src, idx = ((ldata, li) if f.name in lnames else (rdata, ri))
            if f.name not in src:
                raise KeyError(f"feature {f.name!r} not produced by either "
                               "side of the join")
            cols[f.name] = _gather(src[f.name], idx)
        cols["key"] = FeatureColumn.from_values(ID, list(keys))
        return ColumnarDataset(cols)

    def stream(self, raw_features: Sequence[Feature], chunk_rows: int,
               host_range=None):
        """Chunked sort-merge join over key-sorted spill runs
        (readers/events.py), bounded by ``TMOG_STREAM_RETAIN_MB``.  Row
        ORDER is key-sorted (stable within a key) — a documented
        divergence from :meth:`generate_dataset`'s pandas hash-merge
        order; row CONTENT is identical."""
        from .events import stream_join

        return stream_join(self, raw_features, chunk_rows,
                           host_range=host_range)

    def _key_counts(self):
        """Per-side ``Counter`` of composite key strings (cached): the
        exact join cardinality needs multiplicities, not just distincts."""
        if getattr(self, "_key_counts_cache", None) is None:
            from collections import Counter

            def side(reader, keys):
                data = self._with_key(reader, [], keys)
                parts = [[str(v) for v in data[k].to_list()] for k in keys]
                return Counter("\x1f".join(p[i] for p in parts)
                               for i in range(len(parts[0])))

            self._key_counts_cache = (side(self.left, self.left_key),
                                      side(self.right, self.right_key))
        return self._key_counts_cache

    def estimate_rows(self) -> Optional[int]:
        """EXACT joined row count from per-side key multiplicities —
        matched keys fan out multiplicatively; left/outer add the
        unmatched side(s).  Host sharding can trust this instead of
        falling back to the counting pre-pass."""
        lc, rc = self._key_counts()
        n = sum(c * rc[k] for k, c in lc.items() if k in rc)
        if self.join_type in ("left", "outer"):
            n += sum(c for k, c in lc.items() if k not in rc)
        if self.join_type == "outer":
            n += sum(c for k, c in rc.items() if k not in lc)
        return n

    def estimate_rows_exact(self) -> bool:
        return True


class JoinedAggregateDataReader(JoinedDataReader):
    """Join then aggregate back to one row per key
    (JoinedAggregateDataReader, JoinedDataReader.scala:240-330): left
    (parent) features keep one copy per key; right (child) features
    monoid-aggregate over the rows whose ``time_filter.condition`` time
    falls within ``window_ms`` before the key's ``primary`` time."""

    def __init__(self, left, right, left_features, right_features,
                 join_type="outer", left_key="key", right_key="key",
                 time_filter: Optional[TimeBasedFilter] = None):
        super().__init__(left, right, left_features, right_features,
                         join_type=join_type, left_key=left_key,
                         right_key=right_key)
        if time_filter is None:
            raise ValueError("JoinedAggregateDataReader requires a "
                             "TimeBasedFilter")
        self.time_filter = time_filter

    def generate_dataset(self, raw_features: Sequence[Feature]) -> ColumnarDataset:
        tf = self.time_filter
        feats = list(raw_features)
        names = {f.name for f in feats}
        extra = []
        for f in self.left_features + self.right_features:
            if f.name in (tf.condition, tf.primary) and f.name not in names:
                extra.append(f)
        joined = super().generate_dataset(feats + extra)
        keys = np.asarray(joined["key"].to_list())
        cond_t = _masked_values(joined[tf.condition])
        prim_t = _masked_values(joined[tf.primary])
        # entity primary time = max per key (the parent row's timestamp is
        # replicated by the join; max also covers duplicate parents)
        uniq, inv = np.unique(keys, return_inverse=True)
        prim_per_key = np.full(len(uniq), -np.inf)
        np.maximum.at(prim_per_key, inv, np.nan_to_num(prim_t, nan=-np.inf))
        prim_row = prim_per_key[inv]
        in_window = (np.nan_to_num(cond_t, nan=np.inf) <= prim_row) & (
            np.nan_to_num(cond_t, nan=-np.inf)
            > prim_row - tf.window_ms)
        lnames = {f.name for f in self.left_features}
        out: Dict[str, FeatureColumn] = {}
        for f in feats:
            if f.name == tf.condition and not tf.keep_condition:
                continue
            if f.name == tf.primary and not tf.keep_primary:
                continue
            col_vals = joined[f.name].to_list()
            if f.name in lnames:
                # parent: first non-missing copy per key (dummy aggregator,
                # JoinedDataReader.scala:285-292)
                vals = [None] * len(uniq)
                for g, v in zip(inv, col_vals):
                    if vals[g] is None and v is not None:
                        vals[g] = v
            else:
                gen = f.origin_stage
                agg = getattr(gen, "aggregator", None)
                if isinstance(agg, str):
                    agg = AGGREGATOR_REGISTRY[agg]
                agg = agg or default_aggregator(f.ftype)
                groups: Dict[int, List] = {}
                for g, v, ok in zip(inv, col_vals, in_window):
                    if ok and v is not None:
                        groups.setdefault(g, []).append(v)
                vals = [agg.reduce(groups.get(g, [])) if groups.get(g)
                        else None for g in range(len(uniq))]
            out[f.name] = FeatureColumn.from_values(f.ftype, vals)
        out["key"] = FeatureColumn.from_values(ID, list(uniq))
        return ColumnarDataset(out)

    def stream(self, raw_features: Sequence[Feature], chunk_rows: int,
               host_range=None):
        """Chunked sort-merge join + secondary aggregation — one row per
        key in sorted-key order, byte-identical to
        :meth:`generate_dataset` (whose ``np.unique`` key order is the
        same lexicographic sort)."""
        from .events import stream_join_aggregate

        return stream_join_aggregate(self, raw_features, chunk_rows,
                                     host_range=host_range)

    def estimate_rows(self) -> Optional[int]:
        """EXACT: one row per distinct joined key (inner: both sides;
        left: left keys; outer: either side)."""
        lc, rc = self._key_counts()
        if self.join_type == "inner":
            return len(lc.keys() & rc.keys())
        if self.join_type == "left":
            return len(lc)
        return len(lc.keys() | rc.keys())


