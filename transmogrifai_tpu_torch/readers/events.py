"""Streamed event-time readers — the chunked per-key monoid fold
(counterpart of ``transmogrifai_tpu.readers.events``: host code, the same
passes, key order, reduce order and fault points).

Reference: ``AggregateDataReader``/``ConditionalDataReader`` apply the
monoid aggregation keyed by entity around per-key cutoffs
(readers/DataReader.scala:206-351).  The in-core readers
(readers/aggregates.py) delegate here, so there is one aggregation code
path, in core or chunked.

* **Pass A (key scan)** resolves the key universe and per-key cutoffs:
  the ``CutOffTime`` (absolute, or the cutoff function of the key's
  first record), or for a conditional reader the least time of a record
  that matches ``target_condition``.  Keys sort by ``repr``, one output
  row per key.  The scan is cached and answers ``estimate_rows()``
  exactly.
* **Pass B (fold)** buffers each owned key's in-window events as
  ``(time_ms, seq, values)`` in an :class:`EventFoldState` (associative
  ``merge``, ``to_state``/``from_state``); events outside every
  feature's window are dropped as they are read.
* **Finalize** sorts a key's events by ``(time_ms, seq)`` (``seq`` is the
  record's ordinal, so ties keep their order) and hands them to
  ``FeatureAggregator.extract``.  Output chunks lie on the global key
  grid.

``host_range`` owns a contiguous slice of the sorted keys;
:func:`key_owner` / ``EventFoldState.shard`` / :func:`merge_fold_states`
are the key-hash partition of the same state, host algebra only here
(the two-process pod run is ROADMAP Queue A item 6.7).

Sources: the port's JSON-lines and CSV readers stream (their quarantine
attribution intact; a CSV chunk's cells are typed as pandas types a
chunk, ``readers/files.infer_cells``), in-memory frames, Avro readers and
record lists slice, a Parquet source streams its record batches
(typed as ``ParquetReader`` types them).

Joins: :func:`stream_join` / :func:`stream_join_aggregate` run
``JoinedDataReader`` as a chunked sort-merge over key-sorted spill runs
bounded by the chunked train's ``TMOG_STREAM_RETAIN_MB``.  The join's
row order is key-sorted (its content is the in-core join's); the
secondary aggregation equals its in-core ``generate_dataset`` row for
row.

Fault points: ``event.window`` fires before each finalized key-window
chunk, ``join.chunk`` before each joined chunk (utils/faults.py).
"""
from __future__ import annotations

import heapq
import itertools
import os
import tempfile
import zlib
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np

from ..aggregators import (AGGREGATOR_REGISTRY, CutOffTime, Event,
                           FeatureAggregator)
from ..features.feature import Feature
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import ID
from ..utils import faults
from .base import ChunkStream, Reader

__all__ = ["StreamingAggregateReader", "StreamingConditionalReader",
           "EventFoldState", "merge_fold_states", "key_owner",
           "streaming_view", "stream_join", "stream_join_aggregate"]

#: record-chunk size for the scan/fold passes over the SOURCE (decoded
#: records resident at once; independent of the output chunk_rows, which
#: counts KEYS)
_SCAN_CHUNK_ROWS = 8192

#: exception families a corrupt event row raises out of user extract/key/
#: time lambdas — quarantined under the bad-record policy; anything else
#: (assertion, import, ...) is a programming error and propagates
_BAD_RECORD_EXC = (TypeError, ValueError, KeyError, AttributeError,
                   IndexError)


def key_owner(key: Any, process_count: int) -> int:
    """Stable key-hash ownership: crc32 of ``repr(key)``.  Python's
    ``hash()`` is PYTHONHASHSEED-randomized per process, so two pod hosts
    would disagree about ownership; crc32 of the repr bytes is identical
    everywhere."""
    return zlib.crc32(repr(key).encode("utf-8")) % int(process_count)


# ---------------------------------------------------------------------------
# record-chunk iteration over any supported source
# ---------------------------------------------------------------------------

def _source_desc(source) -> str:
    path = getattr(source, "path", None)
    return path if isinstance(path, str) else type(source).__name__


def _iter_record_chunks(source, chunk_rows: int) -> Iterator[List[Any]]:
    """Bounded record chunks from any event source: file readers stream
    (their own quarantine attribution intact), in-memory shapes slice."""
    from .files import (CSVReader, JSONLinesReader, ParquetReader,
                        _arrow_column, _parquet, infer_cells)

    if isinstance(source, JSONLinesReader):
        def jsonl():
            records, nbytes, line_no = [], 0, 0
            with open(source.path, "rb") as fh:
                for line in fh:
                    line_no += 1
                    s = line.strip()
                    if s:
                        rec = source._parse_line(s, line_no, nbytes)
                        if rec is not None:
                            records.append(rec)
                    nbytes += len(line)
                    if len(records) >= chunk_rows:
                        yield records
                        records = []
                if records:
                    yield records
        return jsonl()

    if isinstance(source, ParquetReader):
        def parquet():
            pf = _parquet().ParquetFile(source.path)
            for batch in pf.iter_batches(batch_size=chunk_rows):
                columns = {k: _arrow_column(batch.column(k))
                           for k in batch.column_names}
                yield ParquetReader._records(columns, batch.num_rows)
        return parquet()

    if isinstance(source, CSVReader):
        def csv():
            for columns, n in source._tables(chunk_rows):
                typed = {k: infer_cells(v)[1] for k, v in columns.items()}
                yield [{k: v[i] for k, v in typed.items()}
                       for i in range(n)]
        return csv()

    from .aggregates import _records_of
    from .base import DataFrameReader

    if isinstance(source, DataFrameReader):
        records = source.df.to_dict("records")
    else:
        # raw pandas frame / AvroReader-like (.records) / records list —
        # the exact source shapes the in-core readers accept
        records = _records_of(source)

    def slices():
        for i in range(0, len(records), chunk_rows):
            yield records[i:i + chunk_rows]
    return slices()


# ---------------------------------------------------------------------------
# fold state — the reader-side monoid
# ---------------------------------------------------------------------------

class EventFoldState:
    """Mergeable per-key event buffer: ``key -> [(time_ms, seq, values)]``
    with ``values`` aligned to ``feature_names``.

    ``merge`` is associative and — because finalize re-sorts every key's
    rows by ``(time_ms, seq)`` — commutative up to the finalized output,
    so partial folds partitioned ANY way (contiguous key ranges, key-hash
    shards) reassemble bit-identically.  ``to_state``/``from_state``
    follow the utils/sketches codec (plain dict of lists), so fold states
    ride the same transport as estimator states at pod pass boundaries.
    """

    def __init__(self, feature_names: Sequence[str]):
        self.feature_names = list(feature_names)
        self.rows: Dict[Any, List[Tuple[int, int, tuple]]] = {}

    def add(self, key: Any, time_ms: int, seq: int,
            values: Sequence[Any]) -> None:
        self.rows.setdefault(key, []).append((time_ms, seq, tuple(values)))

    def event_count(self) -> int:
        return sum(len(v) for v in self.rows.values())

    def merge(self, other: "EventFoldState") -> "EventFoldState":
        if other.feature_names != self.feature_names:
            raise ValueError("cannot merge fold states over different "
                             f"features: {self.feature_names} vs "
                             f"{other.feature_names}")
        for k, rs in other.rows.items():
            self.rows.setdefault(k, []).extend(rs)
        return self

    def shard(self, process_count: int) -> List["EventFoldState"]:
        """Key-hash partition (crc32 ownership) — each key's rows land in
        exactly one shard; ``merge_fold_states`` reassembles losslessly."""
        parts = [EventFoldState(self.feature_names)
                 for _ in range(process_count)]
        for k, rs in self.rows.items():
            parts[key_owner(k, process_count)].rows[k] = list(rs)
        return parts

    def to_state(self) -> Dict[str, Any]:
        keys = list(self.rows.keys())
        return {
            "features": list(self.feature_names),
            "keys": keys,
            "rows": [[[int(t), int(s), list(v)] for t, s, v in self.rows[k]]
                     for k in keys],
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "EventFoldState":
        out = cls(state["features"])
        for k, rs in zip(state["keys"], state["rows"]):
            out.rows[k] = [(int(t), int(s), tuple(v)) for t, s, v in rs]
        return out


def merge_fold_states(states: Sequence[EventFoldState]) -> EventFoldState:
    """Host-order merge of partial folds (the pod pass-boundary shape)."""
    if not states:
        raise ValueError("no fold states to merge")
    acc = EventFoldState(states[0].feature_names)
    for st in states:
        acc.merge(st)
    return acc


class _KeyIndex:
    """Pass-A product: sorted key universe, per-key cutoffs, the seqs of
    records quarantined during the scan (pass B skips them identically)."""

    def __init__(self, keys: List[Any], cutoffs: Dict[Any, Optional[int]],
                 n_records: int, bad_seqs: frozenset):
        self.keys = keys
        self.pos = {k: i for i, k in enumerate(keys)}
        self.cutoffs = cutoffs
        self.n_records = n_records
        self.bad_seqs = bad_seqs


# ---------------------------------------------------------------------------
# streamed aggregate / conditional readers
# ---------------------------------------------------------------------------

class StreamingAggregateReader(Reader):
    """Out-of-core ``AggregateDataReader``: same per-key monoid aggregation
    and cutoff-window semantics, as a two-pass streamed fold (see module
    docstring).  ``source`` is any chunkable event source: CSV / JSONL /
    Avro readers, a pandas DataFrame, or a records list."""

    def __init__(self, source, key_fn: Callable[[dict], Any],
                 time_fn: Callable[[dict], int],
                 cutoff: Optional[CutOffTime] = None,
                 predictor_window_ms: Optional[int] = None,
                 response_window_ms: Optional[int] = None,
                 scan_chunk_rows: int = _SCAN_CHUNK_ROWS):
        self.source = source
        self.key_fn = key_fn
        self.time_fn = time_fn
        self.cutoff = cutoff or CutOffTime.no_cutoff()
        self.predictor_window_ms = predictor_window_ms
        self.response_window_ms = response_window_ms
        self.scan_chunk_rows = int(scan_chunk_rows)
        self._index_cache: Optional[_KeyIndex] = None

    # -- source plumbing --------------------------------------------------

    def _source_desc(self) -> str:
        return _source_desc(self.source)

    def _arm_source(self) -> None:
        # quarantine attribution flows through to the underlying parse
        # (JSONL line numbers, CSV bad-line ordinals); sharing ONE config
        # means one sink, and the sink's (source, location) dedupe makes a
        # corrupt row quarantine once across every scan/fold pass
        if (self.resilience is not None and isinstance(self.source, Reader)
                and self.source.resilience is None):
            self.source.resilience = self.resilience

    def _record_chunks(self) -> Iterator[List[Any]]:
        self._arm_source()
        return _iter_record_chunks(self.source, self.scan_chunk_rows)

    def _guard(self, fn, record, seq: int, what: str):
        """(ok, value) for one user-callable over one record; corrupt rows
        quarantine (deterministic ``event-record#seq`` location) under the
        bad-record policy and propagate raw without one — the in-core
        fail-fast behavior, byte-identical."""
        try:
            return True, fn(record)
        except _BAD_RECORD_EXC as exc:
            cfg = self.resilience
            if cfg is not None and cfg.quarantines:
                cfg.handle_bad_record(
                    self._source_desc(), f"event-record#{seq}",
                    f"{what} failed: {exc!r}", record=record)
                return False, None
            raise

    # -- pass A: key scan -------------------------------------------------

    def _index(self) -> _KeyIndex:
        if self._index_cache is None:
            self._index_cache = self._build_index()
        return self._index_cache

    def _build_index(self) -> _KeyIndex:
        cond = getattr(self, "target_condition", None)
        drop = getattr(self, "drop_if_no_target", False)
        kind = self.cutoff.kind
        seen: set = set()
        bad: set = set()
        fn_cut: Dict[Any, Optional[int]] = {}
        match_min: Dict[Any, int] = {}
        seq = 0
        for records in self._record_chunks():
            for r in records:
                s = seq
                seq += 1
                ok, k = self._guard(self.key_fn, r, s, "key_fn")
                if not ok:
                    bad.add(s)
                    continue
                ok, t = self._guard(self.time_fn, r, s, "time_fn")
                if not ok:
                    bad.add(s)
                    continue
                if cond is not None:
                    ok, m = self._guard(cond, r, s, "target_condition")
                    if not ok:
                        bad.add(s)
                        continue
                    if m and (k not in match_min or t < match_min[k]):
                        match_min[k] = int(t)
                elif kind == "function" and k not in seen:
                    # in-core parity: cutoff fn applies to the key's FIRST
                    # record in encounter order
                    ok, c = self._guard(self.cutoff.fn, r, s, "cutoff")
                    if not ok:
                        bad.add(s)
                        continue
                    fn_cut[k] = c
                seen.add(k)
        keys = sorted(seen, key=repr)
        if cond is not None:
            if drop:
                keys = [k for k in keys if k in match_min]
            cutoffs = {k: match_min.get(k) for k in keys}
        elif kind == "unix":
            cutoffs = {k: self.cutoff.time_ms for k in keys}
        elif kind == "function":
            cutoffs = {k: fn_cut.get(k) for k in keys}
        else:
            cutoffs = {k: None for k in keys}
        return _KeyIndex(keys, cutoffs, seq, frozenset(bad))

    # -- estimates (exact: one row per key) -------------------------------

    def estimate_rows(self) -> Optional[int]:
        return len(self._index().keys)

    def estimate_rows_exact(self) -> bool:
        return True

    # -- pass B: fold + finalize ------------------------------------------

    def _aggregators(self, raw_features) -> Dict[str, FeatureAggregator]:
        aggs = {}
        for f in raw_features:
            gen = f.origin_stage
            agg = (AGGREGATOR_REGISTRY[gen.aggregator]
                   if gen.aggregator else None)
            window = gen.aggregate_window_ms
            aggs[f.name] = FeatureAggregator(
                f.ftype, f.is_response, aggregator=agg,
                predictor_window_ms=window or self.predictor_window_ms,
                response_window_ms=window or self.response_window_ms)
        return aggs

    def _feature_windows(self, raw_features) -> List[Tuple[bool, Optional[int]]]:
        out = []
        for f in raw_features:
            gen = f.origin_stage
            window = gen.aggregate_window_ms
            out.append((f.is_response,
                        window or (self.response_window_ms if f.is_response
                                   else self.predictor_window_ms)))
        return out

    @staticmethod
    def _in_any_window(t: int, cutoff: Optional[int],
                       windows: List[Tuple[bool, Optional[int]]]) -> bool:
        """Union of the features' cutoff windows — the fold-time prefilter.
        ``FeatureAggregator.extract`` re-applies each feature's own window
        at finalize, so dropping events outside EVERY window changes
        nothing but peak memory."""
        if cutoff is None:
            return True
        for is_response, w in windows:
            if is_response:
                if t >= cutoff and (w is None or t < cutoff + w):
                    return True
            elif t < cutoff and (w is None or t >= cutoff - w):
                return True
        return False

    def _fold(self, raw_features, index: _KeyIndex,
              start: int, stop: int) -> EventFoldState:
        gens = [f.origin_stage for f in raw_features]
        extract_fns = [g.extract_fn or
                       (lambda r, _n=g.name: r.get(_n)) for g in gens]
        windows = self._feature_windows(raw_features)
        state = EventFoldState([f.name for f in raw_features])
        seq = 0
        for records in self._record_chunks():
            for r in records:
                s = seq
                seq += 1
                if s in index.bad_seqs:
                    continue
                ok, k = self._guard(self.key_fn, r, s, "key_fn")
                if not ok:
                    continue
                p = index.pos.get(k)
                if p is None or not (start <= p < stop):
                    continue
                ok, t = self._guard(self.time_fn, r, s, "time_fn")
                if not ok:
                    continue
                # extract BEFORE the window prefilter: the in-core reader
                # extracted every record, so a corrupt value fails fast
                # (or quarantines) even when its event lies outside every
                # window — only the BUFFERING is window-gated
                try:
                    values = [fn(r) for fn in extract_fns]
                except _BAD_RECORD_EXC as exc:
                    cfg = self.resilience
                    if cfg is not None and cfg.quarantines:
                        cfg.handle_bad_record(
                            self._source_desc(), f"event-record#{s}",
                            f"extract failed: {exc!r}", record=r)
                        continue
                    raise
                if not self._in_any_window(t, index.cutoffs.get(k), windows):
                    continue
                state.add(k, int(t), s, values)
        return state

    def _finalize_block(self, raw_features, aggs, index: _KeyIndex,
                        state: EventFoldState, lo: int, hi: int
                        ) -> ColumnarDataset:
        keys = index.keys[lo:hi]
        cols: Dict[str, List[Any]] = {f.name: [] for f in raw_features}
        for k in keys:
            cutoff = index.cutoffs.get(k)
            rows = sorted(state.rows.get(k, ()),
                          key=lambda r: (r[0], r[1]))
            for j, f in enumerate(raw_features):
                events = [Event(t, v[j]) for t, _s, v in rows]
                cols[f.name].append(aggs[f.name].extract(events, cutoff))
        out = {f.name: FeatureColumn.from_values(f.ftype, cols[f.name])
               for f in raw_features}
        out["key"] = FeatureColumn.from_values(ID, [str(k) for k in keys])
        return ColumnarDataset(out)

    # -- Reader protocol --------------------------------------------------

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        raw_features = list(raw_features)
        index = self._index()
        aggs = self._aggregators(raw_features)
        state = self._fold(raw_features, index, 0, len(index.keys))
        return self._finalize_block(raw_features, aggs, index, state,
                                    0, len(index.keys))

    def iter_chunks(self, raw_features: Sequence[Feature],
                    chunk_rows: int,
                    host_range: Optional[tuple] = None) -> ChunkStream:
        """One streamed fold per pass: scan (cached) -> fold the owned key
        range -> finalize chunk blocks on the GLOBAL key grid.  With
        ``host_range=(start, stop)`` only keys in that slice of the sorted
        key universe are ever buffered — the pod's host-sharded ingest."""
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        raw_features = list(raw_features)
        if host_range is not None:
            start, stop = int(host_range[0]), int(host_range[1])
            if start < 0 or stop < start:
                raise ValueError(f"bad host_range ({start}, {stop})")
        else:
            start, stop = 0, None

        def gen():
            index = self._index()
            n = len(index.keys)
            lo_w, hi_w = start, n if stop is None else min(stop, n)
            if hi_w <= lo_w:
                return
            aggs = self._aggregators(raw_features)
            state = self._fold(raw_features, index, lo_w, hi_w)
            out_idx = 0
            for c0 in range(0, n, chunk_rows):
                if c0 >= hi_w:
                    break
                c1 = min(c0 + chunk_rows, n)
                lo, hi = max(c0, lo_w), min(c1, hi_w)
                if hi <= lo:
                    continue
                faults.fire("event.window", index=out_idx)
                out_idx += 1
                yield self._finalize_block(raw_features, aggs, index,
                                           state, lo, hi)

        return ChunkStream(gen())


class StreamingConditionalReader(StreamingAggregateReader):
    """Out-of-core ``ConditionalDataReader``: per-key cutoff = time of the
    first (minimum-time) record matching ``target_condition``; keys with
    no match drop when ``drop_if_no_target``."""

    def __init__(self, source, key_fn, time_fn,
                 target_condition: Callable[[dict], bool],
                 drop_if_no_target: bool = True,
                 predictor_window_ms: Optional[int] = None,
                 response_window_ms: Optional[int] = None,
                 scan_chunk_rows: int = _SCAN_CHUNK_ROWS):
        super().__init__(source, key_fn, time_fn,
                         cutoff=CutOffTime.no_cutoff(),
                         predictor_window_ms=predictor_window_ms,
                         response_window_ms=response_window_ms,
                         scan_chunk_rows=scan_chunk_rows)
        self.target_condition = target_condition
        self.drop_if_no_target = drop_if_no_target


def streaming_view(reader) -> StreamingAggregateReader:
    """The streamed twin of an in-core aggregate/conditional reader — the
    ONE aggregation code path (`in-core generate_dataset` delegates here,
    asserted byte-identical by tests/test_events_streaming.py)."""
    from .aggregates import AggregateDataReader, ConditionalDataReader

    if isinstance(reader, ConditionalDataReader):
        view = StreamingConditionalReader(
            reader.source, reader.key_fn, reader.time_fn,
            target_condition=reader.target_condition,
            drop_if_no_target=reader.drop_if_no_target,
            predictor_window_ms=reader.predictor_window_ms,
            response_window_ms=reader.response_window_ms)
    elif isinstance(reader, AggregateDataReader):
        view = StreamingAggregateReader(
            reader.source, reader.key_fn, reader.time_fn,
            cutoff=reader.cutoff,
            predictor_window_ms=reader.predictor_window_ms,
            response_window_ms=reader.response_window_ms)
    else:
        raise TypeError(f"not an aggregate reader: {type(reader).__name__}")
    view.resilience = reader.resilience
    return view


# ---------------------------------------------------------------------------
# chunked sort-merge joins over key-sorted spill runs
# ---------------------------------------------------------------------------

def _join_budget_bytes() -> int:
    """The join spiller shares the chunked train's retention budget
    (``TMOG_STREAM_RETAIN_MB``, workflow/streaming.py) — one knob bounds
    every out-of-core buffer."""
    from ..workflow.streaming import _retain_budget_bytes

    return _retain_budget_bytes()


def _row_cost(key: str, values: Sequence[Any]) -> int:
    # cheap deterministic approximation (exact accounting would getsizeof
    # every nested value per row); the budget is a bound knob, not a meter
    return 96 + len(key) + 48 * (2 + len(values))


class _SpillSorter:
    """External merge sort of ``(key, seq, values)`` rows.

    Rows accumulate in RAM until the byte budget, then sort (stable: the
    ``(key, seq)`` composite keeps each key's original row order) and
    spill as sequential ``np.save`` blocks in one temp file — the k-way
    heap merge holds one block per run, never a whole run (the
    ``_BlockStore`` discipline, workflow/streaming.py)."""

    BLOCK_ROWS = 2048

    def __init__(self, budget_bytes: int):
        self.budget = max(int(budget_bytes), 1 << 16)
        self.buf: List[Tuple[str, int, list]] = []
        self.buf_bytes = 0
        self.runs: List[Tuple[str, int]] = []   # (path, n_blocks)
        self.spilled_rows = 0

    def add(self, key: str, seq: int, values: list) -> None:
        self.buf.append((key, seq, values))
        self.buf_bytes += _row_cost(key, values)
        if self.buf_bytes >= self.budget:
            self._spill()

    def _spill(self) -> None:
        if not self.buf:
            return
        self.buf.sort(key=lambda r: (r[0], r[1]))
        fd, path = tempfile.mkstemp(prefix="tmog_join_run_")
        n_blocks = 0
        ok = False
        try:
            with os.fdopen(fd, "wb") as fh:
                for i in range(0, len(self.buf), self.BLOCK_ROWS):
                    block = self.buf[i:i + self.BLOCK_ROWS]
                    arr = np.empty(len(block), dtype=object)
                    arr[:] = block
                    np.save(fh, arr, allow_pickle=True)
                    n_blocks += 1
            ok = True
        finally:
            if not ok:
                os.unlink(path)
        self.spilled_rows += len(self.buf)
        self.runs.append((path, n_blocks))
        self.buf = []
        self.buf_bytes = 0

    @staticmethod
    def _run_iter(path: str, n_blocks: int):
        with open(path, "rb") as fh:
            for _ in range(n_blocks):
                for row in np.load(fh, allow_pickle=True):
                    yield tuple(row)

    def sorted_rows(self) -> Iterator[Tuple[str, int, list]]:
        if not self.runs:
            self.buf.sort(key=lambda r: (r[0], r[1]))
            buf, self.buf = self.buf, []
            yield from buf
            return
        self._spill()   # flush the in-RAM remainder as the last run
        runs, self.runs = self.runs, []
        try:
            yield from heapq.merge(
                *(self._run_iter(p, nb) for p, nb in runs),
                key=lambda r: (r[0], r[1]))
        finally:
            for p, _nb in runs:
                try:
                    os.unlink(p)
                except OSError:
                    pass


def _side_chunks(reader, features, key_cols: Sequence[str], chunk_rows: int):
    """One side's chunks with every key column present — the streaming
    twin of ``JoinedDataReader._with_key``: peek at the first chunk, and
    only when a key column is genuinely absent (not in the features AND
    not auto-emitted, like an aggregate reader's ``key``) re-open with
    synthesized ID key features."""
    stream = iter(reader.iter_chunks(list(features), chunk_rows))
    first = next(stream, None)
    if first is None:
        return iter(())
    missing = [k for k in key_cols if k not in first]
    if not missing:
        return itertools.chain([first], stream)
    from ..features.builder import FeatureBuilder

    key_feats = [FeatureBuilder.ID(k).as_predictor() for k in missing]
    return iter(reader.iter_chunks(list(features) + key_feats, chunk_rows))


def _side_sorted(reader, features, key_cols: Sequence[str],
                 chunk_rows: int, budget: int):
    """One join side as key-sorted ``(key, seq, values)`` rows; composite
    keys join on \\x1f exactly like the in-core ``_join_indices``."""
    sorter = _SpillSorter(budget)
    seq = 0
    for ds in _side_chunks(reader, features, key_cols, chunk_rows):
        key_parts = [[str(v) for v in ds[k].to_list()] for k in key_cols]
        col_lists = [ds[f.name].to_list() for f in features]
        for i in range(len(ds)):
            key = "\x1f".join(p[i] for p in key_parts)
            sorter.add(key, seq, [c[i] for c in col_lists])
            seq += 1
    return sorter.sorted_rows()


def _grouped(rows) -> Iterator[Tuple[str, List[Tuple[str, int, list]]]]:
    for k, rs in itertools.groupby(rows, key=lambda r: r[0]):
        yield k, list(rs)


def _joined_groups(jr, lcols, rcols, chunk_rows: int
                   ) -> Iterator[Tuple[str, List[Tuple[Optional[list],
                                                       Optional[list]]]]]:
    """Sort-merge the two sides: per key (ascending), the fan-out rows as
    ``(left_values | None, right_values | None)`` — within a key, left
    rows in original order, each paired with right rows in original order
    (the pandas-merge fan-out order the in-core join produces)."""
    budget = _join_budget_bytes() // 4    # two sides + merge-block headroom
    lg = _grouped(_side_sorted(jr.left, lcols, jr.left_key,
                               chunk_rows, budget))
    rg = _grouped(_side_sorted(jr.right, rcols, jr.right_key,
                               chunk_rows, budget))
    want_left_only = jr.join_type in ("left", "outer")
    want_right_only = jr.join_type == "outer"
    lcur = next(lg, None)
    rcur = next(rg, None)
    while lcur is not None or rcur is not None:
        if rcur is None or (lcur is not None and lcur[0] < rcur[0]):
            if want_left_only:
                yield lcur[0], [(row[2], None) for row in lcur[1]]
            lcur = next(lg, None)
        elif lcur is None or rcur[0] < lcur[0]:
            if want_right_only:
                yield rcur[0], [(None, row[2]) for row in rcur[1]]
            rcur = next(rg, None)
        else:
            rrows = [row[2] for row in rcur[1]]
            yield lcur[0], [(lrow[2], rvals)
                            for lrow in lcur[1] for rvals in rrows]
            lcur = next(lg, None)
            rcur = next(rg, None)


def _split_join_columns(jr, raw_features):
    lnames = {f.name for f in jr.left_features}
    rnames = {f.name for f in jr.right_features}
    lcols = [f for f in raw_features if f.name in lnames]
    rcols = [f for f in raw_features if f.name not in lnames]
    for f in rcols:
        if f.name not in rnames:
            raise KeyError(f"feature {f.name!r} not produced by either "
                           "side of the join")
    return lcols, rcols


def stream_join(jr, raw_features, chunk_rows: int,
                host_range: Optional[tuple] = None) -> ChunkStream:
    """``JoinedDataReader.stream()``: the chunked sort-merge join.  Row
    order is KEY-SORTED, stable within a key (documented divergence from
    the in-core pandas hash-merge order); every other value, including
    per-storage missing-side empties, matches ``generate_dataset``."""
    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    raw_features = list(raw_features)
    lcols, rcols = _split_join_columns(jr, raw_features)

    def gen():
        buf: Dict[str, list] = {f.name: [] for f in raw_features}
        keys: List[str] = []
        out_idx = 0

        def flush():
            nonlocal out_idx
            faults.fire("join.chunk", index=out_idx)
            out_idx += 1
            cols = {f.name: FeatureColumn.from_values(f.ftype, buf[f.name])
                    for f in raw_features}
            cols["key"] = FeatureColumn.from_values(ID, list(keys))
            for f in raw_features:
                buf[f.name] = []
            keys.clear()
            return ColumnarDataset(cols)

        for key, pairs in _joined_groups(jr, lcols, rcols, chunk_rows):
            for lvals, rvals in pairs:
                for i, f in enumerate(lcols):
                    buf[f.name].append(None if lvals is None else lvals[i])
                for i, f in enumerate(rcols):
                    buf[f.name].append(None if rvals is None else rvals[i])
                keys.append(key)
                if len(keys) >= chunk_rows:
                    yield flush()
        if keys:
            yield flush()

    from .base import window_gen

    g = gen() if host_range is None else window_gen(gen(), host_range)
    return ChunkStream(g)


def stream_join_aggregate(jr, raw_features, chunk_rows: int,
                          host_range: Optional[tuple] = None) -> ChunkStream:
    """``JoinedAggregateDataReader.stream()``: sort-merge join + secondary
    per-key aggregation, one output row per key in sorted-key order —
    byte-identical to the in-core ``generate_dataset`` (its ``np.unique``
    key order is the same lexicographic sort)."""
    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    from ..aggregators import default_aggregator

    tf = jr.time_filter
    feats = list(raw_features)
    names = {f.name for f in feats}
    extra = [f for f in jr.left_features + jr.right_features
             if f.name in (tf.condition, tf.primary) and f.name not in names]
    all_feats = feats + extra
    lcols, rcols = _split_join_columns(jr, all_feats)
    lnames = {f.name for f in jr.left_features}
    out_feats = [f for f in feats
                 if not (f.name == tf.condition and not tf.keep_condition)
                 and not (f.name == tf.primary and not tf.keep_primary)]

    aggs = {}
    for f in out_feats:
        if f.name in lnames:
            continue
        agg = getattr(f.origin_stage, "aggregator", None)
        if isinstance(agg, str):
            agg = AGGREGATOR_REGISTRY[agg]
        aggs[f.name] = agg or default_aggregator(f.ftype)

    def gen():
        buf: Dict[str, list] = {f.name: [] for f in out_feats}
        keys: List[str] = []
        out_idx = 0

        def flush():
            nonlocal out_idx
            faults.fire("join.chunk", index=out_idx)
            out_idx += 1
            cols = {f.name: FeatureColumn.from_values(f.ftype, buf[f.name])
                    for f in out_feats}
            cols["key"] = FeatureColumn.from_values(ID, list(keys))
            for f in out_feats:
                buf[f.name] = []
            keys.clear()
            return ColumnarDataset(cols)

        for key, pairs in _joined_groups(jr, lcols, rcols, chunk_rows):
            rows = []      # per fan-out row: {name: value}
            for lvals, rvals in pairs:
                row = {}
                for i, f in enumerate(lcols):
                    row[f.name] = None if lvals is None else lvals[i]
                for i, f in enumerate(rcols):
                    row[f.name] = None if rvals is None else rvals[i]
                rows.append(row)
            # entity primary time = max per key (in-core parity: missing
            # primaries are -inf, so an all-missing key admits nothing)
            prim = [r.get(tf.primary) for r in rows]
            prim_max = max((float(p) for p in prim if p is not None),
                           default=float("-inf"))
            in_window = []
            for r in rows:
                c = r.get(tf.condition)
                in_window.append(c is not None and float(c) <= prim_max
                                 and float(c) > prim_max - tf.window_ms)
            for f in out_feats:
                if f.name in lnames:
                    val = next((r[f.name] for r in rows
                                if r[f.name] is not None), None)
                else:
                    vals = [r[f.name] for r, ok in zip(rows, in_window)
                            if ok and r[f.name] is not None]
                    val = aggs[f.name].reduce(vals) if vals else None
                buf[f.name].append(val)
            keys.append(key)
            if len(keys) >= chunk_rows:
                yield flush()
        if keys:
            yield flush()

    from .base import window_gen

    g = gen() if host_range is None else window_gen(gen(), host_range)
    return ChunkStream(g)
