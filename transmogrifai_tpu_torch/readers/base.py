"""Data readers — host-side ingestion into columnar batches.

Ported: ``reader_for`` with the ``ColumnarDataset`` passthrough, the
records reader (a list of dicts; ``key_fn`` adds a ``key`` ID column) and
the in-memory pandas DataFrame reader (pandas imported only when a frame
is given); the CSV and JSON-lines file readers are in ``readers/files.py``,
the Avro readers in ``readers/avro.py``.  Every reader streams bounded
row chunks through ``iter_chunks`` (a ``ChunkStream`` with byte
accounting; ``host_range`` windows it through ``window_gen``): the
in-memory readers slice, the file readers parse chunk by chunk, and
every chunk passes the ``reader.chunk`` fault point (utils/faults.py).
``Reader.with_resilience`` attaches the retry and bad-record policies of
``readers/resilience.py``.  The event readers are in
``readers/aggregates.py`` and ``readers/events.py``, the micro-batch
streaming readers in ``readers/streaming.py``; Parquet is not ported
(ROADMAP Queue A item 6.3).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

from ..features.feature import Feature
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import ID
from ..utils import faults

__all__ = ["Reader", "DataFrameReader", "RecordsReader", "reader_for",
           "ChunkStream", "window_gen"]


def _check_chunk_rows(chunk_rows: int) -> None:
    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")


def window_gen(gen, host_range):
    """Restrict a chunk generator to the global row window [start, stop):
    chunks before it are read and dropped, chunks across an edge are
    sliced, and the iteration stops at ``stop``.  Chunk boundaries stay on
    the source's own grid."""
    start, stop = int(host_range[0]), int(host_range[1])
    if start < 0 or stop < start:
        raise ValueError(f"bad host_range ({start}, {stop})")

    def windowed():
        offset = 0
        if start == stop:
            return
        for ds in gen:
            n = len(ds)
            lo = max(start - offset, 0)
            hi = min(stop - offset, n)
            offset += n
            if hi > lo:
                yield ds if (lo == 0 and hi == n) else ds.slice(lo, hi)
            if offset >= stop:
                break

    return windowed()


class ChunkStream:
    """Iterator of bounded ``ColumnarDataset`` chunks.  ``bytes_read`` is
    the producing reader's running total (its file position where it has
    one), read on the thread that advances the iterator; 0 for readers
    that cannot attribute bytes.  Each chunk first passes the
    ``reader.chunk`` fault point, keyed by its index: the retry wrapper
    (``readers/resilience.RetryingChunkStream``) sits above this stream,
    so an injected IO error takes the real recovery path."""

    def __init__(self, gen, bytes_fn=None):
        self._gen = iter(gen)
        self._bytes_fn = bytes_fn
        self._idx = 0
        self.bytes_read: int = 0

    def __iter__(self):
        return self

    def __next__(self) -> ColumnarDataset:
        faults.fire("reader.chunk", index=self._idx)
        ds = next(self._gen)
        self._idx += 1
        if self._bytes_fn is not None:
            self.bytes_read = int(self._bytes_fn())
        return ds


def _stream(gen, host_range, bytes_fn=None) -> ChunkStream:
    return ChunkStream(gen if host_range is None
                       else window_gen(gen, host_range), bytes_fn)


class Reader:
    """Produces the raw-feature dataset for a workflow."""

    #: the ingestion resilience (retry and bad-record policy) attached by
    #: ``with_resilience``; None keeps the fail-fast behaviour
    resilience = None

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        raise NotImplementedError

    def estimate_rows(self) -> Optional[int]:
        """The row count before reading, where the source can say without a
        parse (None otherwise)."""
        return None

    def estimate_rows_exact(self) -> bool:
        """True when ``estimate_rows`` is the exact row count after every
        policy (Avro block headers, the event readers)."""
        return False

    def with_resilience(self, retry=None, bad_records: str = "fail",
                        quarantine_path: Optional[str] = None,
                        max_bad_records: int = 1000) -> "Reader":
        """Attach a ``readers.resilience.ResilienceConfig``.

        ``retry``: a ``RetryPolicy``, True for its defaults, or None (no
        retries).  ``bad_records``: ``"fail"`` (the default) or
        ``"quarantine"`` (needs ``quarantine_path``: unparseable records
        go to that JSONL sidecar until more than ``max_bad_records`` rows
        have, then the read fails)."""
        from .resilience import (BadRecordPolicy, ResilienceConfig,
                                 RetryPolicy)

        if retry is True:
            retry = RetryPolicy()
        self.resilience = ResilienceConfig(
            retry=retry,
            bad_records=BadRecordPolicy(
                mode=bad_records, quarantine_path=quarantine_path,
                max_bad_records=max_bad_records))
        return self

    def iter_chunks(self, raw_features: Sequence[Feature], chunk_rows: int,
                    host_range: Optional[tuple] = None) -> ChunkStream:
        """The dataset as row chunks of at most ``chunk_rows`` rows.  This
        fallback reads the whole dataset once and yields row slices; the
        file readers override it with parses that never hold the file."""
        _check_chunk_rows(chunk_rows)

        def gen():
            ds = self.generate_dataset(raw_features)
            for start in range(0, len(ds), chunk_rows):
                yield ds.slice(start, min(start + chunk_rows, len(ds)))

        return _stream(gen(), host_range)


class RecordsReader(Reader):
    """Wraps a list of dict (or attribute) records; every feature reads
    its value through its generator (``r.get(name)`` or its extractor).
    ``key_fn`` maps a record to its entity key: the dataset then has a
    ``key`` ID column of ``str(key_fn(record))``."""

    def __init__(self, records: Sequence[Any],
                 key_fn: Optional[Callable[[Any], Any]] = None):
        self.records = list(records)
        self.key_fn = key_fn

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        cols = {f.name: f.origin_stage.extract_column(self.records)
                for f in raw_features}
        if self.key_fn is not None:
            cols["key"] = FeatureColumn.from_values(
                ID, [str(self.key_fn(r)) for r in self.records])
        return ColumnarDataset(cols)

    def iter_chunks(self, raw_features: Sequence[Feature], chunk_rows: int,
                    host_range: Optional[tuple] = None) -> ChunkStream:
        """Each chunk's records extracted on their own."""
        _check_chunk_rows(chunk_rows)

        def gen():
            for start in range(0, len(self.records), chunk_rows):
                yield RecordsReader(
                    self.records[start:start + chunk_rows],
                    key_fn=self.key_fn).generate_dataset(raw_features)

        return _stream(gen(), host_range)


class DataFrameReader(Reader):
    """Wraps an in-memory pandas DataFrame; features read their column by
    name, or through their ``extract_fn`` over the frame's records.
    ``key_col`` names the frame's entity-key column for the joins; as in
    the JAX package, the dataset itself does not carry it."""

    def __init__(self, df, key_col: Optional[str] = None):
        self.df = df
        self.key_col = key_col

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        records = None
        cols: Dict[str, FeatureColumn] = {}
        for f in raw_features:
            gen = f.origin_stage
            if gen.extract_fn is None:
                if f.name not in self.df.columns:
                    raise KeyError(
                        f"input data is missing raw feature column {f.name!r}")
                series = self.df[f.name]
                vals = (series.to_numpy() if series.dtype.kind in "fiub"
                        else series.tolist())
                cols[f.name] = FeatureColumn.from_values(f.ftype, vals)
            else:
                if records is None:
                    records = self.df.to_dict("records")
                cols[f.name] = gen.extract_column(records)
        return ColumnarDataset(cols)

    def iter_chunks(self, raw_features: Sequence[Feature], chunk_rows: int,
                    host_range: Optional[tuple] = None) -> ChunkStream:
        """Row-range chunks of the frame, each read on its own (a numeric
        column's dtype is the frame's, so a chunk coerces as the whole)."""
        _check_chunk_rows(chunk_rows)

        def gen():
            n = len(self.df)
            for start in range(0, n, chunk_rows):
                part = self.df.iloc[start:min(start + chunk_rows, n)]
                yield DataFrameReader(part, self.key_col).generate_dataset(
                    raw_features)

        return _stream(gen(), host_range)


class _PassthroughReader(Reader):
    def __init__(self, ds: ColumnarDataset):
        self.ds = ds

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        missing = [f.name for f in raw_features if f.name not in self.ds]
        if missing:
            raise ValueError(f"dataset missing raw feature columns {missing}")
        return self.ds.select([f.name for f in raw_features])


def reader_for(data) -> Reader:
    """Coerce user input to a Reader."""
    if isinstance(data, Reader):
        return data
    if isinstance(data, ColumnarDataset):
        return _PassthroughReader(data)
    if isinstance(data, (list, tuple)):
        return RecordsReader(data)
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None and isinstance(data, pd.DataFrame):
        return DataFrameReader(data)
    raise TypeError(f"cannot build a reader from {type(data)}")
