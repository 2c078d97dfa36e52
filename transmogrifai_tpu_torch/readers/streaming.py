"""Streaming readers — micro-batched scoring input, and the prefetch
half of out-of-core ingestion (counterpart of
``transmogrifai_tpu.readers.streaming``).

``IteratorStreamingReader`` wraps any iterable of batches (datasets,
record lists, pandas frames), ``FileStreamingReader`` watches a directory
and reads each new CSV or JSON file as one micro-batch (the port's own
parsers, no pandas; a Parquet file through ``ParquetReader``), and
``AsyncBatcher`` parses the next chunks on a background thread while the
caller transforms or scores the current one.

The prefetch thread parses on the host only: readers yield numpy and
Python columns, and every tensor op and every copy to the card happens on
the thread that transforms.  Work the pump thread issued on the card
would run on that thread's stream, unordered against the transforming
thread's work that reads it, and its tensors would hold device memory
for every chunk queued ahead.
"""
from __future__ import annotations

import json
import os
import queue
import threading
from typing import (Any, Callable, Iterable, Iterator, List, Optional,
                    Sequence)

from ..features.feature import Feature
from ..obs.trace import adopt_span, current_span
from ..types.columns import ColumnarDataset
from .base import DataFrameReader, RecordsReader

__all__ = ["StreamingReader", "IteratorStreamingReader",
           "FileStreamingReader", "AsyncBatcher", "StreamingReaders"]


class StreamingReader:
    """Yields ``ColumnarDataset`` micro-batches of the raw features."""

    def stream(self, raw_features: Sequence[Feature]
               ) -> Iterator[ColumnarDataset]:
        raise NotImplementedError


class IteratorStreamingReader(StreamingReader):
    """Wraps any iterable of datasets, record lists or pandas frames."""

    def __init__(self, batches: Iterable[Any]):
        self.batches = batches

    def stream(self, raw_features):
        for batch in self.batches:
            if isinstance(batch, ColumnarDataset):
                yield batch
            elif isinstance(batch, (list, tuple)):
                yield RecordsReader(batch).generate_dataset(raw_features)
            else:
                yield DataFrameReader(batch).generate_dataset(raw_features)


class FileStreamingReader(StreamingReader):
    """Watch a directory and read each new data file as one micro-batch
    (FileStreamingAvroReader: a path filter and ``new_files_only``).
    ``poll_interval``/``max_polls`` bound the watch loop (a service passes
    ``max_polls=None`` and ends it with ``stop()``).  ``.json`` holds one
    array of records, ``.jsonl`` one record a line, ``.parquet`` is read
    by ``ParquetReader``, anything else is CSV
    (with a header, or ``column_names``)."""

    def __init__(self, directory: str,
                 path_filter: Optional[Callable[[str], bool]] = None,
                 new_files_only: bool = False,
                 poll_interval: float = 1.0,
                 max_polls: Optional[int] = 1,
                 column_names: Optional[List[str]] = None):
        self.directory = directory
        self.path_filter = path_filter or (lambda p: not os.path.basename(
            p).startswith((".", "_")))
        self.new_files_only = new_files_only
        self.poll_interval = poll_interval
        self.max_polls = max_polls
        self.column_names = column_names
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def _list_files(self) -> List[str]:
        try:
            names = sorted(os.listdir(self.directory))
        except FileNotFoundError:
            return []
        paths = [os.path.join(self.directory, n) for n in names]
        return [p for p in paths if os.path.isfile(p) and self.path_filter(p)]

    def _read_file(self, path: str, raw_features) -> ColumnarDataset:
        from .files import CSVReader, JSONLinesReader, ParquetReader

        if path.endswith(".parquet"):
            return ParquetReader(path).generate_dataset(raw_features)
        if path.endswith(".jsonl"):
            return JSONLinesReader(path).generate_dataset(raw_features)
        if path.endswith(".json"):
            with open(path) as fh:
                return RecordsReader(json.load(fh)).generate_dataset(
                    raw_features)
        reader = (CSVReader(path, column_names=self.column_names,
                            has_header=False) if self.column_names
                  else CSVReader(path))
        return reader.generate_dataset(raw_features)

    def stream(self, raw_features):
        seen = set(self._list_files()) if self.new_files_only else set()
        polls = 0
        while not self._stop.is_set():
            for path in self._list_files():
                if path in seen:
                    continue
                seen.add(path)
                yield self._read_file(path, raw_features)
            polls += 1
            if self.max_polls is not None and polls >= self.max_polls:
                return
            self._stop.wait(self.poll_interval)


class AsyncBatcher:
    """Bounded-queue prefetcher over an iterator of chunks.

    An exception of the producer is re-raised from ``__next__`` after the
    items that came before it; after the end (or the re-raise) every
    further ``__next__`` raises ``StopIteration``.  ``close()`` releases
    the pump when the consumer leaves early: its puts poll the closed flag,
    so it never blocks forever on a full queue.  The pump thread adopts
    the span current where the batcher was made (a reader pass's), so
    that the reader's own spans nest under it.
    """

    _DONE = object()

    def __init__(self, source: Iterator[ColumnarDataset], depth: int = 2):
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(int(depth), 1))
        self._err: Optional[BaseException] = None
        self._closed = threading.Event()
        self._exhausted = False

        def put(item) -> bool:
            while not self._closed.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        parent = current_span()

        def pump():
            try:
                with adopt_span(parent):
                    for item in source:
                        if not put(item):
                            return
            except BaseException as e:  # re-raised on the consumer side
                self._err = e
            finally:
                put(self._DONE)

        self._thread = threading.Thread(target=pump, daemon=True,
                                        name="tmog-prefetch")
        self._thread.start()

    def close(self) -> None:
        """Release the pump thread; safe to call at any time."""
        self._closed.set()

    def __iter__(self) -> "AsyncBatcher":
        return self

    def __next__(self) -> ColumnarDataset:
        if self._exhausted:
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._exhausted = True
            self.close()
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item


class StreamingReaders:
    """Factory catalogue (StreamingReaders.Simple)."""

    class Simple:
        @staticmethod
        def iterator(batches: Iterable[Any]) -> IteratorStreamingReader:
            return IteratorStreamingReader(batches)

        @staticmethod
        def files(directory: str, **kwargs) -> FileStreamingReader:
            return FileStreamingReader(directory, **kwargs)
