"""The prefetch half of out-of-core ingestion (counterpart of
``transmogrifai_tpu.readers.streaming``'s ``AsyncBatcher``): a background
thread parses the next chunks while the caller transforms the current
one.  The streaming readers of the JAX module (a watched directory, an
iterator of frames) come with ROADMAP Queue A item 6.3's event readers.

The prefetch thread parses on the host only: readers yield numpy and
Python columns, and every tensor op and every copy to the card happens on
the thread that transforms.  Work the pump thread issued on the card
would run on that thread's stream, unordered against the transforming
thread's work that reads it, and its tensors would hold device memory
for every chunk queued ahead.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional

from ..types.columns import ColumnarDataset

__all__ = ["AsyncBatcher"]


class AsyncBatcher:
    """Bounded-queue prefetcher over an iterator of chunks.

    An exception of the producer is re-raised from ``__next__`` after the
    items that came before it; after the end (or the re-raise) every
    further ``__next__`` raises ``StopIteration``.  ``close()`` releases
    the pump when the consumer leaves early: its puts poll the closed flag,
    so it never blocks forever on a full queue.
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

        def pump():
            try:
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
