"""Ingestion resilience (counterpart of
``transmogrifai_tpu.readers.resilience``): retry with backoff for
transient IO, and the bad-record quarantine with a JSONL sidecar.

* ``RetryPolicy`` — bounded exponential backoff with a deterministic
  jitter (seeded RNG): only transient ``OSError``/``IOError`` retries;
  corruption (``ValueError``/``EOFError``/decode errors) never does.
* ``BadRecordPolicy`` — ``fail`` (the default: raise with an attributed
  location) or ``quarantine`` (route the record to a JSONL sidecar with
  its reason and location and go on, failing fast past
  ``max_bad_records`` rows).
* ``RetryingChunkStream`` — wraps a re-creatable chunk stream; on a
  transient error it backs off, reopens the stream, skips exactly the
  chunks already delivered (chunking is deterministic) and resumes.

Wiring: ``reader.with_resilience(...)`` attaches a ``ResilienceConfig``;
the chunked train (workflow/streaming.py) wraps each reader pass in
the retrying stream and counts retries, backoff and quarantined records
in its ``IngestProfiler``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

import numpy as np

__all__ = ["RetryPolicy", "BadRecordPolicy", "QuarantineSink",
           "BadRecordError", "TooManyBadRecordsError", "ResilienceConfig",
           "RetryingChunkStream", "is_transient_io_error"]

#: OSError subclasses that retrying cannot fix — a missing file stays
#: missing; config errors should surface immediately
_NON_TRANSIENT_OS = (FileNotFoundError, PermissionError, IsADirectoryError,
                     NotADirectoryError)


def is_transient_io_error(exc: BaseException) -> bool:
    """The retry gate: transient ``OSError``/``IOError`` only.  Corruption
    (ValueError/EOFError) and programming errors are never retried."""
    return isinstance(exc, OSError) and not isinstance(exc, _NON_TRANSIENT_OS)


class BadRecordError(ValueError):
    """An unparseable record/row/block under the ``fail`` policy — carries
    the source + location so the operator can find the bytes."""

    def __init__(self, source: str, location: str, reason: str):
        super().__init__(f"{source}: bad record at {location}: {reason}")
        self.source = source
        self.location = location
        self.reason = reason


class TooManyBadRecordsError(BadRecordError):
    """Quarantine gave up: more than ``max_bad_records`` rows were bad —
    at that point the data is wrong, not merely dirty."""


@dataclass
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    ``backoff_s(attempt)`` = ``base_delay_s * 2**attempt`` capped at
    ``max_delay_s``, plus a jitter in ``[0, jitter * delay)`` drawn from a
    seeded RNG — two runs with the same seed sleep the same spans, so
    fault-injection tests are reproducible to the millisecond budget.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.1
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self._rng = np.random.default_rng(self.seed)

    def backoff_s(self, attempt: int) -> float:
        delay = min(self.base_delay_s * (2.0 ** attempt), self.max_delay_s)
        if self.jitter > 0:
            delay += float(self._rng.random()) * self.jitter * delay
        return delay


class QuarantineSink:
    """Append-only JSONL sidecar for quarantined records.

    One line per bad record: ``{"source", "location", "reason", "record"}``.
    Locations are deterministic (line number / block index + byte offset),
    and the sink de-duplicates on (source, location) — a retried stream
    that re-reads already-consumed chunks must not double-count, so the
    sidecar reconciles EXACTLY with the rows dropped from the dataset.
    """

    def __init__(self, path: str, max_bad_records: int = 1000):
        self.path = path
        self.max_bad_records = int(max_bad_records)
        self._lock = threading.Lock()
        self._seen: set = set()
        self.count = 0       # sidecar entries
        self.rows = 0        # data rows dropped (an Avro block entry is many)
        self._fh = None

    def quarantine(self, source: str, location: str, reason: str,
                   record: Any = None, rows: int = 1) -> None:
        """Record one bad record (or a ``rows``-row bad block); raises
        TooManyBadRecordsError once more than ``max_bad_records`` ROWS are
        quarantined.  (source, location) pairs de-duplicate, so a retried
        re-read cannot double-count.

        The JAX package buffers the entries of a pod's other processes
        for the coordinator to write; the port runs one process (pods are
        ROADMAP Queue A item 6.7), which writes every entry itself."""
        key = (source, location)
        entry = {"source": source, "location": location,
                 "reason": reason, "rows": int(rows)}
        if record is not None:
            try:
                json.dumps(record)
                entry["record"] = record
            except (TypeError, ValueError):
                entry["record"] = repr(record)
        with self._lock:
            if key in self._seen:
                return
            self._seen.add(key)
            self.count += 1
            self.rows += int(rows)
            total_rows = self.rows
            self._write_entry(entry)
        if total_rows > self.max_bad_records:
            raise TooManyBadRecordsError(
                source, location,
                f"exceeded max_bad_records={self.max_bad_records} "
                f"(quarantined {total_rows} rows; sidecar: {self.path})")

    def _write_entry(self, entry: dict) -> None:
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        self._fh.write(json.dumps(entry) + "\n")
        self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


@dataclass
class BadRecordPolicy:
    """What ingestion does with an unparseable record."""

    FAIL = "fail"
    QUARANTINE = "quarantine"

    mode: str = FAIL
    quarantine_path: Optional[str] = None
    max_bad_records: int = 1000

    def __post_init__(self):
        if self.mode not in (self.FAIL, self.QUARANTINE):
            raise ValueError(f"bad-record mode must be 'fail' or "
                             f"'quarantine', got {self.mode!r}")
        if self.mode == self.QUARANTINE and not self.quarantine_path:
            raise ValueError("quarantine mode requires quarantine_path")


@dataclass
class ResilienceConfig:
    """Retry + bad-record policy attached to a Reader
    (``reader.with_resilience(...)``)."""

    retry: Optional[RetryPolicy] = None
    bad_records: BadRecordPolicy = field(default_factory=BadRecordPolicy)
    _sink: Optional[QuarantineSink] = field(default=None, repr=False)

    @property
    def quarantines(self) -> bool:
        return self.bad_records.mode == BadRecordPolicy.QUARANTINE

    def sink(self) -> Optional[QuarantineSink]:
        """The (lazily created, shared) quarantine sidecar writer; None
        under the ``fail`` policy."""
        if not self.quarantines:
            return None
        if self._sink is None:
            self._sink = QuarantineSink(self.bad_records.quarantine_path,
                                        self.bad_records.max_bad_records)
        return self._sink

    def handle_bad_record(self, source: str, location: str, reason: str,
                          record: Any = None, rows: int = 1) -> None:
        """Quarantine or raise, per policy.  Returns iff quarantined."""
        if self.quarantines:
            self.sink().quarantine(source, location, reason, record,
                                   rows=rows)
            return
        raise BadRecordError(source, location, reason)


class RetryingChunkStream:
    """Retry/backoff wrapper over a re-createable chunk stream.

    ``make_stream`` builds a fresh underlying ``ChunkStream``; after a
    transient IO error the wrapper sleeps the policy's backoff, rebuilds
    the stream, fast-skips the ``consumed`` chunks already delivered
    downstream, and resumes.  Attempts are budgeted PER CHUNK (a stream
    that fails on 10 distinct chunks is flaky, not dead), and exhausted
    budgets re-raise the last error with the retry history attached.

    Exposes ``bytes_read`` like the streams it wraps, so the ingest
    profiler's byte accounting is unchanged.
    """

    def __init__(self, make_stream: Callable[[], Iterator],
                 policy: RetryPolicy,
                 on_retry: Optional[Callable[[float], None]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self._make = make_stream
        self._policy = policy
        self._on_retry = on_retry
        self._sleep = sleep
        self._stream = make_stream()
        self._consumed = 0
        self.retries = 0
        self.retry_wait_s = 0.0

    @property
    def bytes_read(self) -> int:
        return int(getattr(self._stream, "bytes_read", 0) or 0)

    def __iter__(self):
        return self

    def _reopen_and_skip(self) -> None:
        self._stream = self._make()
        for _ in range(self._consumed):
            next(self._stream)  # deterministic chunking: exact skip

    def __next__(self):
        attempt = 0
        need_reopen = False
        while True:
            try:
                if need_reopen:
                    # a generator that raised is dead: rebuild + exact skip
                    self._reopen_and_skip()
                    need_reopen = False
                chunk = next(self._stream)
            except StopIteration:
                raise
            except BaseException as exc:
                if (not is_transient_io_error(exc)
                        or attempt + 1 >= self._policy.max_attempts):
                    raise
                wait = self._policy.backoff_s(attempt)
                attempt += 1
                self.retries += 1
                self.retry_wait_s += wait
                if self._on_retry is not None:
                    self._on_retry(wait)
                self._sleep(wait)
                need_reopen = True
                continue
            self._consumed += 1
            return chunk
