"""Chunked-ingestion counters of an out-of-core train (counterpart of
``transmogrifai_tpu.utils.profiling``'s ``IngestPass`` and
``IngestProfiler``; the plan profiler waits for ROADMAP Queue A item
6.5, and the retry, quarantine and checkpoint counters for the features
that fill them, items 6.3 and 6.5).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["IngestPass", "IngestProfiler"]

#: per-pass chunk records kept verbatim (bounds the profiler's memory)
_INGEST_CHUNK_DETAIL_CAP = 512


@dataclass
class IngestPass:
    """One pass of the out-of-core driver over the reader or over the
    retained blocks (``workflow/streaming.py``).

    ``read_s`` is the parse time on the prefetch thread, ``transform_s``
    the stage time on the consuming thread; with the two overlapped the
    wall approaches the larger, and ``overlap_efficiency`` is the share of
    the smaller one that was hidden (1.0 fully, 0.0 not at all)."""

    label: str
    chunks: int = 0
    rows: int = 0
    bytes_read: int = 0
    read_s: float = 0.0
    transform_s: float = 0.0
    wall_s: float = 0.0
    #: the first _INGEST_CHUNK_DETAIL_CAP chunks as [rows, read_s,
    #: transform_s]
    chunk_detail: List[List[float]] = field(default_factory=list)

    def note_read(self, rows: int, seconds: float, nbytes: int = 0) -> None:
        self.chunks += 1
        self.rows += rows
        self.read_s += seconds
        self.bytes_read += int(nbytes)
        if len(self.chunk_detail) < _INGEST_CHUNK_DETAIL_CAP:
            self.chunk_detail.append([rows, round(seconds, 6), 0.0])

    def note_transform(self, chunk_index: int, seconds: float) -> None:
        self.transform_s += seconds
        if chunk_index < len(self.chunk_detail):
            self.chunk_detail[chunk_index][2] = round(seconds, 6)

    @property
    def overlap_efficiency(self) -> float:
        smaller = min(self.read_s, self.transform_s)
        if smaller <= 0 or self.wall_s <= 0:
            return 0.0
        hidden = self.read_s + self.transform_s - self.wall_s
        return max(0.0, min(1.0, hidden / smaller))

    @property
    def rows_per_s(self) -> float:
        return self.rows / self.wall_s if self.wall_s > 0 else 0.0

    def to_json(self) -> Dict[str, Any]:
        return {
            "label": self.label, "chunks": self.chunks, "rows": self.rows,
            "bytesRead": self.bytes_read,
            "readSecs": round(self.read_s, 4),
            "transformSecs": round(self.transform_s, 4),
            "wallSecs": round(self.wall_s, 4),
            "rowsPerSec": round(self.rows_per_s, 1),
            "overlapEfficiency": round(self.overlap_efficiency, 3),
            "chunkDetail": [list(c) for c in self.chunk_detail],
        }


class IngestProfiler:
    """The counters of one out-of-core train: an ``IngestPass`` a pass,
    the chunk geometry, the retained bytes spilled to disk and the
    RawFeatureFilter's profile pass (``rff``: its passes, rows and
    seconds; None without a filter)."""

    def __init__(self, chunk_rows: int = 0):
        self.chunk_rows = chunk_rows
        self.passes: List[IngestPass] = []
        #: bytes of retained blocks the fused pass spilled to disk
        #: (``workflow/streaming._BlockStore``; 0 = none)
        self.spilled_bytes: int = 0
        self.rff: Optional[Dict[str, Any]] = None
        self._lock = threading.Lock()

    def begin_pass(self, label: str) -> IngestPass:
        p = IngestPass(label=label)
        with self._lock:
            self.passes.append(p)
        return p

    @property
    def total_rows(self) -> int:
        return max((p.rows for p in self.passes), default=0)

    @property
    def total_bytes(self) -> int:
        return max((p.bytes_read for p in self.passes), default=0)

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "chunkRows": self.chunk_rows,
                "rows": self.total_rows,
                "bytesRead": self.total_bytes,
                "spilledBytes": self.spilled_bytes,
                "rff": self.rff,
                "passes": [p.to_json() for p in self.passes],
            }

    def format(self) -> str:
        with self._lock:
            passes = list(self.passes)
        lines = [f"chunked ingest: {len(passes)} passes, "
                 f"chunk_rows={self.chunk_rows}, rows={self.total_rows}, "
                 f"bytes={self.total_bytes}"]
        for p in passes:
            lines.append(
                f"  {p.label}: {p.chunks} chunks, {p.rows} rows, "
                f"{p.wall_s:.3f}s wall (read {p.read_s:.3f}s | transform "
                f"{p.transform_s:.3f}s), {p.rows_per_s:,.0f} rows/s, "
                f"overlap {p.overlap_efficiency:.0%}"
                + (f", {p.bytes_read} bytes" if p.bytes_read else ""))
        if self.spilled_bytes:
            lines.append(f"  spilled: {self.spilled_bytes} bytes")
        return "\n".join(lines)
