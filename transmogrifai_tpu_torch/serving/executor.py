"""Shape-bucketed batch executor (counterpart of
``transmogrifai_tpu.serving.executor``).

Each micro-batch is padded up to a power-of-2 bucket, so the scoring path
sees at most ``log2(max_batch) + 1`` batch shapes, each run once at warmup
(the allocator's blocks and any lazily built state of every shape are
ready before traffic).  Pad rows are copies of a real row and results are
sliced back to the true row count, so padding never leaks into responses.

The JAX package's per-bucket compiled programs and their AOT store have no
port yet: ``device_programs=True`` and ``aot_store`` raise
``NotImplementedError`` (the torch analogue, a CUDA graph per bucket, is
in ROADMAP Queue D).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["BucketedExecutor", "bucket_sizes", "bucket_for"]


def bucket_sizes(max_batch: int) -> List[int]:
    """Power-of-2 ladder ``[1, 2, 4, ..., max_batch]`` (``max_batch``
    included even when it is not a power of 2)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out: List[int] = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (buckets ascending; n <= buckets[-1])."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} rows exceeds max bucket {buckets[-1]}")


class BucketedExecutor:
    """Pads micro-batches to shape buckets around ``score_fn`` (rows ->
    score maps, normally ``local.scorer.score_function_batch(model)``).
    ``runs`` counts each bucket's executions, warmup included."""

    def __init__(self, score_fn: Callable[[List[Dict[str, Any]]],
                                          List[Dict[str, Any]]],
                 max_batch: int = 64, aot_store: Any = None,
                 device_programs: bool = False):
        if device_programs or aot_store is not None:
            raise NotImplementedError(
                "per-bucket device programs and the AOT store are not "
                "ported yet (ROADMAP Queue A item 6: serving)")
        self.score_fn = score_fn
        self.buckets = bucket_sizes(max_batch)
        self.max_batch = self.buckets[-1]
        self._warm: Dict[int, bool] = {}
        self.runs: Dict[int, int] = {}

    def warmup(self, sample_row: Dict[str, Any],
               buckets: Optional[Sequence[int]] = None) -> Dict[int, float]:
        """Run every bucket once, largest first (the buckets live traffic
        reaches first under load); returns {bucket: seconds}."""
        timings: Dict[int, float] = {}
        for b in sorted(buckets if buckets is not None else self.buckets,
                        reverse=True):
            t0 = time.perf_counter()
            self._run_bucket([dict(sample_row)] * b, b)
            timings[b] = time.perf_counter() - t0
        return timings

    @property
    def warm_buckets(self) -> List[int]:
        return sorted(self._warm)

    def _run_bucket(self, padded_rows: List[Dict[str, Any]],
                    bucket: int) -> List[Dict[str, Any]]:
        out = self.score_fn(padded_rows)
        # a bucket is warm only after a run that succeeded
        self._warm[bucket] = True
        self.runs[bucket] = self.runs.get(bucket, 0) + 1
        return out

    def score(self, rows: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Score ``rows`` through the bucketed path (chunked past
        ``max_batch``)."""
        rows = list(rows)
        n = len(rows)
        if n == 0:
            return []
        if n > self.max_batch:
            out: List[Dict[str, Any]] = []
            for i in range(0, n, self.max_batch):
                out.extend(self.score(rows[i:i + self.max_batch]))
            return out
        bucket = bucket_for(n, self.buckets)
        padded = rows + [dict(rows[-1]) for _ in range(bucket - n)]
        return self._run_bucket(padded, bucket)[:n]
