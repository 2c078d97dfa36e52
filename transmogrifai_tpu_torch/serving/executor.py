"""Shape-bucketed batch executor (counterpart of
``transmogrifai_tpu.serving.executor``).

Each micro-batch is padded up to a power-of-2 bucket, so the scoring path
sees at most ``log2(max_batch) + 1`` batch shapes, each run once at warmup
(the allocator's blocks and any lazily built state of every shape are
ready before traffic).  Pad rows are copies of a real row and results are
sliced back to the true row count, so padding never leaks into responses.

With ``device_programs=True`` and a model whose predictor has a scoring
spec, each bucket also gets its own program (``serving/aot.py``: an
exported program, and on the card a CUDA graph of it), loaded from the
``AOTStore`` where it holds one; a bucket the store satisfies skips its
warm run.  Accounting (``utils/compile_cache``): a bucket's first run
records a ``compile``, each later run a ``hit``; a failed first run
stays cold and counts nothing.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..utils import compile_cache

__all__ = ["BucketedExecutor", "bucket_sizes", "bucket_for"]


def bucket_sizes(max_batch: int, min_bucket: int = 1) -> List[int]:
    """Power-of-2 ladder ``[min_bucket, ..., max_batch]`` (``max_batch``
    included even when it is not a power of 2)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out: List[int] = []
    b = max(1, int(min_bucket))
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
    ``runs`` counts each bucket's executions, warmup included;
    ``programs`` is the per-bucket program set (None without
    ``device_programs`` or without a scoring spec)."""

    def __init__(self, score_fn: Callable[[List[Dict[str, Any]]],
                                          List[Dict[str, Any]]],
                 max_batch: int = 64, min_bucket: int = 1,
                 cache_key_prefix: str = "serving",
                 model: Any = None, aot_store: Any = None,
                 device_programs: bool = False):
        self.score_fn = score_fn
        self.buckets = bucket_sizes(max_batch, min_bucket)
        self.max_batch = self.buckets[-1]
        self.cache_key_prefix = cache_key_prefix
        self._warm: Dict[int, bool] = {}
        #: guards ``_warm``: a swap's warm-up and the dispatch thread may
        #: run one bucket's first batch at once, counted as one compile
        self._warm_lock = threading.Lock()
        self.runs: Dict[int, int] = {}
        self.programs = None
        if device_programs and model is not None:
            from .aot import program_set_for

            self.programs = program_set_for(
                model, store=aot_store, cache_key_prefix=cache_key_prefix)

    def warmup(self, sample_row: Dict[str, Any],
               buckets: Optional[Sequence[int]] = None) -> Dict[int, float]:
        """Run every bucket once, largest first (the buckets live traffic
        reaches first under load); returns {bucket: seconds}.  A bucket
        whose program the store satisfies is warm once loaded (and, on
        the card, captured): it skips the warm run."""
        timings: Dict[int, float] = {}
        for b in sorted(buckets if buckets is not None else self.buckets,
                        reverse=True):
            t0 = time.perf_counter()
            if (self.programs is not None
                    and self.programs.ensure_bucket(b) == "aot"):
                with self._warm_lock:
                    self._warm[b] = True
                timings[b] = time.perf_counter() - t0
                continue
            self._run_bucket([dict(sample_row)] * b, b)
            timings[b] = time.perf_counter() - t0
        return timings

    @property
    def warm_buckets(self) -> List[int]:
        with self._warm_lock:
            return sorted(self._warm)

    def _cache_key(self, bucket: int) -> str:
        return f"{self.cache_key_prefix}.bucket{bucket}"

    def _run_bucket(self, padded_rows: List[Dict[str, Any]],
                    bucket: int) -> List[Dict[str, Any]]:
        if self.programs is not None:
            from .aot import device_scoring

            # builds a bucket the warmup did not cover, else a lookup
            self.programs.ensure_bucket(bucket)
            with device_scoring():
                out = self.score_fn(padded_rows)
        else:
            out = self.score_fn(padded_rows)
        # counted only after a run that succeeded, once per bucket
        with self._warm_lock:
            first = bucket not in self._warm
            self._warm[bucket] = True
            self.runs[bucket] = self.runs.get(bucket, 0) + 1
        if first:
            compile_cache.record_compile(self._cache_key(bucket))
        else:
            compile_cache.record_hit(self._cache_key(bucket))
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

    def release(self) -> None:
        """Free the programs of a version the server no longer serves."""
        if self.programs is not None:
            self.programs.release()
