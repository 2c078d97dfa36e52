"""Serving metrics — queue depth, batch-size histogram, latency quantiles
(counterpart of ``transmogrifai_tpu.serving.metrics``).

The snapshot keeps the JAX package's keys for what the port's server
fills.  ``hostFallbacks`` stays and always reads 0 (the port has no host
scoring rung); the guarded-swap and fallback-reason keys are left out
with those features.  Latencies are ``time.perf_counter`` intervals that
end once a batch's results are on the host.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..obs.flight import record_event
from ..utils.profiling import count_launch

__all__ = ["LatencyReservoir", "ServingMetrics"]


class LatencyReservoir:
    """Fixed-capacity ring of recent latencies (seconds); quantiles over
    the retained window."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._ring: List[float] = []
        self._pos = 0
        self.count = 0

    def observe(self, seconds: float) -> None:
        if len(self._ring) < self.capacity:
            self._ring.append(seconds)
        else:
            self._ring[self._pos] = seconds
            self._pos = (self._pos + 1) % self.capacity
        self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        if not self._ring:
            return None
        vals = sorted(self._ring)
        return vals[min(len(vals) - 1,
                        max(0, int(round(q * (len(vals) - 1)))))]


class ServingMetrics:
    """Thread-safe counters and histograms of one model server."""

    def __init__(self):
        self._lock = threading.Lock()
        self._latency = LatencyReservoir()
        self._batch_hist: Dict[int, int] = {}
        self.started_at = time.time()
        self.queue_depth = 0
        self.queue_depth_peak = 0
        self.requests = 0
        self.rows = 0
        self.batches = 0
        self.padded_rows = 0
        self.shed = 0
        self.shed_by_reason: Dict[str, int] = {}
        self.deadline_expired = 0
        self.device_errors = 0
        #: the port has no host scoring rung: this stays 0
        self.host_fallbacks = 0
        self.breaker_opens = 0
        self.hot_swaps = 0
        #: "<ExceptionType>: message" of the last failed batch
        self.last_device_error: Optional[str] = None

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = depth
            self.queue_depth_peak = max(self.queue_depth_peak, depth)

    def record_admitted(self, n_rows: int) -> None:
        with self._lock:
            self.requests += 1
            self.rows += n_rows

    def record_batch(self, n_rows: int, bucket: int) -> None:
        """One executed micro-batch: ``n_rows`` real rows padded to
        ``bucket``; counted in the run ledger under ``serving.batch``."""
        with self._lock:
            self.batches += 1
            self.padded_rows += max(0, bucket - n_rows)
            self._batch_hist[bucket] = self._batch_hist.get(bucket, 0) + 1
        count_launch("serving.batch")

    def record_request_latency(self, seconds: float) -> None:
        with self._lock:
            self._latency.observe(seconds)

    def record_shed(self, n: int = 1, reason: Optional[str] = None) -> None:
        """``n`` rows shed (a ``serve.shed`` flight event)."""
        with self._lock:
            self.shed += n
            if reason is not None:
                self.shed_by_reason[reason] = \
                    self.shed_by_reason.get(reason, 0) + n
        record_event("serve.shed", rows=n, reason=reason)

    def record_deadline_expired(self, n: int = 1) -> None:
        with self._lock:
            self.deadline_expired += n

    def record_device_error(self, exc: BaseException) -> None:
        with self._lock:
            self.device_errors += 1
            self.last_device_error = f"{type(exc).__name__}: {exc}"

    def record_breaker_open(self) -> None:
        with self._lock:
            self.breaker_opens += 1

    def record_hot_swap(self) -> None:
        with self._lock:
            self.hot_swaps += 1

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time JSON-able view (the ``/metrics`` payload)."""
        with self._lock:
            return {
                "uptimeSecs": round(time.time() - self.started_at, 3),
                "queueDepth": self.queue_depth,
                "queueDepthPeak": self.queue_depth_peak,
                "requests": self.requests,
                "rows": self.rows,
                "batches": self.batches,
                "paddedRows": self.padded_rows,
                "batchSizeHistogram": dict(sorted(self._batch_hist.items())),
                "latencyMs": {
                    f"p{int(q * 100)}": (None if v is None
                                         else round(v * 1000.0, 3))
                    for q, v in ((q, self._latency.quantile(q))
                                 for q in (0.50, 0.95, 0.99))},
                "latencyObservations": self._latency.count,
                "shed": self.shed,
                "shedByReason": dict(sorted(self.shed_by_reason.items())),
                "deadlineExpired": self.deadline_expired,
                "deviceErrors": self.device_errors,
                "hostFallbacks": self.host_fallbacks,
                "breakerOpens": self.breaker_opens,
                "hotSwaps": self.hot_swaps,
                "lastDeviceError": self.last_device_error,
            }
