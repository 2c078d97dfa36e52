"""Serving metrics — queue depth, batch-size histogram, latency quantiles
(counterpart of ``transmogrifai_tpu.serving.metrics``).

The snapshot has the JAX package's keys: the queue, the batch-size
histogram, latency quantiles, sheds, device errors, the host rung's
fallbacks and the reason of the last one, the guarded swap's decisions
and rollbacks, and the process's compile-cache counters
(``compileCache``), plus the port's ``lastDeviceError``.  Each executed
batch's wall is also recorded under ``OpStep.Serving`` in the thread's
``MetricsCollector``, if one is installed, and counted in the run ledger
under ``serving.batch``.  Latencies are ``time.perf_counter`` intervals
that end once a batch's results are on the host.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..obs.flight import record_event
from ..utils.profiling import OpStep, count_launch, current_collector

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
    """Thread-safe counters and histograms of one model server: the
    queue, the batches the coalescer forms, their padding, latency
    quantiles, and each rung of the degradation ladder (sheds, device
    errors, host fallbacks, the breaker) and of the guarded swap."""

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
        self.host_fallbacks = 0
        self.breaker_opens = 0
        self.hot_swaps = 0
        #: "<ExceptionType>: message" of the last failed device batch
        self.last_device_error: Optional[str] = None
        #: why the last host fallback engaged ("breaker_open" or
        #: "device_error:<ExceptionType>") and when: why a replica is slow
        self.last_fallback_reason: Optional[str] = None
        self.last_fallback_at: Optional[float] = None
        #: the guarded swap's gate outcomes and rollbacks, with reasons
        self.swaps_accepted = 0
        self.swaps_rejected = 0
        self.rollbacks = 0
        self.last_swap_decision: Optional[Dict[str, Any]] = None
        self.last_rollback_reason: Optional[str] = None
        self.last_rollback_at: Optional[float] = None

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = depth
            self.queue_depth_peak = max(self.queue_depth_peak, depth)

    def record_admitted(self, n_rows: int) -> None:
        with self._lock:
            self.requests += 1
            self.rows += n_rows

    def record_batch(self, n_rows: int, bucket: int, seconds: float) -> None:
        """One executed micro-batch: ``n_rows`` real rows padded to
        ``bucket`` in ``seconds``, recorded under ``OpStep.Serving`` and
        counted in the run ledger under ``serving.batch``."""
        with self._lock:
            self.batches += 1
            self.padded_rows += max(0, bucket - n_rows)
            self._batch_hist[bucket] = self._batch_hist.get(bucket, 0) + 1
        coll = current_collector()
        if coll is not None:
            coll.record(OpStep.Serving, seconds)
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

    def record_host_fallback(self, n_rows: int = 0,
                             reason: Optional[str] = None) -> None:
        """One batch of ``n_rows`` answered by the host rung."""
        with self._lock:
            self.host_fallbacks += 1
            if reason is not None:
                self.last_fallback_reason = reason
                self.last_fallback_at = time.time()

    def record_breaker_open(self) -> None:
        with self._lock:
            self.breaker_opens += 1

    def record_hot_swap(self) -> None:
        with self._lock:
            self.hot_swaps += 1

    def record_swap_decision(self, decision: Dict[str, Any]) -> None:
        """One guarded-swap gate outcome (``SwapDecision.to_json()``)."""
        with self._lock:
            if decision.get("accepted"):
                self.swaps_accepted += 1
            else:
                self.swaps_rejected += 1
            self.last_swap_decision = decision

    def record_rollback(self, reason: str) -> None:
        with self._lock:
            self.rollbacks += 1
            self.last_rollback_reason = reason
            self.last_rollback_at = time.time()

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time JSON-able view (the ``/metrics`` payload)."""
        from ..utils.compile_cache import cache_stats

        now = time.time()

        def age(at):
            return None if at is None else round(now - at, 3)

        with self._lock:
            snap = {
                "uptimeSecs": round(now - self.started_at, 3),
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
                "lastFallbackReason": self.last_fallback_reason,
                "lastFallbackAgeSecs": age(self.last_fallback_at),
                "swapsAccepted": self.swaps_accepted,
                "swapsRejected": self.swaps_rejected,
                "rollbacks": self.rollbacks,
                "lastSwapDecision": self.last_swap_decision,
                "lastRollbackReason": self.last_rollback_reason,
                "lastRollbackAgeSecs": age(self.last_rollback_at),
                "lastDeviceError": self.last_device_error,
            }
        snap["compileCache"] = cache_stats()
        return snap
