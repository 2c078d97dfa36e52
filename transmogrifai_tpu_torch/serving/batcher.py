"""Admission queue + micro-batcher (counterpart of
``transmogrifai_tpu.serving.batcher``).

Concurrent callers submit small row lists; one dispatch thread coalesces
them into micro-batches and runs ``execute`` (rows -> results) on them —
the thread that runs the scoring's torch ops.  Two formation modes:

``continuous`` (default)
    The next batch forms the moment the executor frees.  Under a burst
    (the recent arrival rate projects a full ``max_batch`` within twice
    ``max_latency_ms``) the batch targets the full bucket and stays open
    for late arrivals up to the projected fill time, capped at
    ``max_latency_ms``; otherwise it dispatches now, at the bucket that
    maximizes rows per predicted second (``BatchCostLookup``: an EWMA of
    measured batch walls).  A near-full batch latches the burst mode; a
    hold that expires nearly empty unlatches it.
``windowed``
    Coalesce up to ``max_batch`` rows or until the oldest waiting request
    has waited ``max_latency_ms``.

A request is never split across batches.  Shed and expired requests
resolve to ``ShedResult``s; a batch whose ``execute`` raises fails its
requests' futures with the exception.  ``close(drain=True)`` sheds new
submits as ``shutting_down`` and drains under the lock until the queue is
observably empty.

Under a trace (``obs/trace.py``) a request's ``serve.admit`` span (opened
by ``ModelServer.submit``, else none) rides on its pending entry, and the
dispatch thread opens each batch's ``serve.batch`` span under the admit
span of the batch's first request, so that admit, batch and execute nest
across the two threads.
"""
from __future__ import annotations

import math
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..obs.trace import begin_span, end_span
from .admission import AdmissionController, ShedResult
from .executor import bucket_for, bucket_sizes
from .metrics import ServingMetrics

__all__ = ["MicroBatcher", "BatchCostLookup", "run_pending_batch"]

#: the analytic batch cost: a dispatch floor plus a per-row cost (seconds)
_FLOOR_S, _ROW_S = 1e-4, 2e-5


class BatchCostLookup:
    """Predicted wall seconds of one batch per bucket: the EWMA of the
    measured walls where a bucket was measured; else the nearest measured
    bucket's level scaled by the analytic law's slope; else the analytic
    law (the JAX package's ``ServingCostLookup`` without its fitted
    cost-model tier)."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self._ewma: Dict[int, float] = {}
        self._counts: Dict[int, int] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _analytic(bucket: int) -> float:
        return _FLOOR_S + bucket * _ROW_S

    def observe(self, bucket: int, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            prev = self._ewma.get(bucket)
            self._ewma[bucket] = seconds if prev is None else (
                self.alpha * seconds + (1.0 - self.alpha) * prev)
            self._counts[bucket] = self._counts.get(bucket, 0) + 1

    def predict_s(self, bucket: int) -> float:
        with self._lock:
            ewma = dict(self._ewma)
        if bucket in ewma:
            return max(ewma[bucket], _FLOOR_S)
        if ewma:
            near = min(ewma, key=lambda b: abs(math.log(b / bucket)))
            return max(ewma[near] * self._analytic(bucket)
                       / self._analytic(near), _FLOOR_S)
        return self._analytic(bucket)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"ewmaMs": {str(b): round(v * 1000.0, 4)
                               for b, v in sorted(self._ewma.items())},
                    "observedBatches": {str(b): c for b, c in
                                        sorted(self._counts.items())}}


class _Pending:
    __slots__ = ("rows", "future", "deadline", "enqueued_at", "span")

    def __init__(self, rows: List[Dict[str, Any]],
                 deadline: Optional[float], span=None):
        self.rows = rows
        self.future: "Future[List[Any]]" = Future()
        self.deadline = deadline
        self.enqueued_at = time.perf_counter()
        #: the request's serve.admit span: the parent of its batch's span
        self.span = span


class MicroBatcher:
    def __init__(self, execute: Callable[[List[Dict[str, Any]]], List[Any]],
                 max_batch: int = 64, max_latency_ms: float = 5.0,
                 admission: Optional[AdmissionController] = None,
                 metrics: Optional[ServingMetrics] = None,
                 mode: str = "continuous"):
        if mode not in ("continuous", "windowed"):
            raise ValueError(
                f"mode must be 'continuous' or 'windowed', got {mode!r}")
        self.execute = execute
        self.max_batch = int(max_batch)
        self.max_latency_s = float(max_latency_ms) / 1000.0
        self.admission = admission or AdmissionController()
        self.metrics = metrics or ServingMetrics()
        self.mode = mode
        #: the continuous mode's per-bucket batch-cost estimates
        self.cost_lookup = (BatchCostLookup() if mode == "continuous"
                            else None)
        self._buckets = bucket_sizes(self.max_batch)
        #: recent arrivals (perf_counter t, rows), for the burst probe
        self._arrivals: List[Tuple[float, int]] = []
        self._saturated = False
        self._queue: List[_Pending] = []
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._closing = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "MicroBatcher":
        if self._thread is None or not self._thread.is_alive():
            self._closing = False
            self._closed = False
            target = (self._dispatch_continuous if self.mode == "continuous"
                      else self._dispatch_windowed)
            self._thread = threading.Thread(
                target=target, name="op-serving-batcher", daemon=True)
            self._thread.start()
        return self

    def close(self, drain: bool = True, timeout_s: float = 10.0) -> None:
        """Stop the dispatch thread, by default after draining the queue
        (under the lock: no request enqueued before the close is
        dropped)."""
        alive = self._thread is not None and self._thread.is_alive()
        with self._work:
            self._closing = True
            if drain and alive:
                deadline = time.perf_counter() + timeout_s
                while self._queue:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._work.wait(timeout=min(remaining, 0.005))
            self._closed = True
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    # -- submission ---------------------------------------------------------

    def submit(self, rows: Sequence[Dict[str, Any]],
               timeout_ms: Optional[float] = None,
               admit_span=None) -> "Future[List[Any]]":
        """Enqueue ``rows``; the future resolves with their results, or a
        ``ShedResult`` per row when the request is shed.  ``admit_span``
        (the caller's ``serve.admit``) is closed here with the outcome
        and parents the request's batch span."""
        rows = list(rows)
        fut: "Future[List[Any]]" = Future()
        if not rows:
            end_span(admit_span, outcome="empty")
            fut.set_result([])
            return fut
        if self._closing or self._closed:
            return self._shed(fut, rows, ShedResult(reason="shutting_down"),
                              admit_span)
        shed = self.admission.try_admit(len(rows),
                                        est_drain_ms=self._est_drain_ms())
        if shed is not None:
            return self._shed(fut, rows, shed, admit_span)
        pending = _Pending(rows, self.admission.deadline_for(timeout_ms),
                           admit_span)
        with self._work:
            if self._closing or self._closed:
                # the close raced the unlocked check: give the room back
                self.admission.release(len(rows))
                return self._shed(fut, rows,
                                  ShedResult(reason="shutting_down"),
                                  admit_span)
            self.metrics.record_admitted(len(rows))
            self._queue.append(pending)
            self._arrivals.append((pending.enqueued_at, len(rows)))
            if len(self._arrivals) > 256:
                del self._arrivals[:128]
            self.metrics.set_queue_depth(sum(len(p.rows)
                                             for p in self._queue))
            self._work.notify()
        end_span(admit_span, outcome="admitted")
        return pending.future

    def _shed(self, fut: "Future[List[Any]]", rows: list,
              shed: ShedResult, admit_span=None) -> "Future[List[Any]]":
        self.metrics.record_shed(len(rows), reason=shed.reason)
        end_span(admit_span, outcome=f"shed:{shed.reason}")
        fut.set_result([shed for _ in rows])
        return fut

    def _est_drain_ms(self) -> Optional[float]:
        """Retry-after hint: predicted batch wall per queued batch."""
        with self._lock:
            queued = sum(len(p.rows) for p in self._queue)
        if queued == 0:
            return None
        per_batch_s = (self.cost_lookup.predict_s(self.max_batch)
                       if self.cost_lookup is not None
                       else self.max_latency_s)
        return -(-queued // self.max_batch) * per_batch_s * 1000.0

    # -- batch formation ----------------------------------------------------

    def _take_batch_locked(self, target: Optional[int] = None,
                           strict: bool = False) -> List[_Pending]:
        """Pop requests FIFO up to the row budget, never splitting one; an
        oversized first request is taken anyway (the executor chunks)
        unless ``strict`` (late admission into a chosen bucket)."""
        budget = self.max_batch if target is None else target
        batch: List[_Pending] = []
        rows = 0
        while self._queue:
            nxt = self._queue[0]
            if (batch or strict) and rows + len(nxt.rows) > budget:
                break
            batch.append(self._queue.pop(0))
            rows += len(nxt.rows)
            if rows >= budget:
                break
        return batch

    def _arrival_rate_locked(self) -> float:
        """Rows per second over the most recent 16 submits; 0 when fewer
        than 4 arrived or the last is older than 20 ms (no burst)."""
        if len(self._arrivals) < 4:
            return 0.0
        now = time.perf_counter()
        recent = self._arrivals[-16:]
        if now - recent[-1][0] > 0.02:
            return 0.0
        return sum(n for _, n in recent) / max(now - recent[0][0], 5e-4)

    def _formation_locked(self, queued_rows: int) -> Tuple[int, float]:
        """(target bucket, seconds to hold the batch open)."""
        deficit = self.max_batch - queued_rows
        if deficit <= 0:
            return self.max_batch, 0.0
        rate = self._arrival_rate_locked()
        if rate > 0 and deficit / rate <= 2.0 * self.max_latency_s:
            return self.max_batch, min(deficit / rate * 1.25,
                                       self.max_latency_s)
        if self._saturated:
            return self.max_batch, self.max_latency_s
        return self._choose_bucket(queued_rows), 0.0

    def _choose_bucket(self, queued_rows: int) -> int:
        """The dispatch-now bucket with the most rows per predicted
        second."""
        best_b, best_rate = self._buckets[0], -1.0
        for b in self._buckets:
            servable = min(queued_rows, b)
            if servable <= 0:
                break
            cost = self.cost_lookup.predict_s(b)
            if servable / max(cost, 1e-9) >= best_rate:
                best_rate, best_b = servable / max(cost, 1e-9), b
        return best_b

    # -- dispatch -----------------------------------------------------------

    def _dispatch_continuous(self) -> None:
        while True:
            with self._work:
                while not self._queue and not self._closed:
                    self._work.wait(timeout=0.1)
                if self._closed and not self._queue:
                    return
                queued = sum(len(p.rows) for p in self._queue)
                target, fill_wait = self._formation_locked(queued)
                batch = self._take_batch_locked(target)
                rows = sum(len(p.rows) for p in batch)
                if rows < target and fill_wait > 0 and not self._closing:
                    deadline = time.perf_counter() + fill_wait
                    while rows < target and not self._closing:
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0:
                            break
                        self._work.wait(timeout=remaining)
                        late = self._take_batch_locked(target - rows,
                                                       strict=True)
                        batch += late
                        rows += sum(len(p.rows) for p in late)
                if rows >= self.max_batch // 2:
                    self._saturated = True
                elif fill_wait > 0 and rows < max(1, self.max_batch // 4):
                    self._saturated = False
                self.metrics.set_queue_depth(sum(len(p.rows)
                                                 for p in self._queue))
            if batch:
                self._run_batch(batch)

    def _dispatch_windowed(self) -> None:
        while True:
            with self._work:
                while not self._queue and not self._closed:
                    self._work.wait(timeout=0.1)
                if self._closed and not self._queue:
                    return
                oldest = self._queue[0].enqueued_at
                while (sum(len(p.rows) for p in self._queue) < self.max_batch
                       and not self._closed):
                    remaining = self.max_latency_s - (time.perf_counter()
                                                      - oldest)
                    if remaining <= 0:
                        break
                    self._work.wait(timeout=remaining)
                    if not self._queue:
                        break
                batch = self._take_batch_locked()
                self.metrics.set_queue_depth(sum(len(p.rows)
                                                 for p in self._queue))
            if batch:
                self._run_batch(batch)

    def _run_batch(self, batch: List[_Pending]) -> None:
        n_rows = sum(len(p.rows) for p in batch)
        # the dispatch thread's parent is explicit: the first request's
        # admit span, opened on the submitting thread
        batch_span = begin_span("serve.batch", cat="serve",
                                parent=batch[0].span, requests=len(batch),
                                rows=n_rows, mode=self.mode)
        t0 = time.perf_counter()
        try:
            run_pending_batch(batch, self.execute, self.admission,
                              self.metrics)
        finally:
            if self.cost_lookup is not None:
                self.cost_lookup.observe(
                    bucket_for(min(n_rows, self.max_batch), self._buckets),
                    time.perf_counter() - t0)
            end_span(batch_span)
            with self._work:   # wake a close(drain=True) waiting
                self._work.notify_all()


def run_pending_batch(batch: List[_Pending], execute, admission,
                      metrics) -> None:
    """Resolve one formed batch: expire past-deadline requests, release
    the admission room, execute the live rows and scatter the results
    onto the requests' futures (or the exception, when ``execute``
    raises)."""
    now = time.perf_counter()
    live: List[_Pending] = []
    for p in batch:
        if p.deadline is not None and now > p.deadline:
            metrics.record_deadline_expired(len(p.rows))
            p.future.set_result([ShedResult(reason="deadline_expired")
                                 for _ in p.rows])
        else:
            live.append(p)
    admission.release(sum(len(p.rows) for p in batch))
    if not live:
        return
    rows = [r for p in live for r in p.rows]
    try:
        results = execute(rows)
    except Exception as exc:
        for p in live:
            if not p.future.done():
                p.future.set_exception(exc)
        return
    done = time.perf_counter()
    off = 0
    for p in live:
        p.future.set_result(results[off:off + len(p.rows)])
        off += len(p.rows)
        metrics.record_request_latency(done - p.enqueued_at)
