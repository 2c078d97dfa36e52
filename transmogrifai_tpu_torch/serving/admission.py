"""Admission control — backpressure, deadlines and the device circuit
breaker (counterpart of ``transmogrifai_tpu.serving.admission``).

Degradation ladder of the port:
  1. coalesce   the micro-batcher amortizes dispatch overhead
  2. queue      bounded; absorbs bursts up to ``max_queue_rows``
  3. shed       over-capacity / past-deadline requests get ``ShedResult``
  4. degrade    a batch whose device scoring raises, and every batch while
                consecutive failures hold the breaker open, is answered
                by the host rung: the model's CPU copy at the exact batch
                size (``ModelServer._execute``, ``hostFallbacks``)

The admission and breaker locks are leaf locks: every ``with self._lock``
region is a few field reads and writes with no calls out.  The breaker's
transitions are ``breaker.open``/``.half_open``/``.closed`` flight
events, recorded after the lock is released.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional

from ..obs.flight import record_event

__all__ = ["ShedResult", "AdmissionController", "CircuitBreaker"]


@dataclasses.dataclass
class ShedResult:
    """Structured load-shed response (the 503 analogue), returned as the
    result of every row of a shed request."""

    status: int = 503
    reason: str = "overloaded"
    queue_depth: Optional[int] = None
    retry_after_ms: Optional[float] = None

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"status": self.status, "reason": self.reason}
        if self.queue_depth is not None:
            out["queueDepth"] = self.queue_depth
        if self.retry_after_ms is not None:
            out["retryAfterMs"] = round(self.retry_after_ms, 3)
        return out


class AdmissionController:
    """Bounded-queue admission, accounted in rows (the unit of device
    work): admit, or shed with a ``ShedResult``."""

    def __init__(self, max_queue_rows: int = 1024,
                 default_deadline_ms: Optional[float] = None):
        self.max_queue_rows = int(max_queue_rows)
        self.default_deadline_ms = default_deadline_ms
        self._lock = threading.Lock()
        self._queued_rows = 0

    @property
    def queued_rows(self) -> int:
        with self._lock:
            return self._queued_rows

    def try_admit(self, n_rows: int,
                  est_drain_ms: Optional[float] = None
                  ) -> Optional[ShedResult]:
        """Reserve room for ``n_rows``; a ``ShedResult`` means no (the
        caller must neither enqueue nor ``release``)."""
        with self._lock:
            if self._queued_rows + n_rows > self.max_queue_rows:
                return ShedResult(reason="queue_full",
                                  queue_depth=self._queued_rows,
                                  retry_after_ms=est_drain_ms)
            self._queued_rows += n_rows
            return None

    def release(self, n_rows: int) -> None:
        """Return room once the rows left the queue (scored or shed)."""
        with self._lock:
            self._queued_rows = max(0, self._queued_rows - n_rows)

    def deadline_for(self, timeout_ms: Optional[float]) -> Optional[float]:
        """Absolute ``time.perf_counter`` deadline of a request, or None."""
        t = timeout_ms if timeout_ms is not None else self.default_deadline_ms
        return None if t is None else time.perf_counter() + t / 1000.0


class CircuitBreaker:
    """Consecutive-failure breaker over the device scoring path.

    CLOSED    the device path in use; ``failure_threshold`` failures in a
              row open the breaker.
    OPEN      no batch reaches the device for ``reset_after_s`` (each
              goes to the host rung).
    HALF_OPEN one trial batch goes through: success closes the breaker,
              failure re-opens it (a fresh cooldown).
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, failure_threshold: int = 3,
                 reset_after_s: float = 30.0):
        self.failure_threshold = int(failure_threshold)
        self.reset_after_s = float(reset_after_s)
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._trial_in_flight = False

    @property
    def state(self) -> str:
        with self._lock:
            half = self._maybe_half_open_locked()
            state = self._state
        if half:
            record_event("breaker.half_open")
        return state

    def _maybe_half_open_locked(self) -> bool:
        """Move an expired OPEN to HALF_OPEN; True when it moved."""
        if (self._state == self.OPEN and self._opened_at is not None
                and time.monotonic() - self._opened_at >= self.reset_after_s):
            self._state = self.HALF_OPEN
            self._trial_in_flight = False
            return True
        return False

    def allow_device(self) -> bool:
        """May the next batch use the device path?"""
        with self._lock:
            half = self._maybe_half_open_locked()
            if self._state == self.CLOSED:
                allowed = True
            elif self._state == self.HALF_OPEN and not self._trial_in_flight:
                self._trial_in_flight = True   # exactly one trial batch
                allowed = True
            else:
                allowed = False
        if half:
            record_event("breaker.half_open")
        return allowed

    def record_success(self) -> None:
        with self._lock:
            reclosed = self._state != self.CLOSED
            self._state = self.CLOSED
            self._consecutive_failures = 0
            self._opened_at = None
            self._trial_in_flight = False
        if reclosed:
            record_event("breaker.closed")

    def record_failure(self) -> bool:
        """Register a device-path failure; True when the breaker opened on
        this call."""
        opened = False
        with self._lock:
            self._consecutive_failures += 1
            was_open = self._state == self.OPEN
            if (self._state == self.HALF_OPEN
                    or self._consecutive_failures >= self.failure_threshold):
                self._state = self.OPEN
                self._opened_at = time.monotonic()
                self._trial_in_flight = False
                opened = not was_open
        if opened:
            record_event("breaker.open", failures=self.failure_threshold)
        return opened
