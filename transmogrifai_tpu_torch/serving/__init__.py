"""Online model serving — micro-batched, shape-bucketed, backpressured
(counterpart of ``transmogrifai_tpu.serving``).

A saved workflow model, loaded onto the card (or the CPU when the caller
asks), behind a long-lived server that coalesces concurrent requests into
micro-batches padded to power-of-2 buckets, sheds load with structured
503s when its bounded queue fills, and opens a circuit breaker when the
device path keeps failing.

    from transmogrifai_tpu_torch.serving import ModelServer

    server = ModelServer.from_path("/models/titanic", name="titanic")
    with server:                      # warms every shape bucket
        out = server.score([{"age": 31.0, "sex": "male", ...}])

No host rung: the JAX server scores on the numpy host path after a device
error; here a batch whose device scoring raises fails its requests with
the exception (counted in ``deviceErrors``), and while the breaker is open
requests shed with ``ShedResult(reason="breaker_open")``.
``hostFallbacks`` stays in the snapshot and reads 0.  A drift monitor
(``with_drift_monitor``, ``serving/drift.py``) sees every scored batch's
rows and its snapshot joins ``snapshot()["drift"]`` (``/metrics``).  Not
ported yet (ROADMAP Queue A item 6.6): the host rung, per-bucket device
programs and their AOT store, guarded swaps, tenancy, the serving fabric
and spans.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

from ..device import DeviceLike
from .admission import AdmissionController, CircuitBreaker, ShedResult
from .batcher import MicroBatcher
from .executor import BucketedExecutor, bucket_for, bucket_sizes
from .metrics import ServingMetrics
from .registry import ModelEntry, ModelRegistry

__all__ = ["ModelServer", "ModelRegistry", "ModelEntry", "MicroBatcher",
           "BucketedExecutor", "AdmissionController",
           "CircuitBreaker", "ShedResult", "ServingMetrics", "bucket_sizes",
           "bucket_for"]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue A item {item}: serving)")


class ModelServer:
    """Registry + batcher + bucketed executor + breaker for one registry
    name.  The entry (and its executor) is resolved per batch, so a hot
    swap redirects traffic once the new version's buckets are warm."""

    def __init__(self, registry: ModelRegistry, name: str,
                 max_batch: int = 64, max_latency_ms: float = 5.0,
                 max_queue_rows: int = 1024,
                 default_deadline_ms: Optional[float] = None,
                 failure_threshold: int = 3, breaker_reset_s: float = 30.0,
                 warmup_row: Optional[Dict[str, Any]] = None,
                 batch_mode: str = "continuous",
                 device_programs: bool = False, aot_store: Any = None):
        if device_programs or aot_store is not None:
            raise _not_ported("per-bucket device programs and the AOT store",
                              "6.6.2")
        self.registry = registry
        self.name = name
        self.max_batch = int(max_batch)
        #: the device swaps load onto (``from_path``'s)
        self.device: DeviceLike = None
        self.metrics = ServingMetrics()
        self.admission = AdmissionController(
            max_queue_rows=max_queue_rows,
            default_deadline_ms=default_deadline_ms)
        self.breaker = CircuitBreaker(failure_threshold=failure_threshold,
                                      reset_after_s=breaker_reset_s)
        self.batcher = MicroBatcher(
            self._execute, max_batch=max_batch,
            max_latency_ms=max_latency_ms, admission=self.admission,
            metrics=self.metrics, mode=batch_mode)
        self.warmup_row = warmup_row
        self._executors: Dict[int, BucketedExecutor] = {}
        self._exec_lock = threading.Lock()
        self._draining = False
        #: the drift monitor fed every batch's rows (None: no monitor)
        self.drift_monitor = None
        registry.on_swap(self._on_swap)

    def with_drift_monitor(self, monitor) -> "ModelServer":
        """Feed each scored batch's rows to a ``serving.drift.
        DriftMonitor``; its snapshot joins ``snapshot()["drift"]``."""
        self.drift_monitor = monitor
        return self

    def with_guard(self, guard) -> "ModelServer":
        raise _not_ported("the guarded swap", "6.6.4")

    @classmethod
    def from_path(cls, path: str, name: str = "default",
                  registry: Optional[ModelRegistry] = None,
                  device: DeviceLike = None, **kwargs) -> "ModelServer":
        """A server around the saved model at ``path``, loaded onto
        ``device`` (else the default device; no card and no request
        raises)."""
        registry = registry or ModelRegistry()
        server = cls(registry, name, **kwargs)
        server.device = device
        registry.load(name, path, device=device)
        return server

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ModelServer":
        """Warm every shape bucket of the current model, then start the
        dispatch thread."""
        if self.warmup_row is not None:
            self._executor_for(self.registry.get(self.name)).warmup(
                self.warmup_row)
        self.batcher.start()
        return self

    def stop(self, drain: bool = True) -> None:
        self.batcher.close(drain=drain)

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Stop admitting (new submits shed with reason ``"draining"``);
        queued and in-flight batches complete."""
        self._draining = True

    def __enter__(self) -> "ModelServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- scoring -------------------------------------------------------------

    def submit(self, rows: Sequence[Dict[str, Any]],
               timeout_ms: Optional[float] = None) -> "Future[List[Any]]":
        """Queue one request.  A row that is not a dict raises
        ``TypeError`` here, to this caller alone: it never reaches a
        coalesced batch, ``deviceErrors`` or the breaker."""
        rows = list(rows)
        for i, r in enumerate(rows):
            if not isinstance(r, dict):
                raise TypeError(
                    f"ModelServer expects dict rows (raw feature name -> "
                    f"value); row {i} is {type(r).__name__!r}")
        reason = ("draining" if self._draining else "breaker_open"
                  if self.breaker.state == CircuitBreaker.OPEN else None)
        if reason is not None and rows:
            self.metrics.record_shed(len(rows), reason=reason)
            fut: "Future[List[Any]]" = Future()
            fut.set_result([ShedResult(reason=reason) for _ in rows])
            return fut
        return self.batcher.submit(rows, timeout_ms=timeout_ms)

    def score(self, rows: Sequence[Dict[str, Any]],
              timeout_ms: Optional[float] = None,
              wait_s: Optional[float] = 60.0) -> List[Any]:
        """Submit and wait: a score map or a ``ShedResult`` per row; raises
        the batch's exception when its device scoring failed."""
        return self.submit(rows, timeout_ms=timeout_ms).result(timeout=wait_s)

    # -- model lifecycle -----------------------------------------------------

    def swap(self, path: str, device: DeviceLike = None) -> ModelEntry:
        """Hot-swap the served model from a saved directory (onto
        ``device``, else the server's); the incoming version's buckets
        are warmed before it becomes current."""
        return self.registry.load(
            self.name, path, device=device if device is not None
            else self.device)

    def _on_swap(self, entry: ModelEntry) -> None:
        if entry.name != self.name:
            return
        self.metrics.record_hot_swap()
        if self.warmup_row is not None:
            try:
                self._executor_for(entry).warmup(self.warmup_row)
            except Exception:
                pass   # a cold bucket warms on its first batch instead

    def _executor_for(self, entry: ModelEntry) -> BucketedExecutor:
        with self._exec_lock:
            ex = self._executors.get(entry.version)
            if ex is None:
                ex = BucketedExecutor(entry.scorer, max_batch=self.max_batch)
                self._executors = {entry.version: ex}   # drop stale versions
            return ex

    def _execute(self, rows: List[Dict[str, Any]]) -> List[Any]:
        """One batch on the dispatch thread: shed while the breaker holds
        the device path closed; a failure counts and re-raises."""
        if self.drift_monitor is not None:
            self.drift_monitor.observe_rows(rows)
        entry = self.registry.get(self.name)
        executor = self._executor_for(entry)
        if not self.breaker.allow_device():
            self.metrics.record_shed(len(rows), reason="breaker_open")
            return [ShedResult(reason="breaker_open") for _ in rows]
        try:
            out = executor.score(rows)
        except Exception as exc:
            self.metrics.record_device_error(exc)
            if self.breaker.record_failure():
                self.metrics.record_breaker_open()
            raise
        self.breaker.record_success()
        self.metrics.record_batch(
            len(rows), bucket_for(len(rows), executor.buckets)
            if len(rows) <= executor.max_batch else executor.max_batch)
        return out

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        snap = self.metrics.snapshot()
        entry = self.registry.maybe_get(self.name)
        snap["model"] = entry.describe() if entry else None
        snap["breakerState"] = self.breaker.state
        snap["batchMode"] = self.batcher.mode
        if self.batcher.cost_lookup is not None:
            snap["batchCost"] = self.batcher.cost_lookup.snapshot()
        if self.drift_monitor is not None:
            snap["drift"] = self.drift_monitor.snapshot()
        return snap
