"""Online model serving — micro-batched, shape-bucketed, backpressured
(counterpart of ``transmogrifai_tpu.serving``).

A saved workflow model, loaded onto the card (or the CPU when the caller
asks), behind a long-lived server that coalesces concurrent requests into
micro-batches padded to power-of-2 buckets, sheds load with structured
503s when its bounded queue fills, and degrades rather than fails: a batch
whose device scoring raises, and every batch while the circuit breaker is
open, is answered by the host rung, the model's CPU copy at the exact
batch size (``hostFallbacks``, ``lastFallbackReason``; the JAX package's
ladder, ``docs/serving.md``).  The rung engages only after a device error
or while the breaker is open; a server with no card and no request for
the CPU raises as every entry point does.

    from transmogrifai_tpu_torch.serving import ModelServer

    server = ModelServer.from_path("/models/titanic", name="titanic")
    with server:                      # warms every shape bucket
        out = server.score([{"age": 31.0, "sex": "male", ...}])

Opt-in pieces, as in the JAX package: ``device_programs=True`` runs a
linear predictor's scoring through one program per bucket (a CUDA graph
on the card, ``serving/aot.py``), exported once and persisted in an
``AOTStore`` (``aot_store=``: a store, a directory or True for
``TMOG_AOT_CACHE_DIR``) that a fresh replica loads; ``with_guard``
attaches a ``GuardedSwap`` (shadow gates, a pinned rollback target, a
bake window); ``with_drift_monitor`` a ``DriftMonitor``;
``MultiTenantServer`` (``serving/tenancy.py``) runs several models behind
one weighted-fair dispatcher.  Under a trace a request is a
``serve.admit`` span, its batch a ``serve.batch`` span under it and the
scoring a ``serve.execute`` span (``path`` "device" or "host") under that.
The serving fabric (several hosts behind a router) is not ported yet
(ROADMAP Queue A item 6.6.6).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

from ..device import DeviceLike
from ..obs.trace import begin_span, end_span
from ..utils.compile_cache import AOTStore
from .admission import AdmissionController, CircuitBreaker, ShedResult
from .aot import ScoringProgramSet, scoring_digest
from .batcher import MicroBatcher
from .executor import BucketedExecutor, bucket_for, bucket_sizes
from .guarded import GuardedSwap, SwapDecision, SwapGateConfig
from .metrics import ServingMetrics
from .registry import ModelEntry, ModelRegistry

__all__ = ["ModelServer", "ModelRegistry", "ModelEntry", "MicroBatcher",
           "BucketedExecutor", "AdmissionController", "CircuitBreaker",
           "ShedResult", "ServingMetrics", "bucket_sizes", "bucket_for",
           "GuardedSwap", "SwapGateConfig", "SwapDecision",
           "AOTStore", "ScoringProgramSet", "scoring_digest",
           "MultiTenantServer", "TenantConfig"]


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
                 device_programs: bool = False, aot_store: Any = None,
                 cost_lookup: Any = None):
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
        #: opt-in per-bucket scoring programs (``serving/aot.py``), kept in
        #: ``aot_store`` (a store, a directory, or True for the default
        #: directory; None: exported each process, not kept)
        self.device_programs = bool(device_programs)
        if aot_store is True:
            aot_store = AOTStore()
        elif isinstance(aot_store, str):
            aot_store = AOTStore(aot_store)
        self.aot_store = aot_store
        self.batcher = MicroBatcher(
            self._execute, max_batch=max_batch,
            max_latency_ms=max_latency_ms, admission=self.admission,
            metrics=self.metrics, mode=batch_mode, cost_lookup=cost_lookup)
        self.warmup_row = warmup_row
        self._executors: Dict[int, BucketedExecutor] = {}
        self._exec_lock = threading.Lock()
        self._draining = False
        #: the drift monitor fed every batch's rows (None: no monitor)
        self.drift_monitor = None
        #: the guarded-swap controller fed every batch's rows (None: none)
        self.guard = None
        registry.on_swap(self._on_swap)

    def with_drift_monitor(self, monitor) -> "ModelServer":
        """Feed each scored batch's rows to a ``serving.drift.
        DriftMonitor``; its snapshot joins ``snapshot()["drift"]``."""
        self.drift_monitor = monitor
        return self

    def with_guard(self, guard: GuardedSwap) -> "ModelServer":
        """Attach a ``GuardedSwap``: live traffic fills its replay window
        and drives its bake probes, it shares this server's metrics (its
        gate and rollback counters land in the same ledger), and its
        snapshot and the registry's generations join ``snapshot()``."""
        guard.metrics = self.metrics
        self.guard = guard
        return self

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
        """Warm every shape bucket of the current model (capturing its
        programs where ``device_programs``), then start the dispatch
        thread."""
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
        coalesced batch, ``deviceErrors`` or the breaker.  A draining
        server sheds; an open breaker does not (its batches degrade to the
        host rung)."""
        rows = list(rows)
        for i, r in enumerate(rows):
            if not isinstance(r, dict):
                raise TypeError(
                    f"ModelServer expects dict rows (raw feature name -> "
                    f"value); row {i} is {type(r).__name__!r}")
        admit = begin_span("serve.admit", cat="serve", rows=len(rows))
        if self._draining and rows:
            self.metrics.record_shed(len(rows), reason="draining")
            end_span(admit, outcome="shed:draining")
            fut: "Future[List[Any]]" = Future()
            fut.set_result([ShedResult(reason="draining") for _ in rows])
            return fut
        return self.batcher.submit(rows, timeout_ms=timeout_ms,
                                   admit_span=admit)

    def score(self, rows: Sequence[Dict[str, Any]],
              timeout_ms: Optional[float] = None,
              wait_s: Optional[float] = 60.0) -> List[Any]:
        """Submit and wait: a score map or a ``ShedResult`` per row."""
        return self.submit(rows, timeout_ms=timeout_ms).result(timeout=wait_s)

    # -- model lifecycle -----------------------------------------------------

    def swap(self, path: str, device: DeviceLike = None) -> ModelEntry:
        """Hot-swap the served model from a saved directory (onto
        ``device``, else the server's); the incoming version's buckets
        are warmed by the swap listener."""
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
                ex = BucketedExecutor(
                    entry.scorer, max_batch=self.max_batch,
                    cache_key_prefix=f"serving.{entry.name}.v{entry.version}",
                    model=entry.model if self.device_programs else None,
                    aot_store=self.aot_store,
                    device_programs=self.device_programs)
                stale = list(self._executors.values())
                self._executors = {entry.version: ex}   # drop stale versions
            else:
                stale = []
        for old in stale:
            old.release()   # a stale version's graphs free their memory
        return ex

    def _execute(self, rows: List[Dict[str, Any]]) -> List[Any]:
        """One batch on the dispatch thread: the device path while the
        breaker allows it; after a device error, or while the breaker is
        open, the host rung at the exact batch size (a model with no host
        rung fails the batch instead)."""
        if self.drift_monitor is not None:
            self.drift_monitor.observe_rows(rows)
        if self.guard is not None:
            self.guard.record_traffic(rows)
        entry = self.registry.get(self.name)
        executor = self._executor_for(entry)
        bucket = (bucket_for(len(rows), executor.buckets)
                  if len(rows) <= executor.max_batch else executor.max_batch)
        fallback_reason = "breaker_open"
        if self.breaker.allow_device():
            sp = begin_span("serve.execute", cat="serve", rows=len(rows),
                            bucket=bucket, path="device",
                            version=entry.version)
            t0 = time.perf_counter()
            try:
                out = executor.score(rows)
                self.breaker.record_success()
                self.metrics.record_batch(len(rows), bucket,
                                          time.perf_counter() - t0)
                end_span(sp)
                return out
            except Exception as exc:
                fallback_reason = f"device_error:{type(exc).__name__}"
                end_span(sp, error=fallback_reason)
                self.metrics.record_device_error(exc)
                if self.breaker.record_failure():
                    self.metrics.record_breaker_open()
                if entry.host_scorer is None:
                    raise
        if entry.host_scorer is None:
            raise RuntimeError(
                f"{self.name} v{entry.version}: the breaker is open and "
                f"the model has no host rung ({entry.host_unavailable})")
        # the degradation ladder's host rung: the model's CPU copy, at the
        # exact batch size, never inside device_scoring()
        self.metrics.record_host_fallback(len(rows), reason=fallback_reason)
        sp = begin_span("serve.execute", cat="serve", rows=len(rows),
                        bucket=bucket, path="host", reason=fallback_reason,
                        version=entry.version)
        t0 = time.perf_counter()
        try:
            out = entry.host_scorer(rows)
        finally:
            end_span(sp)
        self.metrics.record_batch(len(rows), bucket,
                                  time.perf_counter() - t0)
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
        if self.device_programs and entry is not None:
            with self._exec_lock:
                ex = self._executors.get(entry.version)
            if ex is not None and ex.programs is not None:
                snap["aotPrograms"] = ex.programs.modes
        if self.drift_monitor is not None:
            snap["drift"] = self.drift_monitor.snapshot()
        if self.guard is not None:
            snap["guardedSwap"] = self.guard.snapshot()
            snap["generations"] = self.registry.generations(self.name)
        return snap


# imported last: tenancy composes ModelServer instances per tenant
from .tenancy import MultiTenantServer, TenantConfig  # noqa: E402

#: the JAX package's fabric names (several hosts behind a router)
_FABRIC = ("ServingFabric", "HashRing", "LocalHostHandle", "HttpHostHandle",
           "ControlChannel", "FleetSwapController")


def __getattr__(name: str):
    if name in _FABRIC:
        raise NotImplementedError(
            f"{name}: the serving fabric is not ported yet (ROADMAP Queue "
            f"A item 6.6.6)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
