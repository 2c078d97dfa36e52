"""Multi-tenant serving — per-tenant quotas, weighted-fair dequeue and
isolation (counterpart of ``transmogrifai_tpu.serving.tenancy``).

One host, one registry, several served models: each tenant has its own
registry name, admission quota, circuit breaker, metrics, bucketed
executors and, optionally, its own drift monitor and guarded swap (its
``ModelServer``, whose batcher never starts).  One dispatch thread
serves every tenant without letting one tenant's behaviour reach
another's:

* **quotas**: admission is per tenant (``max_queue_rows`` each), so a
  flooding tenant sheds its own traffic and only its own;
* **weighted-fair dequeue**: the dispatcher takes the next batch from the
  lane of least virtual time (``vtime += rows / weight``), so under
  saturation each tenant's share of dispatched rows tends to its weight;
  an idle lane that re-enters is clamped up to the virtual clock, so it
  cannot hoard credit;
* **isolation**: a batch never mixes tenants, and each runs its tenant's
  own ladder (``ModelServer._execute``: the breaker, the device path with
  its programs, the host rung), so a breaker, a shed storm or a rollback
  on one tenant touches only that tenant's state;
* **observability**: ``snapshot()`` nests the per-tenant snapshots, and
  the Prometheus text labels every serving sample ``tenant="<name>"``.

Each lane forms its batches continuously: the bucket from its queue depth
and its predicted per-bucket cost (the tenant batcher's
``ServingCostLookup``), requests taken FIFO and never split.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

from ..obs.flight import record_event
from ..obs.trace import begin_span, end_span
from .admission import ShedResult
from .batcher import _Pending, run_pending_batch
from .executor import bucket_for, bucket_sizes
from .registry import ModelEntry, ModelRegistry

__all__ = ["TenantConfig", "MultiTenantServer"]


class TenantConfig:
    """One tenant's serving configuration: ``weight`` is its WFQ share
    (2.0 gets twice the dispatched rows of 1.0 under saturation),
    ``max_queue_rows`` its admission quota, both per tenant."""

    def __init__(self, name: str, weight: float = 1.0,
                 max_batch: int = 64, max_queue_rows: int = 1024,
                 default_deadline_ms: Optional[float] = None,
                 failure_threshold: int = 3,
                 breaker_reset_s: float = 30.0,
                 warmup_row: Optional[Dict[str, Any]] = None):
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        self.name = str(name)
        self.weight = float(weight)
        self.max_batch = int(max_batch)
        self.max_queue_rows = int(max_queue_rows)
        self.default_deadline_ms = default_deadline_ms
        self.failure_threshold = int(failure_threshold)
        self.breaker_reset_s = float(breaker_reset_s)
        self.warmup_row = warmup_row

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "weight": self.weight,
                "maxBatch": self.max_batch,
                "maxQueueRows": self.max_queue_rows}


class _TenantLane:
    """One tenant's state inside the shared dispatcher."""

    def __init__(self, config: TenantConfig, server):
        self.config = config
        #: the tenant's ModelServer; its batcher is never started
        self.server = server
        self.queue: List[_Pending] = []
        self.vtime = 0.0
        self.dispatched_rows = 0
        self.buckets = bucket_sizes(config.max_batch)

    def queued_rows(self) -> int:
        return sum(len(p.rows) for p in self.queue)


class MultiTenantServer:
    """Weighted-fair multi-tenant serving over one shared registry::

        mts = MultiTenantServer(device_programs=True, aot_store=True)
        mts.add_tenant(TenantConfig("ads", weight=3.0), path="/models/ads")
        mts.add_tenant(TenantConfig("risk"), path="/models/risk")
        with mts:
            out = mts.score([{...}], tenant="ads")

    Models load onto the default device (no card and no request for the
    CPU raises)."""

    is_multi_tenant = True

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 device_programs: bool = False, aot_store: Any = None,
                 max_generations: int = 4):
        self.registry = registry or ModelRegistry(
            max_generations=max_generations)
        self.device_programs = device_programs
        self.aot_store = aot_store
        self._lanes: Dict[str, _TenantLane] = {}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._closing = False
        self._closed = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        #: the WFQ virtual clock: the vtime of the lane dispatched last;
        #: a lane that re-enters is clamped up to it
        self._vclock = 0.0

    # -- tenant lifecycle ----------------------------------------------------

    def add_tenant(self, config, path: Optional[str] = None,
                   model: Any = None):
        """Register a tenant (a ``TenantConfig`` or a name) and load or
        register its model; returns the tenant's ``ModelServer`` (the
        handle for ``with_drift_monitor``, ``with_guard``, ``swap``)."""
        from . import ModelServer

        if isinstance(config, str):
            config = TenantConfig(config)
        server = ModelServer(
            self.registry, config.name, max_batch=config.max_batch,
            max_queue_rows=config.max_queue_rows,
            default_deadline_ms=config.default_deadline_ms,
            failure_threshold=config.failure_threshold,
            breaker_reset_s=config.breaker_reset_s,
            warmup_row=config.warmup_row,
            device_programs=self.device_programs,
            aot_store=self.aot_store)
        lane = _TenantLane(config, server)
        with self._lock:
            if config.name in self._lanes:
                raise ValueError(f"tenant {config.name!r} already exists")
            lane.vtime = self._vclock
            self._lanes[config.name] = lane
        if path is not None:
            self.registry.load(config.name, path)
        elif model is not None:
            self.registry.register(config.name, model)
        return server

    def remove_tenant(self, name: str,
                      drain_shed_reason: str = "tenant_removed") -> bool:
        """Drop a tenant: its queued requests shed, its model is evicted;
        the other tenants' queues and state are untouched."""
        with self._work:
            lane = self._lanes.pop(name, None)
            pendings = list(lane.queue) if lane else []
            if lane:
                lane.queue.clear()
        for p in pendings:
            lane.server.admission.release(len(p.rows))
            lane.server.metrics.record_shed(len(p.rows),
                                            reason=drain_shed_reason)
            p.future.set_result(
                [ShedResult(reason=drain_shed_reason) for _ in p.rows])
        self.registry.evict(name)
        return lane is not None

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._lanes)

    def tenant(self, name: str):
        """The tenant's ``ModelServer``."""
        with self._lock:
            lane = self._lanes.get(name)
        if lane is None:
            raise KeyError(f"no tenant {name!r} "
                           f"(have: {self.tenants() or 'none'})")
        return lane.server

    def _lane(self, name: Optional[str]) -> _TenantLane:
        with self._lock:
            have = sorted(self._lanes)
            if name is None:
                if len(self._lanes) == 1:
                    return next(iter(self._lanes.values()))
                raise KeyError(
                    f"tenant is required with {len(self._lanes)} tenants "
                    f"registered (have: {have})")
            lane = self._lanes.get(name)
        if lane is None:
            raise KeyError(f"no tenant {name!r} (have: {have or 'none'})")
        return lane

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MultiTenantServer":
        """Warm every tenant's buckets (largest first; a bucket the store
        satisfies loads), then start the weighted-fair dispatcher."""
        with self._lock:
            lanes = list(self._lanes.values())
        for lane in lanes:
            if lane.config.warmup_row is not None:
                entry = self.registry.get(lane.config.name)
                lane.server._executor_for(entry).warmup(
                    lane.config.warmup_row)
        if self._thread is None or not self._thread.is_alive():
            self._closing = False
            self._closed = False
            self._thread = threading.Thread(
                target=self._dispatch_loop, name="op-serving-wfq",
                daemon=True)
            self._thread.start()
        return self

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Stop admitting on every lane (new submits shed with reason
        ``"draining"``); queued requests still dispatch."""
        self._draining = True

    def stop(self, drain: bool = True, timeout_s: float = 10.0) -> None:
        alive = self._thread is not None and self._thread.is_alive()
        with self._work:
            self._closing = True
            if drain and alive:
                deadline = time.monotonic() + timeout_s
                while any(lane.queue for lane in self._lanes.values()):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._work.wait(timeout=min(remaining, 0.005))
            self._closed = True
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    def __enter__(self) -> "MultiTenantServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- scoring -------------------------------------------------------------

    def _shed(self, fut, server, rows, reason: str, span):
        server.metrics.record_shed(len(rows), reason=reason)
        fut.set_result([ShedResult(reason=reason) for _ in rows])
        end_span(span, outcome=f"shed:{reason}")
        return fut

    def submit(self, rows: Sequence[Dict[str, Any]],
               tenant: Optional[str] = None,
               timeout_ms: Optional[float] = None) -> "Future[List[Any]]":
        """Queue ``rows`` on ``tenant``'s lane (optional with one tenant);
        the future resolves with their results, or a ``ShedResult`` per
        row when the request is shed."""
        lane = self._lane(tenant)
        rows = list(rows)
        fut: "Future[List[Any]]" = Future()
        if not rows:
            fut.set_result([])
            return fut
        for i, r in enumerate(rows):
            if not isinstance(r, dict):
                raise TypeError(
                    f"MultiTenantServer expects dict rows (raw feature "
                    f"name -> value); row {i} is {type(r).__name__!r}")
        server = lane.server
        span = begin_span("serve.admit", cat="serve", rows=len(rows),
                          tenant=lane.config.name)
        if self._draining:
            return self._shed(fut, server, rows, "draining", span)
        if self._closing or self._closed:
            return self._shed(fut, server, rows, "shutting_down", span)
        shed = server.admission.try_admit(len(rows))
        if shed is not None:
            server.metrics.record_shed(len(rows), reason=shed.reason)
            fut.set_result([shed for _ in rows])
            end_span(span, outcome=f"shed:{shed.reason}")
            record_event("serve.shed", rows=len(rows), reason=shed.reason,
                         tenant=lane.config.name)
            return fut
        pending = _Pending(rows, server.admission.deadline_for(timeout_ms),
                           span)
        with self._work:
            if self._closing or self._closed:
                server.admission.release(len(rows))
                return self._shed(fut, server, rows, "shutting_down", span)
            if not lane.queue:
                # an idle lane re-entering: clamped to the virtual clock
                lane.vtime = max(lane.vtime, self._vclock)
            server.metrics.record_admitted(len(rows))
            lane.queue.append(pending)
            server.metrics.set_queue_depth(lane.queued_rows())
            self._work.notify()
        end_span(span, outcome="admitted")
        return pending.future

    def score(self, rows: Sequence[Dict[str, Any]],
              tenant: Optional[str] = None,
              timeout_ms: Optional[float] = None,
              wait_s: Optional[float] = 60.0) -> List[Any]:
        return self.submit(rows, tenant=tenant,
                           timeout_ms=timeout_ms).result(timeout=wait_s)

    # -- model lifecycle (per tenant) -----------------------------------------

    def swap(self, tenant: Optional[str], path: str) -> ModelEntry:
        """Hot-swap one tenant's model; the other tenants' entries and
        generations are untouched (distinct registry names)."""
        return self._lane(tenant).server.swap(path)

    # -- dispatch ------------------------------------------------------------

    def _pick_lane_locked(self) -> Optional[_TenantLane]:
        """The non-empty lane of least virtual time (WFQ)."""
        best: Optional[_TenantLane] = None
        for lane in self._lanes.values():
            if lane.queue and (best is None or lane.vtime < best.vtime):
                best = lane
        return best

    def _form_batch_locked(self, lane: _TenantLane) -> List[_Pending]:
        """One lane's next batch: the bucket from its queue depth and its
        predicted per-bucket cost, requests FIFO up to it, never split."""
        batcher = lane.server.batcher
        if batcher.cost_lookup is None:
            from ..tuning.costmodel import ServingCostLookup

            batcher.cost_lookup = ServingCostLookup()
        target = batcher._choose_bucket(lane.queued_rows())
        batch: List[_Pending] = []
        rows = 0
        while lane.queue:
            nxt = lane.queue[0]
            if batch and rows + len(nxt.rows) > target:
                break
            batch.append(lane.queue.pop(0))
            rows += len(nxt.rows)
            if rows >= target:
                break
        return batch

    def _next_batch_locked(self, lane: _TenantLane) -> List[_Pending]:
        """Take ``lane``'s next batch and charge it to the lane's virtual
        time (the dispatcher's step, lock held)."""
        batch = self._form_batch_locked(lane)
        n_rows = sum(len(p.rows) for p in batch)
        lane.vtime += n_rows / lane.config.weight
        lane.dispatched_rows += n_rows
        self._vclock = max(self._vclock, lane.vtime)
        lane.server.metrics.set_queue_depth(lane.queued_rows())
        return batch

    def _dispatch_loop(self) -> None:
        while True:
            with self._work:
                lane = self._pick_lane_locked()
                while lane is None and not self._closed:
                    self._work.wait(timeout=0.1)
                    lane = self._pick_lane_locked()
                if lane is None:
                    return
                batch = self._next_batch_locked(lane)
                self._work.notify_all()   # wake a draining stop()
            if not batch:
                continue
            n_rows = sum(len(p.rows) for p in batch)
            server = lane.server
            span = begin_span("serve.batch", cat="serve",
                              parent=batch[0].span, tenant=lane.config.name,
                              requests=len(batch), rows=n_rows,
                              mode="continuous")
            t0 = time.perf_counter()
            try:
                run_pending_batch(batch, server._execute, server.admission,
                                  server.metrics)
            finally:
                lookup = server.batcher.cost_lookup
                if lookup is not None and n_rows > 0:
                    lookup.observe(
                        bucket_for(min(n_rows, lane.config.max_batch),
                                   lane.buckets),
                        time.perf_counter() - t0)
                end_span(span)
                with self._work:
                    self._work.notify_all()

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Aggregate and per-tenant serving snapshots (``/metrics``)."""
        with self._lock:
            lanes = dict(self._lanes)
            vclock = self._vclock
        tenants: Dict[str, Any] = {}
        totals = {"requests": 0, "rows": 0, "batches": 0, "shed": 0,
                  "hostFallbacks": 0, "rollbacks": 0}
        for name, lane in sorted(lanes.items()):
            snap = lane.server.snapshot()
            snap["tenantConfig"] = lane.config.to_json()
            snap["wfq"] = {"vtime": round(lane.vtime, 3),
                           "dispatchedRows": lane.dispatched_rows}
            tenants[name] = snap
            for k in totals:
                totals[k] += snap.get(k) or 0
        return {"tenants": tenants, "aggregate": totals,
                "vclock": round(vclock, 3)}

    def tenant_snapshots(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant snapshots for the Prometheus text (the key is the
        ``tenant`` label)."""
        return dict(self.snapshot()["tenants"])
