"""Hierarchical span tracing: one timeline across train, sweep and serve
(counterpart of ``transmogrifai_tpu.obs.trace``).

A process-wide :class:`Tracer` collects :class:`Span` records (name,
category, parent, wall interval, attributes) from the hooks threaded
through ``OpWorkflow.train/refresh``, the execution plan, the streaming
train, the event readers, the sweep work queue, halving's rungs and the
serving path.

* **One check when off.**  Tracing is opt-in (:func:`start_trace`); every
  hook starts with one module-global ``None`` check, so a disabled hook
  costs an attribute load and a branch.
* **Thread-correct.**  The span stack is thread-local; code that hands
  work to another thread (the plan's pool, the serving dispatch thread,
  the reader's prefetch thread, the watchdog's worker) passes the parent
  span explicitly, or adopts it for the block (:func:`adopt_span`).
* **Bounded.**  A tracer keeps at most ``max_spans`` finished spans and
  counts the rest in ``dropped``.

``start_trace(capture_hlo=True)`` also arms the per-stage kernel mix
(``obs/kernel_mix.py``, the counterpart of the JAX package's HLO
capture); the argument keeps its name so that callers of both packages
read alike.  The sinks are ``obs/export.py`` (Chrome trace),
``obs/flight.py`` (the event ring) and ``obs/prometheus.py``.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Tracer", "start_trace", "stop_trace", "install_tracer",
           "current_tracer", "tracing", "span", "current_span",
           "begin_span", "end_span", "adopt_span", "new_trace_id",
           "set_global_attrs", "global_attrs"]

#: attributes stamped on every span this process opens
_GLOBAL_ATTRS: Dict[str, Any] = {}


def set_global_attrs(**attrs: Any) -> None:
    """Merge process-wide span attributes.  Read only while a tracer is
    armed: the disabled hook stays one ``None`` check."""
    _GLOBAL_ATTRS.update(attrs)


def global_attrs() -> Dict[str, Any]:
    return dict(_GLOBAL_ATTRS)


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One timed node of the span tree (``attrs`` may be enriched until
    :func:`end_span`)."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id",
                 "t0_unix", "t0", "dur_s", "attrs", "thread")

    def __init__(self, name: str, cat: str, trace_id: str, span_id: int,
                 parent_id: Optional[int], attrs: Dict[str, Any]):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0_unix = time.time()
        self.t0 = time.perf_counter()
        self.dur_s: Optional[float] = None
        self.attrs = attrs
        self.thread = threading.current_thread().name

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "cat": self.cat,
                "traceId": self.trace_id, "spanId": self.span_id,
                "parentId": self.parent_id,
                "t0": round(self.t0_unix, 6),
                "durSecs": (None if self.dur_s is None
                            else round(self.dur_s, 6)),
                "thread": self.thread, "attrs": dict(self.attrs)}


class Tracer:
    """Collects one run's span tree; thread-safe."""

    def __init__(self, label: str = "", trace_id: Optional[str] = None,
                 max_spans: int = 100_000):
        self.label = label
        self.trace_id = trace_id or new_trace_id()
        self.max_spans = int(max_spans)
        self.started_at = time.time()
        self.spans: List[Span] = []
        self.dropped = 0
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        #: the FlightRecorder installed with this tracer (start_trace
        #: links one, so events carry the span ids of the tree)
        self.flight = None

    def begin(self, name: str, cat: str, parent_id: Optional[int],
              attrs: Dict[str, Any]) -> Span:
        return Span(name, cat, self.trace_id, next(self._ids),
                    parent_id, attrs)

    def end(self, sp: Span) -> None:
        sp.dur_s = time.perf_counter() - sp.t0
        with self._lock:
            if len(self.spans) < self.max_spans:
                self.spans.append(sp)
            else:
                self.dropped += 1

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self.spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self.spans)


#: the installed tracer; None = tracing off (every hook's fast path)
_TRACER: Optional[Tracer] = None

_local = threading.local()


def current_tracer() -> Optional[Tracer]:
    return _TRACER


def current_span() -> Optional[Span]:
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def install_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install ``tracer`` process-wide (None turns tracing off)."""
    global _TRACER
    _TRACER = tracer
    return tracer


def start_trace(label: str = "", max_spans: int = 100_000,
                flight_capacity: int = 4096,
                capture_hlo: bool = True) -> Tracer:
    """Arm tracing process-wide: a fresh :class:`Tracer`, a linked
    :class:`~transmogrifai_tpu_torch.obs.flight.FlightRecorder` and,
    unless ``capture_hlo=False``, the per-stage kernel mix
    (``obs/kernel_mix.py``): each serial stage of the plan then runs
    under ``torch.profiler`` and records which kernels it launched."""
    from . import flight as _flight
    from . import kernel_mix as _mix

    tracer = Tracer(label=label, max_spans=max_spans)
    tracer.flight = _flight.FlightRecorder(capacity=flight_capacity,
                                           trace_id=tracer.trace_id)
    _flight.install_recorder(tracer.flight)
    if capture_hlo:
        _mix.arm()
    install_tracer(tracer)
    return tracer


def stop_trace() -> Optional[Tracer]:
    """Disarm tracing; returns the tracer that was active (its spans and
    flight recorder stay readable after the stop)."""
    from . import flight as _flight
    from . import kernel_mix as _mix

    tracer = _TRACER
    install_tracer(None)
    _flight.install_recorder(None)
    _mix.disarm()
    return tracer


@contextlib.contextmanager
def tracing(label: str = "", **kwargs):
    """``with tracing() as tracer:``: start/stop_trace as a scope."""
    tracer = start_trace(label, **kwargs)
    try:
        yield tracer
    finally:
        stop_trace()


def begin_span(name: str, cat: str = "run",
               parent: Optional[Span] = None, **attrs) -> Optional[Span]:
    """Open a span (the explicit form, for hot paths and parents on
    another thread).  Returns None when tracing is off; :func:`end_span`
    takes the None back, so the disabled path allocates nothing."""
    t = _TRACER
    if t is None:
        return None
    if parent is None:
        parent = current_span()
    if _GLOBAL_ATTRS:
        attrs = {**_GLOBAL_ATTRS, **attrs}
    sp = t.begin(name, cat, parent.span_id if parent is not None else None,
                 attrs)
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(sp)
    return sp


def end_span(sp: Optional[Span], **attrs) -> None:
    """Close a span opened by :func:`begin_span` (None: no-op).  ``attrs``
    merge in at the close (counts known only at the end)."""
    if sp is None:
        return
    if attrs:
        sp.attrs.update(attrs)
    stack = getattr(_local, "stack", None)
    if stack:
        try:
            stack.remove(sp)
        except ValueError:  # closed on another thread than it opened
            pass
    t = _TRACER
    if t is not None and t.trace_id == sp.trace_id:
        t.end(sp)


@contextlib.contextmanager
def span(name: str, cat: str = "run", parent: Optional[Span] = None,
         **attrs):
    """Context-manager span; yields the Span (None when tracing is off)."""
    sp = begin_span(name, cat, parent=parent, **attrs)
    try:
        yield sp
    finally:
        end_span(sp)


@contextlib.contextmanager
def adopt_span(parent: Optional[Span]):
    """Make ``parent``, a span opened on another thread, this thread's
    current span for the block, without recording anything: spans opened
    and events recorded inside the block link to it.  The hand-off of a
    worker thread (None: no-op)."""
    if parent is None:
        yield
        return
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(parent)
    try:
        yield
    finally:
        try:
            stack.remove(parent)
        except ValueError:
            pass
