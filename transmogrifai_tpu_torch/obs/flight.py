"""Flight recorder: a bounded ring of structured run events (counterpart
of ``transmogrifai_tpu.obs.flight``).

The span tree (``obs/trace.py``) says where the time went; the flight
recorder says what happened, in what order: device losses, retries and
quarantines, checkpoint saves and resumes, drift windows and triggers,
breaker transitions, sheds, fault firings.  Each event carries a
monotonically increasing ``seq`` (the causal order, immune to the wall
clock's granularity), the wall time, the ``kind``, the site's attributes
and, while a tracer is armed, the enclosing span's id, so that an event
chain links back into the span tree.

Recording is one module-global ``None`` check when no recorder is
installed.  The ring is bounded (``capacity``): an event storm ages old
events out.  :meth:`FlightRecorder.dump_jsonl` writes the ring as JSON
lines on demand; :func:`arm_crash_dump` hooks ``sys.excepthook`` so that
an unhandled exception flushes the ring before the process dies (a
SIGKILL cannot be hooked: a killed train resumes from its checkpoints).
"""
from __future__ import annotations

import collections
import json
import sys
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder", "install_recorder", "current_recorder",
           "record_event", "record_events", "arm_crash_dump",
           "disarm_crash_dump", "merge_flight_dumps"]


class FlightRecorder:
    """Thread-safe bounded event ring for one run/process."""

    def __init__(self, capacity: int = 4096,
                 trace_id: Optional[str] = None):
        self.capacity = int(capacity)
        self.trace_id = trace_id
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.recorded = 0  # lifetime count (ring may have aged events out)

    def record(self, kind: str, attrs: Dict[str, Any]) -> None:
        from .trace import current_span

        sp = current_span()
        with self._lock:
            self._seq += 1
            self.recorded += 1
            self._ring.append({
                "seq": self._seq,
                "t": round(time.time(), 6),
                "kind": kind,
                "traceId": self.trace_id,
                "spanId": sp.span_id if sp is not None else None,
                "attrs": attrs,
            })

    # -- reading -------------------------------------------------------------

    def events(self, kind_prefix: Optional[str] = None
               ) -> List[Dict[str, Any]]:
        """Events in causal (seq) order, optionally filtered by a kind
        prefix (``"elastic."`` matches every elastic event)."""
        with self._lock:
            out = list(self._ring)
        if kind_prefix is not None:
            out = [e for e in out if e["kind"].startswith(kind_prefix)]
        return out

    def kinds(self) -> List[str]:
        """The kind sequence in causal order (assertion convenience)."""
        return [e["kind"] for e in self.events()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- persistence ---------------------------------------------------------

    def dump_jsonl(self, path: str) -> int:
        """Write the ring to ``path`` as JSON Lines; returns the event
        count.  Plain write (not tmp+rename): on the crash path the
        half-written file is still more evidence than no file."""
        events = self.events()
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e, default=str) + "\n")
        return len(events)


def merge_flight_dumps(paths, out_path: Optional[str] = None):
    """Merge per-process flight-recorder JSON-lines dumps into one
    causally ordered stream.

    Events sort by wall time, then (process, seq): each process's own
    ``seq`` order is kept, and every event is tagged with the ``process``
    index of its dump's position (unless it carries one).  Returns the
    merged events; with ``out_path`` also writes them as JSON lines."""
    merged = []
    for proc, path in enumerate(paths):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    e = json.loads(line)
                    e.setdefault("process", proc)
                    merged.append(e)
        except OSError:
            continue
    merged.sort(key=lambda e: (e.get("t", 0.0), e.get("process", 0),
                               e.get("seq", 0)))
    if out_path is not None:
        with open(out_path, "w") as f:
            for e in merged:
                f.write(json.dumps(e, default=str) + "\n")
    return merged


#: installed recorder; None = event recording disabled (the fast path)
_RECORDER: Optional[FlightRecorder] = None


def install_recorder(rec: Optional[FlightRecorder]
                     ) -> Optional[FlightRecorder]:
    """Install ``rec`` process-wide (None disables recording)."""
    global _RECORDER
    _RECORDER = rec
    return rec


def current_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def record_event(kind: str, **attrs) -> None:
    """The event-site hook: one global ``None`` check when off."""
    rec = _RECORDER
    if rec is not None:
        rec.record(kind, attrs)


def record_events(kind: str, batch) -> None:
    """Record a batch of events of one ``kind`` (each item an attrs
    dict) for one enable check, not one an entry."""
    rec = _RECORDER
    if rec is not None:
        for attrs in batch:
            rec.record(kind, dict(attrs))


# ---------------------------------------------------------------------------
# crash persistence
# ---------------------------------------------------------------------------

_crash_lock = threading.Lock()
_crash_path: Optional[str] = None
_prev_excepthook = None


def _crash_hook(exc_type, exc, tb):
    rec = _RECORDER
    path = _crash_path
    if rec is not None and path is not None:
        try:
            rec.record("crash", {"error": f"{exc_type.__name__}: {exc}"})
            rec.dump_jsonl(path)
        except Exception:  # the recorder must never mask the real crash
            pass
    hook = _prev_excepthook or sys.__excepthook__
    hook(exc_type, exc, tb)


def arm_crash_dump(path: str) -> None:
    """Flush the installed recorder's ring to ``path`` (JSONL) from
    ``sys.excepthook`` if the process dies on an unhandled exception."""
    global _crash_path, _prev_excepthook
    with _crash_lock:
        if _prev_excepthook is None:
            _prev_excepthook = sys.excepthook
            sys.excepthook = _crash_hook
        _crash_path = path


def disarm_crash_dump() -> None:
    global _crash_path, _prev_excepthook
    with _crash_lock:
        _crash_path = None
        if _prev_excepthook is not None:
            sys.excepthook = _prev_excepthook
            _prev_excepthook = None
