"""Chrome-trace (Perfetto) export of a span tree (counterpart of
``transmogrifai_tpu.obs.export``).

The document is the Trace Event Format's JSON-object form
(``{"traceEvents": [...]}``): complete events (``ph: "X"``) for spans,
instant events (``ph: "i"``) for flight-recorder entries and metadata
events naming the threads; it loads in ``chrome://tracing`` and
https://ui.perfetto.dev.  ``python -m transmogrifai_tpu_torch trace FILE``
prints :func:`trace_summary` of such a file.  For the same spans and
events both packages write the same document and the same summary.

:func:`validate_chrome_trace` is the schema check the chip smoke and the
tests run over every export.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

__all__ = ["to_chrome_trace", "validate_chrome_trace", "trace_summary",
           "summarize_file"]


def to_chrome_trace(tracer, flight=None) -> Dict[str, Any]:
    """Render ``tracer``'s spans (and optionally a flight recorder's
    events) as a Chrome-trace JSON document."""
    spans = tracer.snapshot()
    flight = flight if flight is not None else tracer.flight
    # stable thread ids: order of first appearance
    tids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for sp in spans:
        tid = tids.setdefault(sp.thread, len(tids))
        args = {k: _jsonable(v) for k, v in sp.attrs.items()}
        args["spanId"] = sp.span_id
        if sp.parent_id is not None:
            args["parentId"] = sp.parent_id
        events.append({
            "ph": "X", "name": sp.name, "cat": sp.cat,
            "ts": round(sp.t0_unix * 1e6, 1),
            "dur": round((sp.dur_s or 0.0) * 1e6, 1),
            "pid": 0, "tid": tid, "args": args,
        })
    for name, tid in tids.items():
        events.append({"ph": "M", "name": "thread_name", "pid": 0,
                       "tid": tid, "args": {"name": name}})
    if flight is not None:
        for e in flight.events():
            args = {k: _jsonable(v) for k, v in e["attrs"].items()}
            args["seq"] = e["seq"]
            if e.get("spanId") is not None:
                args["spanId"] = e["spanId"]
            events.append({
                "ph": "i", "name": e["kind"], "cat": "event",
                "ts": round(e["t"] * 1e6, 1), "pid": 0, "tid": 0,
                "s": "g", "args": args,
            })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "traceId": tracer.trace_id,
            "label": tracer.label,
            "spans": len(spans),
            "droppedSpans": tracer.dropped,
        },
    }


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


#: the phases a document may hold
_KNOWN_PHASES = {"X", "i", "M", "B", "E", "b", "e", "C"}


def validate_chrome_trace(doc: Any) -> List[str]:
    """Structural check of a Chrome-trace JSON document; returns the list
    of problems (empty = valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"document must be a JSON object, got {type(doc).__name__}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents must be a list"]
    for i, e in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _KNOWN_PHASES:
            problems.append(f"{where}: unknown phase {ph!r}")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            problems.append(f"{where}: missing name")
        if ph in ("X", "i", "B", "E"):
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: bad dur {dur!r}")
        if ph != "M" and not isinstance(e.get("pid"), int):
            problems.append(f"{where}: missing pid")
        if len(problems) >= 20:
            problems.append("... (truncated)")
            break
    return problems


def trace_summary(doc: Dict[str, Any], top_k: int = 15) -> str:
    """A reader's summary of an exported document (the ``trace``
    command): span and event counts, each category's wall, the top spans
    by duration and the events by kind."""
    events = doc.get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X"]
    instants = [e for e in events if e.get("ph") == "i"]
    other = doc.get("otherData", {})
    lines = [
        f"trace {other.get('traceId', '?')}"
        + (f" ({other['label']})" if other.get("label") else "")
        + f": {len(spans)} spans, {len(instants)} events"
        + (f", {other['droppedSpans']} dropped"
           if other.get("droppedSpans") else "")]
    by_cat: Dict[str, List[float]] = {}
    for e in spans:
        by_cat.setdefault(e.get("cat", "?"), []).append(
            float(e.get("dur", 0.0)))
    for cat in sorted(by_cat):
        durs = by_cat[cat]
        lines.append(f"  {cat:<10} {len(durs):5d} spans  "
                     f"{sum(durs) / 1e6:9.3f}s total")
    top = sorted(spans, key=lambda e: -float(e.get("dur", 0.0)))[:top_k]
    if top:
        lines.append("top spans:")
        for e in top:
            lines.append(
                f"  {float(e.get('dur', 0.0)) / 1e3:9.1f} ms  "
                f"[{e.get('cat', '?')}] {e['name']}")
    counts: Dict[str, int] = {}
    for e in instants:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    if counts:
        lines.append("events:")
        for k in sorted(counts):
            lines.append(f"  {counts[k]:5d}  {k}")
    return "\n".join(lines)


def summarize_file(path: str, top_k: int = 15) -> Optional[str]:
    """Load, validate and summarize a trace file: the summary, or None
    after printing the problems to stderr (the ``trace`` command)."""
    import json
    import sys

    with open(path) as f:
        doc = json.load(f)
    problems = validate_chrome_trace(doc)
    if problems:
        for p in problems:
            print(f"invalid trace: {p}", file=sys.stderr)
        return None
    return trace_summary(doc, top_k=top_k)
