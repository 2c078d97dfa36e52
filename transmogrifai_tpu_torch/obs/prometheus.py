"""Prometheus text exposition of the serving and run ledgers
(counterpart of ``transmogrifai_tpu.obs.prometheus``).

Renders a ``ServingMetrics`` snapshot (``serving/metrics.py``) and the
process's ``RunCounters`` (``utils/profiling.py``) in the Prometheus text
format 0.0.4: the payload of ``GET /metrics?format=prometheus``
(``serving/http.py``), so that a stock scraper watches a replica with no
exporter in between.

The empty state renders cleanly: a fresh server's empty latency
reservoir (quantiles None) and zero batches give each family's ``# TYPE``
line with its samples absent, never a ``None`` or ``NaN`` literal;
counters render ``0`` explicitly.  For the same snapshot and counters the
text is the JAX package's, less the families of what the port does not
count yet, which it leaves out rather than render zeros: the compile and
AOT cache family (ROADMAP Queue A item 6.6.2), the guarded-swap counters
(6.6.4), the per-tenant labels (6.6.5) and the fabric section (6.6.6).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

__all__ = ["prometheus_text", "parse_exposition"]

#: ServingMetrics snapshot keys exposed as monotonic counters
_SERVING_COUNTERS = (
    ("requests", "requests admitted"),
    ("rows", "rows admitted"),
    ("batches", "micro-batches executed"),
    ("paddedRows", "pad rows added by the shape bucketer"),
    ("shed", "requests shed by backpressure"),
    ("deadlineExpired", "requests expired while queued"),
    ("deviceErrors", "device scoring errors"),
    ("hostFallbacks", "batches served by the host fallback"),
    ("breakerOpens", "circuit breaker open transitions"),
    ("hotSwaps", "registry hot swaps"),
)

#: snapshot keys exposed as gauges
_SERVING_GAUGES = (
    ("uptimeSecs", "seconds since server start"),
    ("queueDepth", "rows currently queued"),
    ("queueDepthPeak", "peak queued rows"),
    ("latencyObservations", "latency reservoir lifetime observations"),
)


def _snake(name: str) -> str:
    s = re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", name).lower()
    return re.sub(r"[^a-z0-9_]", "_", s)


def _num(v: Any) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) else None


def _esc(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


class _Doc:
    def __init__(self):
        self.lines: List[str] = []

    def metric(self, name: str, mtype: str, help_text: str,
               samples: List) -> None:
        """One metric family; ``samples`` = [(labels dict or None, value)].
        Emitted even with no samples (its TYPE line only), so that a
        consumer sees the family: the empty reservoir's case."""
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            if value is None:
                continue
            label_s = ""
            if labels:
                inner = ",".join(f'{k}="{_esc(v)}"'
                                 for k, v in sorted(labels.items()))
                label_s = "{" + inner + "}"
            self.lines.append(f"{name}{label_s} {_fmt(value)}")

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def prometheus_text(snapshot: Optional[Dict[str, Any]] = None,
                    counters=None) -> str:
    """The full exposition.  ``snapshot`` is a ``ServingMetrics.snapshot()``
    dict (None: no serving section); ``counters`` a ``RunCounters``
    (None: the process's ``COUNTERS``)."""
    doc = _Doc()
    if snapshot is not None:
        _serving_section(doc, snapshot)
    if counters is None:
        from ..utils import profiling

        counters = profiling.COUNTERS
    _run_section(doc, counters)
    return doc.text()


def _serving_section(doc: _Doc, snap: Dict[str, Any]) -> None:
    for key, help_text in _SERVING_COUNTERS:
        doc.metric(f"tmog_serving_{_snake(key)}_total", "counter",
                   help_text, [(None, _num(snap.get(key)) or 0.0)])
    for key, help_text in _SERVING_GAUGES:
        doc.metric(f"tmog_serving_{_snake(key)}", "gauge", help_text,
                   [(None, _num(snap.get(key)) or 0.0)])
    # latency quantiles: no samples while the reservoir is empty (a
    # summary with no observations is a TYPE line, not a NaN)
    lat = snap.get("latencyMs") or {}
    doc.metric("tmog_serving_request_latency_seconds", "summary",
               "end-to-end request latency (reservoir quantiles)",
               [({"quantile": q}, v / 1000.0)
                for q_key, q in (("p50", "0.5"), ("p95", "0.95"),
                                 ("p99", "0.99"))
                for v in [_num(lat.get(q_key))] if v is not None])
    hist = snap.get("batchSizeHistogram") or {}
    doc.metric("tmog_serving_batches_by_bucket_total", "counter",
               "executed micro-batches per shape bucket",
               [({"bucket": str(k)}, _num(v))
                for k, v in sorted(hist.items(), key=lambda kv: int(kv[0]))])
    age = _num(snap.get("lastFallbackAgeSecs"))
    doc.metric("tmog_serving_last_fallback_age_seconds", "gauge",
               "seconds since the last host fallback (absent = never)",
               [(None, age)] if age is not None else [])


def _run_section(doc: _Doc, counters) -> None:
    doc.metric("tmog_run_transfers_total", "counter",
               "host<->device transfer operations",
               [({"op": "upload"}, counters.uploads),
                ({"op": "fetch"}, counters.fetches),
                ({"op": "drain"}, counters.drains)])
    doc.metric("tmog_run_transfer_bytes_total", "counter",
               "host<->device bytes moved",
               [({"op": "upload"}, counters.upload_bytes),
                ({"op": "fetch"}, counters.fetch_bytes)])
    doc.metric("tmog_run_transfer_seconds_total", "counter",
               "seconds spent in transfers (enqueue-side lower bound)",
               [({"op": "upload"}, round(counters.upload_s, 6)),
                ({"op": "fetch"}, round(counters.fetch_s, 6)),
                ({"op": "drain"}, round(counters.drain_s, 6))])
    doc.metric("tmog_run_launches_total", "counter",
               "explicit kernel dispatches at framework call sites",
               [(None, counters.launches)])
    doc.metric("tmog_run_elastic_events_total", "counter",
               "elastic sweep events (device loss / shrink / retry / ...)",
               [({"kind": k}, v) for k, v in
                sorted(counters.elastic.items())])
    doc.metric("tmog_run_refresh_events_total", "counter",
               "warm-start refresh estimator outcomes",
               [({"kind": k}, v) for k, v in
                sorted(counters.refresh.items())])


# ---------------------------------------------------------------------------
# parsing (the round trip the smoke and the tests run over every render)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(\{[^}]*\})?"                          # optional labels
    r" ([+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|Inf|NaN))$")  # value


def parse_exposition(text: str) -> Dict[str, float]:
    """A minimal Prometheus text-format parser: ``{metric{labels}:
    value}``; raises ``ValueError`` on a line that is neither a comment
    nor a well-formed sample (the check run over a live exposition)."""
    out: Dict[str, float] = {}
    for i, line in enumerate(text.splitlines()):
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {i + 1} is not a valid sample: {line!r}")
        name, labels, value = m.groups()
        out[f"{name}{labels or ''}"] = float(value)
    if not text.endswith("\n"):
        raise ValueError("exposition must end with a newline")
    return out
