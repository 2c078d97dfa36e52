"""The shared metadata block of a measurement's JSON (counterpart of
``transmogrifai_tpu.obs.bench_meta``): the platform, peak RSS, the time,
the process, a fresh run id and the active trace id, so that a result
links back to its span tree and flight recording.  In place of the JAX
package's ``jax`` version it names ``torch``, ``cuda`` and the card.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

__all__ = ["bench_meta", "estimate_disabled_overhead_s"]


def _rss_mb() -> Optional[float]:
    try:
        import resource

        return round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1)
    except Exception:  # pragma: no cover - non-POSIX
        return None


def bench_meta(wall_s: Optional[float] = None) -> Dict[str, Any]:
    """The JAX package's keys (``backend``, ``rssMb``, ``at``, ``pid``,
    ``runId``, ``traceId``, ``wallSecs`` where given) plus ``torch``,
    ``cuda`` (the toolkit torch was built with, None on a CPU build) and
    ``deviceName`` (``torch.cuda.get_device_name(0)``, None without a
    card)."""
    import torch

    from ..utils.profiling import backend_name
    from ..utils.uid import uid_for
    from .trace import current_tracer

    tracer = current_tracer()
    meta: Dict[str, Any] = {
        "backend": backend_name(),
        "rssMb": _rss_mb(),
        "at": int(time.time()),
        "pid": os.getpid(),
        "runId": uid_for("Bench"),
        "traceId": tracer.trace_id if tracer is not None else None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "deviceName": (torch.cuda.get_device_name(0)
                       if torch.cuda.is_available() else None),
    }
    if wall_s is not None:
        meta["wallSecs"] = round(float(wall_s), 3)
    return meta


def estimate_disabled_overhead_s(n_hooks: int,
                                 samples: int = 50_000) -> float:
    """The measured cost of ``n_hooks`` disabled hooks: ``samples``
    begin/end span pairs and flight-event checks timed with tracing off,
    scaled to ``n_hooks``.  Raises while a tracer or a recorder is
    installed, rather than report the enabled path as the disabled one."""
    from .flight import current_recorder, record_event
    from .trace import begin_span, current_tracer, end_span

    if current_tracer() is not None or current_recorder() is not None:
        raise RuntimeError(
            "estimate_disabled_overhead_s must run with tracing disabled")
    t0 = time.perf_counter()
    for _ in range(samples):
        sp = begin_span("x", cat="bench")
        record_event("x")
        end_span(sp)
    per_hook = (time.perf_counter() - t0) / samples
    return per_hook * max(int(n_hooks), 0)
