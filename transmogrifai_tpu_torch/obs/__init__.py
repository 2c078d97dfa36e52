"""Observability: span tracing, the flight recorder, exposition
(counterpart of ``transmogrifai_tpu.obs``).

* **Span tracing** (``obs/trace.py``): ``start_trace()`` arms a
  process-wide :class:`Tracer`; the hooks in ``OpWorkflow.train/refresh``,
  the plan, the streaming train, the event readers, the sweep work
  queue, halving and the serving path record one timeline under a
  ``trace_id``.
* **Flight recorder** (``obs/flight.py``): a bounded ring of state
  changes (device losses, retries, quarantines, checkpoint saves and
  resumes, drift windows and triggers, breaker transitions, sheds, fault
  firings) linked to the span they happened in; JSON lines on demand or
  on a crash.
* **Exposition** (``obs/export.py``, ``obs/prometheus.py``): a Chrome
  trace that Perfetto loads (``python -m transmogrifai_tpu_torch trace
  FILE`` summarizes it) and the Prometheus text of ``ServingMetrics`` and
  ``RunCounters`` at ``/metrics?format=prometheus``.
* **Kernel mix** (``obs/kernel_mix.py``, in place of the JAX package's
  ``obs/hlo.py``): under a trace each serial stage of the plan records
  the kernels it ran in ``StageProfile.hlo``, which the cost model's
  observations carry.  ``bench_meta()`` is the shared metadata block.

Each hook is one module-global ``None`` check while tracing is off.
"""
from .bench_meta import bench_meta, estimate_disabled_overhead_s
from .export import (summarize_file, to_chrome_trace, trace_summary,
                     validate_chrome_trace)
from .flight import (FlightRecorder, arm_crash_dump, current_recorder,
                     disarm_crash_dump, install_recorder, record_event)
from .prometheus import parse_exposition, prometheus_text
from .trace import (Span, Tracer, begin_span, current_span, current_tracer,
                    end_span, install_tracer, new_trace_id, span,
                    start_trace, stop_trace, tracing)

__all__ = [
    "Span", "Tracer", "span", "begin_span", "end_span", "current_span",
    "current_tracer", "install_tracer", "start_trace", "stop_trace",
    "tracing", "new_trace_id",
    "FlightRecorder", "record_event", "install_recorder",
    "current_recorder", "arm_crash_dump", "disarm_crash_dump",
    "to_chrome_trace", "validate_chrome_trace", "trace_summary",
    "summarize_file",
    "prometheus_text", "parse_exposition",
    "bench_meta", "estimate_disabled_overhead_s",
]
