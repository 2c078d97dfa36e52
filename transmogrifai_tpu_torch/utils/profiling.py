"""Run metrics and ingestion counters (counterpart of
``transmogrifai_tpu.utils.profiling``): the app metrics of a runner's
run (``OpStep``, ``StepMetrics``, ``AppMetrics``, ``MetricsCollector``,
``install_collector``, ``with_job_group``) and the chunked-ingestion
counters of an out-of-core train (``IngestPass``, ``IngestProfiler``,
with the reader retries, the quarantined records and the checkpoints'
saves), the plan profiler of ``train(profile=True)`` (``StageProfile``,
``PlanProfiler``: a stage's wall, rows, input width and, for a serial
stage, its ``seg_hist`` launches) and the process-wide refresh counters
(``count_refresh``, ``refresh_snapshot``).  A stage's compiled-program
features (the JAX package's ``hlo`` field) wait for the trace layer,
ROADMAP Queue A item 6.5.5.
"""
from __future__ import annotations

import contextlib
import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = ["OpStep", "StepMetrics", "AppMetrics", "MetricsCollector",
           "current_collector", "install_collector", "with_job_group",
           "IngestPass", "IngestProfiler", "StageProfile", "PlanProfiler",
           "backend_name", "kernel_launches", "count_refresh",
           "refresh_snapshot"]


class OpStep(enum.Enum):
    """Phases of a workflow run (OpStep.scala:38-46)."""

    CrossValidation = "Cross-validation"
    DataReadingAndFiltering = "Data reading and filtering"
    FeatureEngineering = "Feature engineering"
    ModelIO = "Model loading / saving"
    Other = "Other"
    ResultsSaving = "Results saving"
    Scoring = "Scoring"
    Serving = "Serving"


@dataclass
class StepMetrics:
    step: str
    duration_secs: float
    count: int = 1

    def to_json(self) -> Dict[str, Any]:
        return {"step": self.step, "durationSecs": self.duration_secs,
                "count": self.count}


@dataclass
class AppMetrics:
    """A run's metrics (OpSparkListener.AppMetrics): its wall, each
    step's seconds and count, and the custom tags."""

    app_name: str = "transmogrifai_tpu"
    run_type: Optional[str] = None
    app_start_time: float = field(default_factory=time.time)
    app_end_time: Optional[float] = None
    step_metrics: Dict[str, StepMetrics] = field(default_factory=dict)
    custom_tags: Dict[str, str] = field(default_factory=dict)

    @property
    def app_duration(self) -> float:
        end = (self.app_end_time if self.app_end_time is not None
               else time.time())
        return end - self.app_start_time

    def to_json(self) -> Dict[str, Any]:
        return {
            "appName": self.app_name,
            "runType": self.run_type,
            "appDurationSecs": self.app_duration,
            "stepMetrics": [m.to_json() for m in self.step_metrics.values()],
            "customTags": dict(self.custom_tags),
        }


class MetricsCollector:
    """Adds up each step's wall seconds for one run; thread-safe."""

    def __init__(self, app_name: str = "transmogrifai_tpu",
                 run_type: Optional[str] = None):
        self.metrics = AppMetrics(app_name=app_name, run_type=run_type)
        self._lock = threading.Lock()
        self._end_handlers: List[Callable[[AppMetrics], None]] = []

    def record(self, step: OpStep, duration_secs: float) -> None:
        with self._lock:
            cur = self.metrics.step_metrics.get(step.name)
            if cur is None:
                self.metrics.step_metrics[step.name] = StepMetrics(
                    step.name, duration_secs)
            else:
                cur.duration_secs += duration_secs
                cur.count += 1

    def add_application_end_handler(
            self, fn: Callable[[AppMetrics], None]) -> None:
        """OpWorkflowRunner.addApplicationEndHandler (:145)."""
        self._end_handlers.append(fn)

    def finish(self) -> AppMetrics:
        """Stamp the end time and call the end handlers (outside the
        lock; a handler that raises does not break the run)."""
        with self._lock:
            self.metrics.app_end_time = time.time()
        for fn in self._end_handlers:
            try:
                fn(self.metrics)
            except Exception:
                pass
        return self.metrics


_local = threading.local()


def current_collector() -> Optional[MetricsCollector]:
    return getattr(_local, "collector", None)


@contextlib.contextmanager
def install_collector(collector: MetricsCollector):
    """Make ``collector`` this thread's current one for the block without
    recording a step for the block itself."""
    prev = current_collector()
    _local.collector = collector
    try:
        yield collector
    finally:
        _local.collector = prev


@contextlib.contextmanager
def with_job_group(step: OpStep,
                   collector: Optional[MetricsCollector] = None):
    """Time a phase of the run into the current (or the given) collector
    (JobGroupUtil.withJobGroup); the first group entered with a collector
    installs it as the thread's current one for nested code."""
    coll = collector or current_collector()
    installed = coll is not None and current_collector() is None
    if installed:
        _local.collector = coll
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if coll is not None:
            coll.record(step, time.perf_counter() - t0)
        if installed:
            _local.collector = None

#: per-pass chunk records kept verbatim (bounds the profiler's memory)
_INGEST_CHUNK_DETAIL_CAP = 512


@dataclass
class IngestPass:
    """One pass of the out-of-core driver over the reader or over the
    retained blocks (``workflow/streaming.py``).

    ``read_s`` is the parse time on the prefetch thread, ``transform_s``
    the stage time on the consuming thread; with the two overlapped the
    wall approaches the larger, and ``overlap_efficiency`` is the share of
    the smaller one that was hidden (1.0 fully, 0.0 not at all)."""

    label: str
    chunks: int = 0
    rows: int = 0
    bytes_read: int = 0
    read_s: float = 0.0
    transform_s: float = 0.0
    wall_s: float = 0.0
    #: transient-IO retries of this pass and their backoff seconds (the
    #: reader's ``RetryingChunkStream``, readers/resilience.py)
    retries: int = 0
    retry_wait_s: float = 0.0
    #: chunks a checkpoint resume read past without folding them again
    chunks_skipped: int = 0
    #: the first _INGEST_CHUNK_DETAIL_CAP chunks as [rows, read_s,
    #: transform_s]
    chunk_detail: List[List[float]] = field(default_factory=list)

    def note_read(self, rows: int, seconds: float, nbytes: int = 0) -> None:
        self.chunks += 1
        self.rows += rows
        self.read_s += seconds
        self.bytes_read += int(nbytes)
        if len(self.chunk_detail) < _INGEST_CHUNK_DETAIL_CAP:
            self.chunk_detail.append([rows, round(seconds, 6), 0.0])

    def note_transform(self, chunk_index: int, seconds: float) -> None:
        self.transform_s += seconds
        if chunk_index < len(self.chunk_detail):
            self.chunk_detail[chunk_index][2] = round(seconds, 6)

    def note_retry(self, wait_s: float) -> None:
        self.retries += 1
        self.retry_wait_s += wait_s

    @property
    def overlap_efficiency(self) -> float:
        smaller = min(self.read_s, self.transform_s)
        if smaller <= 0 or self.wall_s <= 0:
            return 0.0
        hidden = self.read_s + self.transform_s - self.wall_s
        return max(0.0, min(1.0, hidden / smaller))

    @property
    def rows_per_s(self) -> float:
        return self.rows / self.wall_s if self.wall_s > 0 else 0.0

    def to_json(self) -> Dict[str, Any]:
        out = {
            "label": self.label, "chunks": self.chunks, "rows": self.rows,
            "bytesRead": self.bytes_read,
            "readSecs": round(self.read_s, 4),
            "transformSecs": round(self.transform_s, 4),
            "wallSecs": round(self.wall_s, 4),
            "rowsPerSec": round(self.rows_per_s, 1),
            "overlapEfficiency": round(self.overlap_efficiency, 3),
            "chunkDetail": [list(c) for c in self.chunk_detail],
        }
        if self.retries:
            out["retries"] = self.retries
            out["retryWaitSecs"] = round(self.retry_wait_s, 4)
        if self.chunks_skipped:
            out["chunksSkipped"] = self.chunks_skipped
        return out


class IngestProfiler:
    """The counters of one out-of-core train: an ``IngestPass`` a pass,
    the chunk geometry, the retained bytes spilled to disk, the records
    the quarantine policy dropped, the RawFeatureFilter's profile pass
    (``rff``: its passes, rows and seconds; None without a filter) and the
    checkpoints (``workflow/checkpoint.py``): the saves, their seconds and
    whether the train resumed."""

    def __init__(self, chunk_rows: int = 0):
        self.chunk_rows = chunk_rows
        self.passes: List[IngestPass] = []
        #: bytes of retained blocks the fused pass spilled to disk
        #: (``workflow/streaming._BlockStore``; 0 = none)
        self.spilled_bytes: int = 0
        #: quarantined bad records: sidecar entries and data rows dropped
        #: (readers/resilience.QuarantineSink; 0 under the fail policy)
        self.quarantined_records: int = 0
        self.quarantined_rows: int = 0
        self.rff: Optional[Dict[str, Any]] = None
        self.checkpoint_saves: int = 0
        self.checkpoint_wall_s: float = 0.0
        self.resumed: bool = False
        self._lock = threading.Lock()

    def begin_pass(self, label: str) -> IngestPass:
        p = IngestPass(label=label)
        with self._lock:
            self.passes.append(p)
        return p

    @property
    def total_rows(self) -> int:
        return max((p.rows for p in self.passes), default=0)

    @property
    def total_bytes(self) -> int:
        return max((p.bytes_read for p in self.passes), default=0)

    @property
    def total_retries(self) -> int:
        return sum(p.retries for p in self.passes)

    @property
    def total_retry_wait_s(self) -> float:
        return sum(p.retry_wait_s for p in self.passes)

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "chunkRows": self.chunk_rows,
                "rows": self.total_rows,
                "bytesRead": self.total_bytes,
                "spilledBytes": self.spilled_bytes,
                "retries": self.total_retries,
                "retryWaitSecs": round(self.total_retry_wait_s, 4),
                "quarantinedRecords": self.quarantined_records,
                "quarantinedRows": self.quarantined_rows,
                "rff": self.rff,
                "checkpointSaves": self.checkpoint_saves,
                "checkpointWallSecs": round(self.checkpoint_wall_s, 4),
                "resumed": self.resumed,
                "passes": [p.to_json() for p in self.passes],
            }

    def format(self) -> str:
        with self._lock:
            passes = list(self.passes)
        lines = [f"chunked ingest: {len(passes)} passes, "
                 f"chunk_rows={self.chunk_rows}, rows={self.total_rows}, "
                 f"bytes={self.total_bytes}"]
        for p in passes:
            lines.append(
                f"  {p.label}: {p.chunks} chunks, {p.rows} rows, "
                f"{p.wall_s:.3f}s wall (read {p.read_s:.3f}s | transform "
                f"{p.transform_s:.3f}s), {p.rows_per_s:,.0f} rows/s, "
                f"overlap {p.overlap_efficiency:.0%}"
                + (f", {p.bytes_read} bytes" if p.bytes_read else "")
                + (f", {p.retries} retries ({p.retry_wait_s:.2f}s backoff)"
                   if p.retries else "")
                + (f", {p.chunks_skipped} chunks resumed-past"
                   if p.chunks_skipped else ""))
        if self.quarantined_records:
            lines.append(f"  quarantined: {self.quarantined_records} "
                         f"record(s) / {self.quarantined_rows} row(s)")
        if self.spilled_bytes:
            lines.append(f"  spilled: {self.spilled_bytes} bytes")
        if self.checkpoint_saves or self.resumed:
            lines.append(
                f"  checkpoints: {self.checkpoint_saves} save(s), "
                f"{self.checkpoint_wall_s:.3f}s"
                + (" (resumed run)" if self.resumed else ""))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the plan profiler and the refresh counters
# ---------------------------------------------------------------------------

_COUNTERS_LOCK = threading.Lock()
_REFRESH: Dict[str, int] = {}


def count_refresh(kind: str, n: int = 1) -> None:
    """A warm-start refresh event (merged, refit, invalidated,
    geometry_changed): the process-wide mirror of the per-run
    ``workflow.refresh.RefreshReport``."""
    with _COUNTERS_LOCK:
        _REFRESH[kind] = _REFRESH.get(kind, 0) + n


def refresh_snapshot() -> Dict[str, int]:
    """The process's refresh counters with every key present (zeros
    where no refresh ran)."""
    base = {"merged": 0, "refit": 0, "invalidated": 0,
            "geometry_changed": 0}
    with _COUNTERS_LOCK:
        base.update(_REFRESH)
    return base


def backend_name(device=None) -> str:
    """The platform a run computes on (``device``, else the package's
    default device), named as the JAX package names it
    (``jax.default_backend()``): "gpu" for the card, "cpu" for the CPU,
    so that one cost history buckets both packages' observations
    alike."""
    if device is None:
        from .. import device as _device

        device = _device._default
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def kernel_launches() -> int:
    """The hand-written kernel launches so far in this process
    (``seg_level_hists.launches``)."""
    from ..models.gbdt_kernels import seg_level_hists

    return int(seg_level_hists.launches)


@dataclass
class StageProfile:
    """One executed DAG stage as the execution plan records it
    (``workflow/plan.py``; the streaming prefix's stages as
    ``workflow/streaming.py`` records them): its wall seconds, rows and
    the columns it added, and, for a stage run serially, the kernel
    launches made while it ran.  ``cols``/``dtype``/``backend``/
    ``stage_kind`` are the cost model's feature fields
    (``tuning/costmodel.py``)."""

    uid: str
    op: str
    output: str
    layer: int
    kind: str            # "fit" | "transform" | "substitute" | streamed
    device_heavy: bool
    wall_s: float
    rows: int
    cols_added: int = 0
    cols_dropped: int = 0
    launches: int = 0
    cols: int = 0
    dtype: str = ""
    backend: str = ""
    stage_kind: str = ""
    n_devices: int = 1
    mesh_shape: str = ""

    def to_json(self) -> Dict[str, Any]:
        out = {"uid": self.uid, "op": self.op, "output": self.output,
               "layer": self.layer, "kind": self.kind,
               "deviceHeavy": self.device_heavy,
               "wallSecs": round(self.wall_s, 4), "rows": self.rows,
               "colsAdded": self.cols_added,
               "colsDropped": self.cols_dropped, "launches": self.launches,
               "cols": self.cols, "dtype": self.dtype,
               "backend": self.backend,
               "stageKind": self.stage_kind or f"{self.op}:{self.kind}"}
        if self.n_devices != 1:
            out["nDevices"] = self.n_devices
        if self.mesh_shape:
            out["meshShape"] = self.mesh_shape
        return out


class PlanProfiler:
    """The stage profiles of one plan execution (thread-safe: the pool's
    host stages record from their threads), the peak and final resident
    column counts, and the run's ingest counters and lint snapshot where
    it had them."""

    def __init__(self):
        self.stages: List[StageProfile] = []
        self.peak_columns: int = 0
        self.final_columns: int = 0
        self.wall_s: float = 0.0
        self.layer_drops: Dict[int, List[str]] = {}
        #: the ``IngestProfiler`` of a chunked run, else None
        self.ingest: Optional[IngestProfiler] = None
        #: the ``LintSnapshot`` of a ``train(validate=True)``, else None
        self.lint = None
        self._lock = threading.Lock()

    def record_stage(self, sp: StageProfile) -> None:
        with self._lock:
            self.stages.append(sp)

    def note_columns(self, count: int) -> None:
        with self._lock:
            self.peak_columns = max(self.peak_columns, count)
            self.final_columns = count

    def note_drops(self, layer: int, names: List[str]) -> None:
        with self._lock:
            self.layer_drops.setdefault(layer, []).extend(names)

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            stages = sorted(self.stages, key=lambda s: (s.layer, s.output))
            out = {
                "wallSecs": round(self.wall_s, 4),
                "peakColumns": self.peak_columns,
                "finalColumns": self.final_columns,
                "layerDrops": {str(k): list(v) for k, v in
                               sorted(self.layer_drops.items())},
                "stages": [s.to_json() for s in stages],
            }
        if self.ingest is not None:
            out["ingest"] = self.ingest.to_json()
        if self.lint is not None:
            out["lint"] = self.lint.to_json()
        return out

    def format(self, top_k: int = 20) -> str:
        """The stages by wall, the costliest first (``top_k`` of them)."""
        with self._lock:
            stages = list(self.stages)
            peak, final, wall = (self.peak_columns, self.final_columns,
                                 self.wall_s)
        backend = next((s.backend for s in stages if s.backend), "")
        lines = [f"plan execution: {len(stages)} stages, "
                 f"{wall:.3f}s wall, peak {peak} resident columns "
                 f"(final {final})"
                 + (f", backend={backend}" if backend else "")]
        for s in sorted(stages, key=lambda s: -s.wall_s)[:top_k]:
            lines.append(
                f"  [{s.layer}] {s.kind:<9} {s.op:<24} {s.wall_s*1e3:8.1f} ms"
                f"  rows={s.rows}  +{s.cols_added}/-{s.cols_dropped} cols"
                + (f"  w={s.cols}" if s.cols else "")
                + (f"  launches={s.launches}" if s.launches else "")
                + ("  [device]" if s.device_heavy else ""))
        if self.ingest is not None:
            lines.append(self.ingest.format())
        if self.lint is not None:
            lines.append(self.lint.format())
        return "\n".join(lines)
