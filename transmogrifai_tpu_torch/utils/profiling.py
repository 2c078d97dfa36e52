"""Run metrics, the transfer ledger and the ingestion and plan profilers
(counterpart of ``transmogrifai_tpu.utils.profiling``): the app metrics
of a runner's run (``OpStep``, ``StepMetrics``, ``AppMetrics``,
``MetricsCollector``, ``install_collector``, ``with_job_group``); the
process-wide transfer and dispatch ledger (``RunCounters``/``COUNTERS``:
uploads, fetches, drains, launches by tag, the elastic and refresh
counts; ``fetch_timed``, ``upload_timed``); ``profile_to``, a
``torch.profiler`` trace of a block that Perfetto loads; the
chunked-ingestion counters of an out-of-core train (``IngestPass``,
``IngestProfiler``) and the plan profiler of ``train(profile=True)``
(``StageProfile``, ``PlanProfiler``: a stage's wall, rows, input width,
for a serial stage its ``seg_hist`` launches and, under a trace, its
kernel mix in ``hlo``: ``obs/kernel_mix.py``).
"""
from __future__ import annotations

import contextlib
import enum
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = ["OpStep", "StepMetrics", "AppMetrics", "MetricsCollector",
           "current_collector", "install_collector", "with_job_group",
           "IngestPass", "IngestProfiler", "StageProfile", "PlanProfiler",
           "backend_name", "kernel_launches", "RunCounters", "COUNTERS",
           "reset_counters", "count_upload", "count_fetch", "count_drain",
           "count_launch", "count_elastic", "count_refresh",
           "elastic_snapshot", "refresh_snapshot", "fetch_timed",
           "upload_timed", "profile_to"]


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
# the transfer and dispatch ledger
# ---------------------------------------------------------------------------

@dataclass
class RunCounters:
    """Transfer and dispatch accounting for one run (the JAX package's
    ``to_json`` keys).

    Uploads and fetches are counted at the port's own transfer sites: the
    tree memo's edges and bundling tables going to the card
    (``upload_timed``), the sweep's metric copies, halving's promotion
    (``fetch_timed``).  ``fetch_timed`` splits a fetch in two: the wait
    for the stream's queued work (``drain_s``: compute to wait for) and
    the copy itself (``fetch_s``: bytes on the wire).  A wait with later
    work already queued behind it goes to ``overlap_s`` instead.
    ``drain_tags`` attributes both kinds of wait to their site, keyed
    ``tag`` or ``tag + "+overlap"``.  ``launches`` counts the hand-written
    kernel launches and served batches at their call sites
    (``launch_tags``: ``seg_hist``, ``serving.batch``): a design-level
    count, not the profiler's (``obs/kernel_mix.py``).  ``elastic``
    mirrors every sweep's ``ElasticCounters`` and ``refresh`` every
    refresh's report."""

    upload_bytes: int = 0
    upload_s: float = 0.0
    uploads: int = 0
    fetch_bytes: int = 0
    fetch_s: float = 0.0
    fetches: int = 0
    drain_s: float = 0.0
    drains: int = 0
    overlap_s: float = 0.0
    overlaps: int = 0
    drain_tags: Dict[str, float] = field(default_factory=dict)
    launches: int = 0
    launch_tags: Dict[str, int] = field(default_factory=dict)
    #: retries / mesh_shrinks / mesh_repacks / quarantined /
    #: watchdog_fires / device_losses (parallel/elastic.py)
    elastic: Dict[str, int] = field(default_factory=dict)
    #: merged / refit / invalidated / geometry_changed (workflow/refresh.py)
    refresh: Dict[str, int] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "uploadBytes": self.upload_bytes,
            "uploadSecs": round(self.upload_s, 3),
            "uploads": self.uploads,
            "fetchBytes": self.fetch_bytes,
            "fetchSecs": round(self.fetch_s, 3),
            "fetches": self.fetches,
            "drainSecs": round(self.drain_s, 3),
            "drains": self.drains,
            "overlapSecs": round(self.overlap_s, 3),
            "overlaps": self.overlaps,
            "drainTags": {k: round(v, 3) for k, v in self.drain_tags.items()},
            "launches": self.launches,
            "launchTags": dict(self.launch_tags),
            "elastic": dict(self.elastic),
            "refresh": dict(self.refresh),
        }


COUNTERS = RunCounters()

#: guards every change of ``COUNTERS``: the count sites run at once from
#: the plan's pool, the serving dispatch thread and request threads
_COUNTERS_LOCK = threading.Lock()


def reset_counters() -> RunCounters:
    """Zero the ledger; returns the new ``COUNTERS`` (read it as
    ``profiling.COUNTERS``: a name imported before the reset keeps the
    old object)."""
    global COUNTERS
    with _COUNTERS_LOCK:
        COUNTERS = RunCounters()
        return COUNTERS


def count_upload(nbytes: int, seconds: float) -> None:
    with _COUNTERS_LOCK:
        COUNTERS.upload_bytes += int(nbytes)
        COUNTERS.upload_s += seconds
        COUNTERS.uploads += 1


def count_fetch(nbytes: int, seconds: float) -> None:
    with _COUNTERS_LOCK:
        COUNTERS.fetch_bytes += int(nbytes)
        COUNTERS.fetch_s += seconds
        COUNTERS.fetches += 1


def count_drain(seconds: float, tag: Optional[str] = None,
                overlapped: bool = False) -> None:
    """Book a wait for the card.  ``overlapped=True``: later work was
    already queued when the wait began (the card stays busy), so the
    time goes to ``overlap_s``, not ``drain_s``.  ``tag`` attributes it
    in ``drain_tags`` (``+overlap`` appended for an overlapped wait)."""
    with _COUNTERS_LOCK:
        if overlapped:
            COUNTERS.overlap_s += seconds
            COUNTERS.overlaps += 1
        else:
            COUNTERS.drain_s += seconds
            COUNTERS.drains += 1
        if tag is not None:
            key = tag + "+overlap" if overlapped else tag
            COUNTERS.drain_tags[key] = (
                COUNTERS.drain_tags.get(key, 0.0) + seconds)


def count_launch(tag: str, n: int = 1) -> None:
    with _COUNTERS_LOCK:
        COUNTERS.launches += n
        COUNTERS.launch_tags[tag] = COUNTERS.launch_tags.get(tag, 0) + n


def count_elastic(kind: str, n: int = 1) -> None:
    """An elastic-sweep event: the process-wide mirror of the per-sweep
    ``parallel.elastic.ElasticCounters``."""
    with _COUNTERS_LOCK:
        COUNTERS.elastic[kind] = COUNTERS.elastic.get(kind, 0) + n


def count_refresh(kind: str, n: int = 1) -> None:
    """A warm-start refresh event (merged, refit, invalidated,
    geometry_changed): the process-wide mirror of the per-run
    ``workflow.refresh.RefreshReport``."""
    with _COUNTERS_LOCK:
        COUNTERS.refresh[kind] = COUNTERS.refresh.get(kind, 0) + n


def refresh_snapshot() -> Dict[str, int]:
    """The process's refresh counters with every key present (zeros
    where no refresh ran)."""
    base = {"merged": 0, "refit": 0, "invalidated": 0,
            "geometry_changed": 0}
    with _COUNTERS_LOCK:
        base.update(COUNTERS.refresh)
    return base


def elastic_snapshot() -> Dict[str, int]:
    """The process's elastic counters with every key present (zeros where
    no sweep degraded)."""
    base = {"retries": 0, "mesh_shrinks": 0, "mesh_repacks": 0,
            "quarantined": 0, "watchdog_fires": 0, "device_losses": 0}
    with _COUNTERS_LOCK:
        base.update(COUNTERS.elastic)
    return base


def fetch_timed(x, dtype=None, tag: Optional[str] = None,
                overlapped: bool = False):
    """A device-to-host copy as a numpy array, booked in two parts.  On a
    CUDA tensor the wait for the current stream
    (``torch.cuda.current_stream().synchronize()``) is booked as drain
    (``overlapped=True``: as overlap, for a wait with later work queued
    behind it), and the copy itself as fetch, against the bytes fetched.
    On a CPU tensor the drain is ~0.  ``tag`` names the site in
    ``drain_tags``; ``dtype`` converts on the host."""
    import numpy as np

    t0 = time.perf_counter()
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()
    t1 = time.perf_counter()
    host = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
    out = np.asarray(host) if dtype is None else np.asarray(host, dtype)
    t2 = time.perf_counter()
    count_drain(t1 - t0, tag=tag, overlapped=overlapped)
    count_fetch(out.nbytes, t2 - t1)
    return out


def upload_timed(a, device) -> torch.Tensor:
    """A host array as a tensor on ``device``, booked as an upload (its
    bytes and the seconds of the copy call; on the CPU a no-op copy)."""
    import numpy as np

    t0 = time.perf_counter()
    out = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    count_upload(out.numel() * out.element_size(), time.perf_counter() - t0)
    return out


@contextlib.contextmanager
def profile_to(log_dir: str):
    """``torch.profiler`` over the block, with the CPU activity and, where
    a card is present, the CUDA one; writes ``log_dir/trace.json``, a
    Chrome trace that Perfetto loads (the counterpart of the JAX
    package's ``jax.profiler`` capture).  While it runs, the per-stage
    kernel mix records nothing (one profiler at a time); it raises where
    that capture holds the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from ..obs import kernel_mix

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with kernel_mix.exclusive("profile_to"):
        with profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# the plan profiler
# ---------------------------------------------------------------------------

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
    launches made while it ran and, under a trace, its kernel mix
    (``hlo``, serialised only when non-empty).  ``cols``/``dtype``/
    ``backend``/``stage_kind`` are the cost model's feature fields
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
    #: the stage's kernel mix under a trace (``obs/kernel_mix.py``):
    #: {"programs", "ops", "deviceSecs"}; empty when untraced
    hlo: Dict[str, Any] = field(default_factory=dict)

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
        if self.hlo:
            out["hlo"] = dict(self.hlo)
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
