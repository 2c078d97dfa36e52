"""Cost-predicted plan-level choices (counterpart of
``transmogrifai_tpu.tuning.planner``): stream or in-core, the chunk
geometry, the prefetch depth and the retention budget for a workload of
(rows, cols) under a host budget (``advise_plan``), and the sweep's
device count (``advise_mesh``).

Surfaced through ``ExecutionPlan.advise`` / ``explain(advice=)``
(``workflow/plan.py``) and taken by ``OpWorkflow.train(tuner=Tuner(
auto_plan=True))``, which streams with the advised geometry when the
advice says "stream".  The devices come from ``torch.cuda.device_count()``
(or ``devices_available=``); the grid axis is a copy of the JAX package's
``parallel/mesh.py::auto_grid_axis`` arithmetic, since the sweep mesh
itself is ROADMAP Queue A item 6.7.  On one card the advice's
``retain_mb`` is carried and not used: in the JAX package it sizes the
mesh's block store.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .costmodel import CostModel

__all__ = ["PlanAdvice", "advise_plan", "default_host_budget_bytes",
           "MeshAdvice", "advise_mesh", "auto_grid_axis"]

#: in-core peak is taken as this multiple of the packed (N, D) f32
#: matrix: the packed output, full-width raw and intermediate columns and
#: device staging (the JAX package's constant, kept so that both
#: packages advise alike; conservative on purpose)
IN_CORE_PEAK_MULTIPLIER = 3.0

#: target bytes per streamed chunk — big enough to amortize per-chunk
#: dispatch, small enough that prefetch depth x chunk stays modest
CHUNK_TARGET_BYTES = 64 << 20

_MIN_CHUNK_ROWS = 1024


def default_host_budget_bytes() -> int:
    """Host-memory budget for plan decisions: ``TMOG_HOST_BUDGET_MB`` or
    half of physical RAM (leave room for the OS, the device runtime and
    the allocator's slack), floored at 1 GB."""
    env = os.environ.get("TMOG_HOST_BUDGET_MB")
    if env:
        try:
            return max(int(float(env) * (1 << 20)), 1 << 20)
        except ValueError:
            pass
    try:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):  # pragma: no cover
        total = 8 << 30
    return max(total // 2, 1 << 30)


@dataclass
class PlanAdvice:
    """A deterministic plan recommendation with its arithmetic shown."""

    mode: str                       # "in-core" | "stream"
    rows: int
    cols: int
    est_matrix_bytes: int
    est_in_core_peak_bytes: int
    host_budget_bytes: int
    chunk_rows: Optional[int]       # None for in-core
    prefetch_chunks: int
    retain_mb: int
    predicted_wall_s: Optional[float]   # cost-model total; None when cold
    reasons: List[str] = field(default_factory=list)
    #: optional MeshAdvice (ExecutionPlan.advise(queue_width=...))
    mesh: Optional["MeshAdvice"] = None

    def to_json(self) -> Dict[str, Any]:
        return {
            "mode": self.mode, "rows": self.rows, "cols": self.cols,
            "estMatrixBytes": self.est_matrix_bytes,
            "estInCorePeakBytes": self.est_in_core_peak_bytes,
            "hostBudgetBytes": self.host_budget_bytes,
            "chunkRows": self.chunk_rows,
            "prefetchChunks": self.prefetch_chunks,
            "retainMb": self.retain_mb,
            "predictedWallSecs": (round(self.predicted_wall_s, 3)
                                  if self.predicted_wall_s else None),
            "reasons": list(self.reasons),
            "mesh": self.mesh.to_json() if self.mesh is not None else None,
        }

    def format(self) -> str:
        mb = 1 << 20
        lines = [
            f"plan advice: {self.mode} "
            f"(matrix ~{self.est_matrix_bytes / mb:.0f} MB, in-core peak "
            f"~{self.est_in_core_peak_bytes / mb:.0f} MB vs host budget "
            f"{self.host_budget_bytes / mb:.0f} MB)"]
        if self.mode == "stream":
            lines.append(
                f"  chunk_rows={self.chunk_rows}, "
                f"prefetch_chunks={self.prefetch_chunks}, "
                f"retain_mb={self.retain_mb}")
        if self.predicted_wall_s:
            lines.append(
                f"  cost-model predicted wall ~{self.predicted_wall_s:.1f}s")
        for r in self.reasons:
            lines.append(f"  - {r}")
        if self.mesh is not None:
            lines.append(
                f"  mesh advice: {self.mesh.n_devices} device(s) "
                f"(data={self.mesh.data_axis}, grid={self.mesh.grid_axis})")
            for r in self.mesh.reasons:
                lines.append(f"  - {r}")
        return "\n".join(lines)


@dataclass
class MeshAdvice:
    """A deterministic mesh recommendation for a selector sweep."""

    n_devices: int                 # 1 = stay single-chip
    data_axis: int
    grid_axis: int
    rows: int
    cols: int
    queue_width: int
    #: predicted sweep wall per candidate device count (cost model with
    #: the n_devices feature); empty when the model is cold
    predicted_wall_s: Dict[int, float] = field(default_factory=dict)
    reasons: List[str] = field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return {"nDevices": self.n_devices, "dataAxis": self.data_axis,
                "gridAxis": self.grid_axis, "rows": self.rows,
                "cols": self.cols, "queueWidth": self.queue_width,
                "predictedWallSecs": {str(k): round(v, 4) for k, v
                                      in self.predicted_wall_s.items()},
                "reasons": list(self.reasons)}


def auto_grid_axis(n_devices: int, queue_width: Optional[int]) -> int:
    """The grid axis of a ("data", "grid") sweep mesh: rows dominate a
    tabular sweep, so the data axis keeps at least half the devices, and
    the grid axis takes power-of-two lanes up to the queue width (the
    JAX package's ``parallel/mesh.py::auto_grid_axis``)."""
    if not queue_width or queue_width <= 1 or n_devices <= 1:
        return 1
    g = 1
    while (g * 2 <= max(n_devices // 2, 1) and g * 2 <= queue_width
           and n_devices % (g * 2) == 0):
        g *= 2
    return g


#: below this many matrix elements a sweep mesh is taken to cost more in
#: collectives and padding than it saves (the JAX package's constant)
MESH_MIN_ELEMS = 1 << 22

#: the stage kinds the scaling prediction consults: the selector's
#: totals and the tree grid units
_MESH_KINDS = ("ModelSelector:fit", "ModelSelector:fit-halving",
               "RandomForest:fit-grid", "GBT:fit-grid")


def advise_mesh(rows: int, cols: int, queue_width: int,
                devices_available: Optional[int] = None,
                cost_model: Optional[CostModel] = None,
                backend: Optional[str] = None) -> MeshAdvice:
    """Recommend a ("data", "grid") sweep-mesh shape for a sweep of
    ``queue_width`` candidates over a (rows, cols) matrix.

    Tiers, mirroring the BenchBudgeter's philosophy (measured evidence
    beats a model beats an assumption):

    1. With a cost model whose selector buckets carry MEASURED multi-chip
       history (the ``n_devices`` feature), pick the device count with
       the lowest predicted sweep wall.
    2. Cold model: a size heuristic — meshes below ``MESH_MIN_ELEMS``
       matrix elements stay single-chip (dispatch-bound), larger shapes
       take every available device.

    Deterministic for fixed inputs; the grid axis comes from
    :func:`auto_grid_axis`.
    """
    import torch

    rows, cols = max(int(rows), 1), max(int(cols), 1)
    queue_width = max(int(queue_width), 1)
    n_avail = (int(devices_available) if devices_available
               else max(torch.cuda.device_count(), 1))
    reasons: List[str] = []
    predicted: Dict[int, float] = {}

    candidates = [1]
    d = 2
    while d <= n_avail:
        candidates.append(d)
        d *= 2
    if cost_model is not None:
        fitted = [k for k in _MESH_KINDS
                  if cost_model.source(k, backend) == "fitted"]
        if fitted:
            for nd in candidates:
                predicted[nd] = sum(
                    cost_model.predict(k, rows, cols, backend=backend,
                                       n_devices=nd) for k in fitted)
            best = min(predicted, key=lambda nd: (predicted[nd], nd))
            reasons.append(
                f"measured scaling history: predicted sweep wall "
                f"{ {k: round(v, 3) for k, v in predicted.items()} } "
                f"-> {best} device(s)")
            n = best
        else:
            n = n_avail if rows * cols >= MESH_MIN_ELEMS else 1
            reasons.append(
                "cost model has no selector scaling history; size "
                f"heuristic ({rows * cols} elems vs {MESH_MIN_ELEMS} "
                f"floor) -> {n} device(s)")
    else:
        n = n_avail if rows * cols >= MESH_MIN_ELEMS else 1
        reasons.append(
            f"no cost model; size heuristic ({rows * cols} elems vs "
            f"{MESH_MIN_ELEMS} floor) -> {n} device(s)")
    n = max(1, min(n, n_avail))
    g = auto_grid_axis(n, queue_width)
    return MeshAdvice(n_devices=n, data_axis=n // g, grid_axis=g,
                      rows=rows, cols=cols, queue_width=queue_width,
                      predicted_wall_s=predicted, reasons=reasons)


def advise_plan(rows: int, cols: int, dtype_bytes: int = 4,
                host_budget_bytes: Optional[int] = None,
                cost_model: Optional[CostModel] = None,
                backend: Optional[str] = None) -> PlanAdvice:
    """Pick stream-vs-in-core and the streaming geometry for a workload of
    ``rows`` x ``cols`` (the packed feature-matrix shape, or the raw
    column count as a proxy before featurization).

    Pure and deterministic given its inputs: same shape + same budget →
    same advice, so plans are reproducible and testable.
    """
    rows, cols = max(int(rows), 1), max(int(cols), 1)
    budget = (int(host_budget_bytes) if host_budget_bytes
              else default_host_budget_bytes())
    matrix = rows * cols * dtype_bytes
    peak = int(matrix * IN_CORE_PEAK_MULTIPLIER)
    reasons: List[str] = []
    predicted = None
    if cost_model is not None:
        total = cost_model.predict_total(rows, cols, backend=backend)
        predicted = total or None

    if peak <= budget:
        reasons.append(
            f"projected in-core peak {peak >> 20} MB fits the "
            f"{budget >> 20} MB host budget")
        return PlanAdvice(
            mode="in-core", rows=rows, cols=cols,
            est_matrix_bytes=matrix, est_in_core_peak_bytes=peak,
            host_budget_bytes=budget, chunk_rows=None, prefetch_chunks=2,
            retain_mb=0, predicted_wall_s=predicted, reasons=reasons)

    row_bytes = max(cols * dtype_bytes, 1)
    chunk_rows = max(min(CHUNK_TARGET_BYTES // row_bytes, rows),
                     _MIN_CHUNK_ROWS)
    prefetch = 2
    if cost_model is not None:
        # read-bound pipelines benefit from deeper parse-ahead: compare
        # the model's ingest-read kinds against its transform kinds
        kinds = cost_model.fitted_kinds
        read_s = sum(cost_model.predict(k, chunk_rows, cols,
                                        backend=backend)
                     for k in kinds if "read" in k.lower())
        tx_s = sum(cost_model.predict(k, chunk_rows, cols, backend=backend)
                   for k in kinds if "transform" in k.lower())
        if read_s > 0 and tx_s > 0 and read_s > 1.5 * tx_s:
            prefetch = 4
            reasons.append(
                f"cost model predicts read-bound chunks "
                f"(read ~{read_s:.3f}s vs transform ~{tx_s:.3f}s) — "
                f"prefetch depth raised to 4")
    # spill threshold: retained blocks may use ~a quarter of the budget
    # before the block store spills to disk
    retain_mb = max(64, int(budget // 4) >> 20)
    reasons.append(
        f"projected in-core peak {peak >> 20} MB exceeds the "
        f"{budget >> 20} MB host budget — streaming with "
        f"~{CHUNK_TARGET_BYTES >> 20} MB chunks")
    return PlanAdvice(
        mode="stream", rows=rows, cols=cols,
        est_matrix_bytes=matrix, est_in_core_peak_bytes=peak,
        host_budget_bytes=budget, chunk_rows=int(chunk_rows),
        prefetch_chunks=prefetch, retain_mb=retain_mb,
        predicted_wall_s=predicted, reasons=reasons)
