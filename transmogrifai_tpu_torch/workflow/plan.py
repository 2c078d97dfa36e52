"""Execution planning for the feature DAG — column liveness, layer
parallelism and per-stage profiling (counterpart of
``transmogrifai_tpu.workflow.plan``).

* **Column liveness**: computed once per (DAG, keep-set) and memoized on
  the DAG, every column's last consumer layer is known statically, so
  each intermediate is dropped right after that layer instead of
  accumulating for the whole run, and the stages the keep-set does not
  need are skipped.  With ``keep=None`` nothing is pruned.
* **Layer parallelism** (``fit_and_transform``): the stages of one layer
  are independent (every input comes from an earlier layer), so a
  layer's host stages run on a bounded thread pool when the host has
  more than one core and the data at least ``TMOG_PLAN_PARALLEL_MIN_ROWS``
  rows (4096); ``TMOG_PLAN_WORKERS``, read at each layer, sets the pool's
  size (1: every stage inline).  ``device_heavy`` stages (models, the
  selector, SanityChecker) run serially on the calling thread in stable
  layer order.  Each stage writes one column from earlier layers'
  columns and the outputs merge in layer order, so the result is
  bitwise the serial run's.
* **Per-stage profiling**: a ``PlanProfiler`` gets every stage's wall,
  rows, input width and, for a serially run stage, its kernel launches
  (``utils/profiling.py``), plus the resident column counts.  Under a
  trace (``obs/trace.py``) each layer is a ``plan.layer[i]`` span and
  each stage a ``stage:<OpClass>`` span under it (the pool's threads get
  the layer span as their parent), and each serial stage runs under the
  kernel-mix capture (``obs/kernel_mix.py``) into its profile's
  ``hlo``.
* **Advice** (``advise``, ``explain(advice=)``): the cost planner's
  stream-or-in-core choice for a workload (``tuning/planner.py``).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..obs import kernel_mix
from ..obs.trace import adopt_span, begin_span, current_tracer, end_span
from ..stages.base import Estimator, Model, PipelineStage, Transformer
from ..types.columns import ColumnarDataset, FeatureColumn
from ..utils.profiling import (PlanProfiler, StageProfile, backend_name,
                               current_collector, install_collector,
                               kernel_launches)

__all__ = ["ExecutionPlan", "plan_for"]

#: rows below which a layer's host stages are not worth a thread each
_PARALLEL_ROW_THRESHOLD = int(os.environ.get(
    "TMOG_PLAN_PARALLEL_MIN_ROWS", "4096"))


def _plan_workers() -> int:
    """The pool's size, read at each layer: ``TMOG_PLAN_WORKERS`` where
    set (1: every stage inline, in stable order), else one less than the
    cores, between 2 and 8, and 1 on a host of one core."""
    env = os.environ.get("TMOG_PLAN_WORKERS")
    if env:
        return max(int(env), 1)
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:
        cores = os.cpu_count() or 1
    return min(8, max(2, cores - 1)) if cores > 1 else 1


_POOLS: Dict[int, ThreadPoolExecutor] = {}
_POOL_LOCK = threading.Lock()


def _pool(workers: int) -> ThreadPoolExecutor:
    """The process's pool of ``workers`` threads for host stages, made on
    first use.  Its tasks are leaves (a stage never submits to it), so a
    shared pool cannot deadlock on itself."""
    with _POOL_LOCK:
        pool = _POOLS.get(workers)
        if pool is None:
            pool = _POOLS[workers] = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="tmog-plan")
        return pool


def plan_for(dag, keep: Optional[Sequence[str]] = None) -> "ExecutionPlan":
    """The memoized plan for ``dag`` with the given keep-set (cached on the
    DAG object, so scoring and serving share one per model)."""
    cache = dag.__dict__.setdefault("_plan_cache", {})
    key = frozenset(keep) if keep is not None else None
    plan = cache.get(key)
    if plan is None:
        plan = cache[key] = ExecutionPlan(dag, keep=keep)
    return plan


class ExecutionPlan:
    """A per-DAG schedule: the executed layers, the liveness drops and
    each layer's split into host and device stages."""

    def __init__(self, dag, keep: Optional[Sequence[str]] = None):
        self.dag = dag
        self.keep: Optional[frozenset] = (
            frozenset(keep) if keep is not None else None)
        self.layers: List[List[PipelineStage]] = [
            layer for layer in dag.non_generator_layers() if layer]
        #: the most columns resident at once in the last ``transform``
        self.peak_columns: Optional[int] = None
        self._analyze()

    def _analyze(self) -> None:
        from ..stages.generator import FeatureGeneratorStage

        # raw generator outputs are "produced" at layer -1; columns the
        # plan does not know (a reader's extras) are never dropped
        produced_at: Dict[str, int] = {
            s.get_output().name: -1 for layer in self.dag.layers
            for s in layer if isinstance(s, FeatureGeneratorStage)}
        for li, layer in enumerate(self.layers):
            for s in layer:
                produced_at[s.get_output().name] = li
        self._produced_at = produced_at

        out_stage = {s.get_output().name: s
                     for layer in self.layers for s in layer}
        needed: Set[str] = set()
        if self.keep is None:
            needed = {s.uid for layer in self.layers for s in layer}
        else:
            frontier = [out_stage[n] for n in self.keep if n in out_stage]
            while frontier:
                s = frontier.pop()
                if s.uid in needed:
                    continue
                needed.add(s.uid)
                frontier += [out_stage[f.name] for f in s.input_features
                             if f.name in out_stage]
        self.needed_uids = needed

        last_use: Dict[str, int] = {}
        for li, layer in enumerate(self.layers):
            for s in layer:
                if s.uid in needed:
                    for n in s.input_names:
                        last_use[n] = li
        self.initial_drops, self.drops_after = self._drop_schedule(last_use)
        # the fit path runs every stage, so every consumer pins its inputs
        fit_use: Dict[str, int] = {}
        for li, layer in enumerate(self.layers):
            for s in layer:
                for n in s.input_names:
                    fit_use[n] = li
        self._fit_drops = self._drop_schedule(fit_use)

    def _drop_schedule(self, last_use: Dict[str, int]
                       ) -> Tuple[List[str], List[List[str]]]:
        """(drops before layer 0, drops after each layer): a known column
        outside ``keep`` dies after its last executed consumer; one nobody
        consumes dies as soon as it exists."""
        initial: List[str] = []
        after: List[List[str]] = [[] for _ in self.layers]
        if self.keep is None:
            return initial, after
        for name, pl in self._produced_at.items():
            if name in self.keep:
                continue
            die = last_use.get(name, pl)
            (initial if die < 0 else after[die]).append(name)
        initial.sort()
        for names in after:
            names.sort()
        return initial, after

    def required_input_columns(self) -> frozenset:
        """Input-dataset columns the plan reads: the executed stages'
        raw (or plan-unknown) inputs plus the keep-set."""
        req = set(self.keep or ())
        for layer in self.layers:
            for s in layer:
                if s.uid in self.needed_uids:
                    req.update(n for n in s.input_names
                               if self._produced_at.get(n, -1) < 0)
        return frozenset(req)

    def transform(self, data: ColumnarDataset,
                  on_stage: Optional[Callable[[PipelineStage, float], None]]
                  = None) -> ColumnarDataset:
        """Apply the fitted DAG, pruned.  ``on_stage(stage, seconds)`` is
        called after each executed stage (the host's time of its
        ``transform``; the work it queued on the card may still run).
        ``peak_columns`` is left set to the most columns resident at once
        during the run."""
        for layer in self.layers:
            for s in layer:
                if isinstance(s, Estimator):
                    raise RuntimeError(
                        f"unfitted estimator {s.uid} in scoring DAG")
        if self.initial_drops:
            data = data.drop(self.initial_drops)
        peak = len(data.columns)
        for li, layer in enumerate(self.layers):
            for s in layer:
                if s.uid in self.needed_uids:
                    t0 = time.perf_counter()
                    data = s.transform(data)
                    if on_stage is not None:
                        on_stage(s, time.perf_counter() - t0)
            peak = max(peak, len(data.columns))
            if self.drops_after[li]:
                data = data.drop(self.drops_after[li])
        self.peak_columns = peak
        return data

    # -- advice and report ---------------------------------------------------

    def advise(self, rows: int, cols: int, cost_model=None,
               host_budget_bytes: Optional[int] = None,
               queue_width: Optional[int] = None, device=None):
        """The cost planner's choices for this DAG at ``rows`` x ``cols``:
        stream or in-core, the chunk geometry, the prefetch depth, the
        retention budget (``tuning/planner.py``).  ``cost_model`` (default:
        fitted from the history at ``TMOG_COST_HISTORY``) adds a predicted
        wall; ``queue_width`` (the selector's candidate count) adds the
        mesh advice."""
        from ..tuning.costmodel import CostModel
        from ..tuning.planner import advise_mesh, advise_plan

        if cost_model is None:
            cost_model = CostModel.from_history()
        backend = backend_name(device)
        advice = advise_plan(rows, cols, cost_model=cost_model,
                             host_budget_bytes=host_budget_bytes,
                             backend=backend)
        if queue_width is not None:
            advice.mesh = advise_mesh(rows, cols, queue_width=queue_width,
                                      cost_model=cost_model,
                                      backend=backend)
        return advice

    def explain(self, ingest=None, advice=None) -> str:
        """The plan as text: each layer's stages and host/device split,
        the liveness drops and the projected peak of resident columns;
        with an ``IngestProfiler`` (a chunked train's
        ``model.ingest_profile``) its passes, and with a ``PlanAdvice``
        the planner's recommendation."""
        initial, after = self._fit_drops
        lines = [
            f"ExecutionPlan: {sum(len(layer) for layer in self.layers)} "
            f"stages over {len(self.layers)} layers"
            + (f", keep={len(self.keep)} columns" if self.keep is not None
               else ", keep=ALL (no pruning)")]
        resident = sum(1 for pl in self._produced_at.values() if pl < 0) \
            - len(initial)
        peak = resident
        if initial:
            lines.append(f"  drop before layer 0: {initial}")
        for li, layer in enumerate(self.layers):
            host = [s for s in layer if not s.device_heavy]
            dev = [s for s in layer if s.device_heavy]
            resident += len(layer)
            peak = max(peak, resident)
            desc = ", ".join(f"{type(s).__name__}->{s.get_output().name}"
                             for s in layer)
            par = (f"{len(host)} host-parallel"
                   + (f" + {len(dev)} device-serial" if dev else "")
                   if len(host) > 1 else
                   ("device-serial" if dev and not host else "serial"))
            lines.append(f"  layer {li} [{par}]: {desc}")
            if after[li]:
                resident -= len(after[li])
                lines.append(f"    drop after layer {li}: {after[li]}")
        lines.append(f"  projected resident columns: peak {peak}, "
                     f"final {resident}")
        if ingest is not None:
            lines.append(ingest.format())
        if advice is not None:
            lines.append(advice.format())
        return "\n".join(lines)

    # -- the fit path --------------------------------------------------------

    def fit_and_transform(
        self, data: ColumnarDataset,
        fitted_substitutes: Optional[Dict[str, Model]] = None,
        profiler: Optional[PlanProfiler] = None,
        on_stage: Optional[Callable[[PipelineStage, float], None]] = None,
    ) -> Tuple[List[PipelineStage], ColumnarDataset]:
        """Fit the estimators layer by layer, transforming as it goes:
        (the fitted stages in layer order, the transformed data).  An
        estimator whose uid is a key of ``fitted_substitutes`` is not
        fitted: that model stands for it.  ``on_stage(stage, seconds)``
        is called on this thread after each layer, in stable order, with
        each stage's fit-and-transform seconds."""
        subs = fitted_substitutes or {}
        prof = profiler if profiler is not None else PlanProfiler()
        t_start = time.perf_counter()
        fitted: List[PipelineStage] = []
        initial, drops_after = self._fit_drops
        if initial:
            data = data.drop(initial)
        prof.note_columns(len(data.columns))
        for li, layer in enumerate(self.layers):
            results = self._run_layer(li, layer, data, subs, prof)
            new_cols: Dict[str, FeatureColumn] = {}
            for stage in layer:
                rs, name, col, dt = results[stage.uid]
                fitted.append(rs)
                new_cols[name] = col
                if on_stage is not None:
                    on_stage(stage, dt)
            data = data.with_columns(new_cols)
            prof.note_columns(len(data.columns))
            if drops_after[li]:
                data = data.drop(drops_after[li])
                prof.note_drops(li, drops_after[li])
                prof.note_columns(len(data.columns))
        prof.wall_s += time.perf_counter() - t_start
        return fitted, data

    def _run_layer(self, li: int, layer: List[PipelineStage],
                   data: ColumnarDataset, subs, prof: PlanProfiler
                   ) -> Dict[str, Tuple[PipelineStage, str, FeatureColumn,
                                        float]]:
        """One layer's stages: the host ones on the pool where it pays,
        else inline, then the device-heavy ones serially, each in stable
        order."""
        n_rows = len(data)
        host = [s for s in layer if not s.device_heavy]
        dev = [s for s in layer if s.device_heavy]
        workers = _plan_workers()
        use_pool = (workers > 1 and len(host) > 1
                    and n_rows >= _PARALLEL_ROW_THRESHOLD)
        results = {}
        futures = []
        layer_span = begin_span(f"plan.layer[{li}]", cat="plan",
                                stages=len(layer), rows=n_rows)
        try:
            if use_pool:
                coll = current_collector()
                pool = _pool(workers)
                # a pool thread's stage span takes the layer's as its
                # parent, handed over explicitly
                futures = [(s, pool.submit(_under, layer_span,
                                           self._run_stage, s, data, subs,
                                           li, n_rows, prof, coll, False))
                           for s in host]
            else:
                for s in host:
                    results[s.uid] = self._run_stage(
                        s, data, subs, li, n_rows, prof, None, True)
            try:
                for s in dev:
                    results[s.uid] = self._run_stage(
                        s, data, subs, li, n_rows, prof, None, True)
            finally:
                # no host stage outlives its layer, whether this raised
                for s, fut in futures:
                    results[s.uid] = fut.result()
        finally:
            end_span(layer_span)
        return results

    @staticmethod
    def _run_stage(stage: PipelineStage, data: ColumnarDataset, subs,
                   li: int, n_rows: int, prof: PlanProfiler, coll,
                   serial: bool):
        """Fit (or take the substitute of) and transform one stage:
        (the fitted stage, its output name, its column, its seconds).  A
        serial stage is charged the kernel launches made while it ran
        and, under a trace, records its kernel mix; a pool thread runs
        under the caller's metrics collector.  Its span's parent is the
        thread's current span (the layer's)."""
        t0 = time.perf_counter()
        launches0 = kernel_launches() if serial else 0
        name = stage.get_output().name
        stage_span = begin_span(
            f"stage:{type(stage).__name__}", cat="stage", uid=stage.uid,
            layer=li, output=name, rows=n_rows, device=stage.device_heavy)
        mix = (kernel_mix.capture(getattr(stage, "device", None))
               if serial and current_tracer() is not None
               else contextlib.nullcontext({}))
        ctx = install_collector(coll) if coll is not None else None
        if ctx is not None:
            ctx.__enter__()
        try:
            with mix as stage_mix:
                if isinstance(stage, Estimator):
                    sub = subs.get(stage.uid)
                    kind = "fit" if sub is None else "substitute"
                    result_stage = sub if sub is not None else \
                        stage.fit(data)
                elif isinstance(stage, Transformer):
                    kind, result_stage = "transform", stage
                else:
                    raise TypeError(f"cannot execute stage {stage!r}")
                col = result_stage.transform(data)[name]
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
            end_span(stage_span)
        dt = time.perf_counter() - t0
        width, dtype = _input_shape(stage, data)
        op = type(stage).__name__
        cost_kind = (getattr(stage, "_cost_kind", None)
                     or getattr(result_stage, "_cost_kind", None) or kind)
        prof.record_stage(StageProfile(
            uid=stage.uid, op=op, output=name, layer=li, kind=kind,
            device_heavy=stage.device_heavy, wall_s=dt, rows=n_rows,
            cols_added=1,
            launches=kernel_launches() - launches0 if serial else 0,
            cols=width, dtype=dtype,
            backend=backend_name(getattr(stage, "device", None)),
            stage_kind=f"{op}:{cost_kind}", hlo=dict(stage_mix)))
        return result_stage, name, col, dt


def _under(parent, fn, *args):
    """``fn(*args)`` on a pool thread with ``parent`` as its current span
    (``obs.trace.adopt_span``)."""
    with adopt_span(parent):
        return fn(*args)


def _input_shape(stage: PipelineStage, data: ColumnarDataset):
    """(the total scalar width of a stage's inputs, the first input's
    dtype as numpy names it): the cost model's view of a stage's work, a
    vectorizer of one raw column 1, the selector of a packed (N, D)
    matrix D.  Reads shapes only."""
    width, dtype = 0, ""
    for n in stage.input_names:
        if n not in data:
            continue
        v = data[n].values
        shape = getattr(v, "shape", None)
        width += int(shape[1]) if shape is not None and len(shape) > 1 \
            else 1
        if not dtype:
            dtype = str(getattr(v, "dtype", "") or type(v).__name__)
            dtype = dtype.replace("torch.", "")
    return max(width, 1), dtype
