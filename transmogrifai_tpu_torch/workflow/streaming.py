"""Out-of-core training: the chunked two-pass fit driver (counterpart of
``transmogrifai_tpu.workflow.streaming``), behind
``OpWorkflow.train(chunk_rows=k)``.

The design is the external-memory two-pass fit of "XGBoost: Scalable GPU
Accelerated Learning" (arXiv:1806.11248): sketch passes build mergeable
fit states chunk by chunk, then the last pass writes only the columns the
rest of the pipeline needs.

1. **Streamable prefix**: the DAG layers before the first estimator that
   cannot stream (``_split_streamable``).  Each chunk flows through the
   stages fitted so far, its columns dropped after their last consumer
   (``_liveness``).
2. **Reader passes, at most two**: every estimator layer before the fuse
   point fits on a pass of its own; the pass of the fuse point (the
   second estimator layer, or the only one) also writes the columns
   already computable into full-length buffers (``_ColumnWriter``) and
   keeps, per chunk, the columns the rest of the prefix needs as blocks
   (``_BlockStore``).
3. **Block cascade**: the later estimator layers and the assembly run
   over the retained blocks, never the reader: each block goes through
   the stages fitted so far, feeds the next layer's states and is
   retained again as views of the output buffers, the input block freed
   as it is consumed, so input blocks and output views never coexist in
   full.
4. **Tail**: the layers from the first estimator that cannot stream (a
   model selector) run in-core on the packed columns.

Where the port differs: its transforms give tensors on the card, so a
retained block is device memory and counts as such against the retention
budget (``TMOG_STREAM_RETAIN_MB``, default 256 MB, the JAX package's
knob); past it a block is copied to one host temp file and reloaded onto
its device when the cascade pops it.  The (N, D) float32 output is
preallocated on the card, where the tail's selector reads it.  The temp
file goes on success and on error.  The prefetch thread (``AsyncBatcher``)
only parses: the transforms, and every copy to the card, run on the
calling thread.

With a reader-side retry policy (``reader.with_resilience(retry=...)``,
readers/resilience.py) every pass's chunk stream is wrapped in a
``RetryingChunkStream``: a transient IO error backs off, reopens the
reader and skips exactly the chunks already delivered.  Retries, backoff
seconds and quarantined records land in the ``IngestProfiler``.

With ``checkpoint_dir`` (``workflow/checkpoint.py``) the fit passes
before the fused one save their states every ``checkpoint_every`` chunks
and their models when they complete; a rerun against the same directory
resumes: a completed pass's models are adopted and the pass is not read
again, the pass in flight restores its states and skips the chunks it
had folded (``chunks_skipped``).  The fused pass is not checkpointed (its
progress is the output buffers): a crash there reruns it from its
boundary.  Success removes the checkpoint.

A refresh (``refresh_ctx``, ``workflow/refresh.py``) begins each
estimator from its base model's restored state where still valid; a
streaming workflow-CV train (``cv_ctx``, ``workflow/streaming_cv.py``)
folds a state a fold as well and validates between the prefix and the
tail; a ``profiler`` gets every stage's profile.  Not ported: the spans
of the trace layer (ROADMAP Queue A item 6.5.5), pods and meshes (6.7).
"""
from __future__ import annotations

import copy
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..models.prediction import PredictionBatch
from ..readers.streaming import AsyncBatcher
from ..stages.base import Estimator, Model, PipelineStage
from ..types.columns import ColumnarDataset, FeatureColumn
from ..utils.profiling import (IngestPass, IngestProfiler, PlanProfiler,
                               StageProfile, backend_name)

__all__ = ["fit_dag_streaming"]

_RETAIN_MB_ENV = "TMOG_STREAM_RETAIN_MB"
_RETAIN_MB_DEFAULT = 256


def _retain_budget_bytes() -> int:
    try:
        mb = float(os.environ.get(_RETAIN_MB_ENV, "") or _RETAIN_MB_DEFAULT)
    except ValueError:
        mb = _RETAIN_MB_DEFAULT
    return int(mb * (1 << 20))


def _nbytes(values) -> int:
    if isinstance(values, torch.Tensor):
        return values.numel() * values.element_size()
    if isinstance(values, np.ndarray):
        return values.nbytes
    return 0


class _BlockStore:
    """Retained per-chunk blocks, spilled to one temp file past a byte
    budget.  Blocks under the budget stay where their columns are (a
    tensor on its device); past it every further block's arrays are
    appended to the file (a tensor copied to the host first) and reloaded
    on ``pop``, onto the tensor's device.  Blocks are popped once, in
    order, so the file is written and read sequentially."""

    def __init__(self, budget_bytes: int):
        self._budget = budget_bytes
        self._bytes = 0
        self._mem: List[Optional[ColumnarDataset]] = []
        self._meta: List[Optional[list]] = []
        self._fh = None
        self._path: Optional[str] = None
        self.spilled_bytes = 0

    def __len__(self) -> int:
        return len(self._mem)

    def append(self, ds: ColumnarDataset) -> None:
        nbytes = sum(_nbytes(c.values) for c in ds.columns.values())
        if self._fh is None and self._bytes + nbytes <= self._budget:
            self._bytes += nbytes
            self._mem.append(ds)
            self._meta.append(None)
            return
        if self._fh is None:
            fd, self._path = tempfile.mkstemp(prefix="tmog_spill_",
                                              suffix=".npy")
            self._fh = os.fdopen(fd, "w+b")
        layout = []
        for name, col in ds.columns.items():
            v = col.values
            device = v.device if isinstance(v, torch.Tensor) else None
            if device is not None:
                v = v.detach().cpu().numpy()
            if not isinstance(v, np.ndarray):
                layout.append((name, col, None, None, None))
                continue
            offset = self._fh.tell()
            np.save(self._fh, v, allow_pickle=True)
            mask_off = None
            if col.mask is not None:
                mask_off = self._fh.tell()
                np.save(self._fh, np.asarray(col.mask))
            layout.append((name, col, device, offset, mask_off))
        self._mem.append(None)
        self._meta.append(layout)
        self.spilled_bytes += nbytes

    def pop(self, i: int) -> ColumnarDataset:
        ds = self._mem[i]
        if ds is not None:
            self._mem[i] = None
            return ds
        layout, self._meta[i] = self._meta[i], None
        cols: Dict[str, FeatureColumn] = {}
        for name, col, device, offset, mask_off in layout:
            if offset is None:
                cols[name] = col
                continue
            self._fh.seek(offset)
            values = np.load(self._fh, allow_pickle=True)
            if device is not None:
                values = torch.from_numpy(values).to(device)
            mask = None
            if mask_off is not None:
                self._fh.seek(mask_off)
                mask = np.load(self._fh)
            cols[name] = FeatureColumn(col.ftype, values, mask, col.vmeta)
        return ColumnarDataset(cols, _validated=True)

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            finally:
                self._fh = None
        if self._path is not None:
            try:
                os.unlink(self._path)
            except OSError:
                pass
            self._path = None


class _TimedChunks:
    """A reader's chunk stream with parse timing and byte accounting; it
    runs on the prefetch thread."""

    def __init__(self, stream, pass_stats: IngestPass):
        self._stream = iter(stream)
        self._pass = pass_stats
        self._last_bytes = 0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        ds = next(self._stream)
        dt = time.perf_counter() - t0
        nb = int(getattr(self._stream, "bytes_read", 0) or 0)
        delta, self._last_bytes = nb - self._last_bytes, nb
        self._pass.note_read(len(ds), dt, max(delta, 0))
        return ds


def _cat_predictions(parts: List[PredictionBatch]) -> PredictionBatch:
    def cat(field):
        ts = [getattr(p, field) for p in parts]
        return None if ts[0] is None else torch.cat(ts)

    return PredictionBatch(cat("prediction"), cat("raw_prediction"),
                           cat("probability"))


class _ColumnWriter:
    """Writes per-chunk columns into full-length buffers.  With the row
    count known (an earlier pass counted it), host arrays and device
    tensors are preallocated once (a tensor on its own device: the packed
    (N, D) float32 matrix on the card); else, and for predictions, the
    chunks' parts are concatenated at ``finish``.  ``row_view`` gives a
    row range of a written buffer, a view, so the cascade can retain
    written columns without holding their bytes twice."""

    def __init__(self, total_rows: Optional[int]):
        self.total = total_rows
        self.cols: Dict[str, dict] = {}
        self.offset = 0

    def append(self, chunk: ColumnarDataset, names: Sequence[str]) -> None:
        n = len(chunk)
        for name in names:
            col = chunk[name]
            ent = self.cols.get(name)
            if ent is None:
                ent = self.cols[name] = {
                    "ftype": col.ftype, "vmeta": col.vmeta,
                    "has_mask": col.mask is not None, "values": None,
                    "mask": None, "parts": [], "mask_parts": []}
                v = col.values
                if self.total is not None and isinstance(v, torch.Tensor):
                    ent["values"] = torch.empty(
                        (self.total,) + tuple(v.shape[1:]), dtype=v.dtype,
                        device=v.device)
                elif self.total is not None and isinstance(v, np.ndarray):
                    ent["values"] = np.empty((self.total,) + v.shape[1:],
                                             dtype=v.dtype)
                if ent["values"] is not None and ent["has_mask"]:
                    ent["mask"] = np.empty(self.total, dtype=bool)
            if ent["values"] is not None:
                ent["values"][self.offset:self.offset + n] = col.values
                if ent["has_mask"]:
                    ent["mask"][self.offset:self.offset + n] = col.mask
            else:
                ent["parts"].append(col.values)
                if ent["has_mask"]:
                    ent["mask_parts"].append(np.asarray(col.mask))
        self.offset += n

    def row_view(self, name: str, start: int,
                 stop: int) -> Optional[FeatureColumn]:
        ent = self.cols.get(name)
        if ent is None or ent["values"] is None:
            return None
        mask = ent["mask"][start:stop] if ent["has_mask"] else None
        return FeatureColumn(ent["ftype"], ent["values"][start:stop],
                             mask, ent["vmeta"])

    def finish(self) -> Dict[str, FeatureColumn]:
        out: Dict[str, FeatureColumn] = {}
        for name, ent in self.cols.items():
            values = ent["values"]
            if values is None:
                parts = ent["parts"]
                values = (_cat_predictions(parts)
                          if isinstance(parts[0], PredictionBatch)
                          else torch.cat(parts)
                          if isinstance(parts[0], torch.Tensor)
                          else np.concatenate(parts))
            mask = None
            if ent["has_mask"]:
                mask = (ent["mask"] if ent["mask"] is not None
                        else np.concatenate(ent["mask_parts"]))
            out[name] = FeatureColumn(ent["ftype"], values, mask,
                                      ent["vmeta"])
        return out


def _split_streamable(layers: List[List[PipelineStage]],
                      subs: Dict[str, Model]) -> int:
    """Index of the first layer holding an estimator that cannot stream
    (and is not warm-start substituted): from there on the DAG runs
    in-core on the packed columns."""
    for i, layer in enumerate(layers):
        for s in layer:
            if (isinstance(s, Estimator) and s.uid not in subs
                    and not s.supports_streaming_fit):
                return i
    return len(layers)


def _closure(targets: Sequence[str],
             out_stage: Dict[str, PipelineStage]) -> Set[str]:
    """Uids of the stages needed, transitively, to produce ``targets``."""
    needed: Set[str] = set()
    frontier = [out_stage[n] for n in targets if n in out_stage]
    while frontier:
        s = frontier.pop()
        if s.uid in needed:
            continue
        needed.add(s.uid)
        frontier += [out_stage[f.name] for f in s.input_features
                     if f.name in out_stage]
    return needed


def _liveness(ordered: List[PipelineStage],
              final_needed: Set[str]) -> List[Set[str]]:
    """needed_after[i]: the columns that must outlive ordered[i] (inputs
    of the later stages and the pass's targets)."""
    needed_after: List[Set[str]] = [set() for _ in ordered]
    running = set(final_needed)
    for i in range(len(ordered) - 1, -1, -1):
        needed_after[i] = set(running)
        running |= set(ordered[i].input_names)
    return needed_after


def _est_name(est) -> str:
    """An estimator's class name (the fold-tagged proxy's inner one)."""
    return type(getattr(est, "inner", est)).__name__


def fit_dag_streaming(dag, reader, raw_features, chunk_rows: int,
                      keep: Optional[Sequence[str]] = None,
                      fitted_substitutes: Optional[Dict[str, Model]] = None,
                      prefetch: int = 2, chunk_filter=None, on_stage=None,
                      checkpoint_dir: Optional[str] = None,
                      checkpoint_every: int = 16, device=None,
                      profiler: Optional[PlanProfiler] = None,
                      refresh_ctx=None,
                      fingerprint_extra: Optional[Dict] = None,
                      cv_ctx=None
                      ) -> Tuple[List[PipelineStage], ColumnarDataset,
                                 IngestProfiler, Dict[str, object]]:
    """Fit ``dag`` from ``reader``'s chunks of ``chunk_rows`` rows: (the
    fitted stages in layer order, the dataset of the ``keep`` columns and
    the tail's outputs, the ingest counters, each streamed estimator's
    final state by uid, through its ``export_fit_state``: the warm-start
    capital of a refresh).  ``chunk_filter`` (dataset -> dataset) runs on
    every raw chunk before any transform (RawFeatureFilter's map-key
    cleaning); ``on_stage(stage, seconds)`` gets each prefix stage's
    host seconds summed over the passes, and each tail stage's.
    ``checkpoint_dir`` checkpoints the fit passes every
    ``checkpoint_every`` chunks and resumes from a checkpoint found
    there (module docstring); restored models land on ``device``.

    ``refresh_ctx`` (``workflow.refresh.RefreshContext``) makes the run a
    warm-start refresh: an estimator whose restored state is still valid
    begins from it, and a geometry change invalidates the restored states
    downstream.  ``cv_ctx`` (``workflow.streaming_cv.StreamingCVContext``)
    makes it a streaming workflow-CV train: the during-DAG estimators fold
    a state a fold as well (fold ids per global row, from the labels the
    first pass collects), and between the prefix and the tail the
    context validates the candidates on the merged fold states; with a
    checkpoint, the fold-tagged layers run as passes of their own, so
    that a kill mid-fold resumes exactly.  ``fingerprint_extra`` extends
    the checkpoint fingerprint (the CV geometry, the refresh's base
    model).  A ``profiler`` (``utils.profiling.PlanProfiler``) gets the
    ingest counters and every stage's profile."""
    from .dag import StagesDAG, fit_and_transform_dag

    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    subs = dict(fitted_substitutes or {})
    layers = [layer for layer in dag.non_generator_layers() if layer]
    split = _split_streamable(layers, subs)
    prefix, tail = layers[:split], layers[split:]
    ingest = IngestProfiler(chunk_rows)
    if profiler is not None:
        profiler.ingest = ingest
    manager = resume = None
    if checkpoint_dir is not None:
        from .checkpoint import StreamingCheckpointManager, compute_fingerprint

        fingerprint = compute_fingerprint(reader, raw_features, layers,
                                          chunk_rows)
        if fingerprint_extra:
            fingerprint = {**fingerprint, **fingerprint_extra}
        manager = StreamingCheckpointManager(
            checkpoint_dir, fingerprint, every_chunks=checkpoint_every)
        resume = manager.load(device)
        ingest.resumed = resume is not None

    def note_checkpoint(t0: float) -> None:
        ingest.checkpoint_saves = manager.saves
        ingest.checkpoint_wall_s += time.perf_counter() - t0

    raw_names = {f.name for f in raw_features}
    out_stage: Dict[str, PipelineStage] = {
        s.get_output().name: s for layer in prefix for s in layer}
    known_universe = raw_names | {
        s.get_output().name for layer in layers for s in layer}
    fitted_by_uid: Dict[str, PipelineStage] = {}
    stage_wall: Dict[str, float] = {}
    stage_layer: Dict[str, int] = {
        s.uid: li for li, layer in enumerate(prefix) for s in layer}
    stage_kind: Dict[str, str] = {}
    total_rows: Optional[int] = None
    extras: Set[str] = set()   # reader columns the DAG does not know (key)
    final_states: Dict[str, object] = {}
    rcfg = getattr(reader, "resilience", None)
    sink = rcfg.sink() if (rcfg is not None and rcfg.quarantines) else None
    q0_records, q0_rows = (sink.count, sink.rows) if sink is not None \
        else (0, 0)

    def fitted_of(stage: PipelineStage) -> PipelineStage:
        if isinstance(stage, Estimator):
            return fitted_by_uid.get(stage.uid) or subs[stage.uid]
        return stage

    def timed_transform(stage: PipelineStage,
                        ds: ColumnarDataset) -> ColumnarDataset:
        t0 = time.perf_counter()
        out = fitted_of(stage).transform(ds)
        stage_wall[stage.uid] = (stage_wall.get(stage.uid, 0.0)
                                 + time.perf_counter() - t0)
        return out

    def run_reader_pass(label: str, ordered: List[PipelineStage],
                        final_needed: Set[str], per_chunk,
                        keep_unknown: bool, skip_chunks: int = 0,
                        on_chunk=None) -> int:
        """One prefetch-overlapped pass over the reader: each chunk goes
        through ``ordered`` (pruned by liveness) to ``per_chunk``; returns
        the rows.  Under a retry policy the reader's stream is wrapped in
        a ``RetryingChunkStream``.  The first ``skip_chunks`` chunks (a
        resume's folded ones) are read and counted, not transformed;
        ``on_chunk(index, rows so far)`` runs after each chunk folded.
        Under workflow CV the first pass collects the label of every raw
        chunk, the skipped ones too, and each chunk's global row window
        is set before ``per_chunk``."""
        pass_stats = ingest.begin_pass(label)
        if cv_ctx is not None:
            cv_ctx.begin_label_pass()
        needed_after = _liveness(ordered, final_needed)
        rows = 0
        t_pass = time.perf_counter()

        def open_stream():
            return reader.iter_chunks(raw_features, chunk_rows)

        if rcfg is not None and rcfg.retry is not None:
            from ..readers.resilience import RetryingChunkStream

            stream = RetryingChunkStream(open_stream, rcfg.retry,
                                         on_retry=pass_stats.note_retry)
        else:
            stream = open_stream()
        batcher = AsyncBatcher(_TimedChunks(stream, pass_stats),
                               depth=prefetch)
        try:
            for idx, chunk in enumerate(batcher):
                if cv_ctx is not None and cv_ctx.collecting_labels:
                    cv_ctx.collect_labels(chunk)
                if idx < skip_chunks:
                    rows += len(chunk)
                    pass_stats.chunks_skipped += 1
                    continue
                t0 = time.perf_counter()
                ds = chunk_filter(chunk) if chunk_filter is not None \
                    else chunk
                if idx == 0 and keep_unknown:
                    extras.update(c for c in ds.names()
                                  if c not in known_universe)
                for i, st in enumerate(ordered):
                    ds = timed_transform(st, ds)
                    ds = ds.select([c for c in ds.names()
                                    if c in needed_after[i]
                                    or (keep_unknown
                                        and c not in known_universe)])
                if cv_ctx is not None:
                    cv_ctx.set_window(rows, len(chunk))
                per_chunk(ds)
                rows += len(chunk)
                pass_stats.note_transform(idx, time.perf_counter() - t0)
                if on_chunk is not None:
                    on_chunk(idx, rows)
        finally:
            batcher.close()
        pass_stats.wall_s = time.perf_counter() - t_pass
        if rows == 0:
            raise ValueError("chunked reader produced no rows")
        if cv_ctx is not None:
            cv_ctx.finish_label_pass(rows)
        return rows

    def update_states(ests, states, ds: ColumnarDataset) -> None:
        for est in ests:
            t0 = time.perf_counter()
            states[est.uid] = est.update_chunk(
                states[est.uid], ds, *[ds[n] for n in est.input_names])
            stage_wall[est.uid] = (stage_wall.get(est.uid, 0.0)
                                   + time.perf_counter() - t0)

    def init_states(ests) -> Dict[str, object]:
        """Fresh states, or under a refresh the restored warm-start ones
        where still valid."""
        out: Dict[str, object] = {}
        for est in ests:
            state = (refresh_ctx.initial_state(est)
                     if refresh_ctx is not None else None)
            out[est.uid] = state if state is not None else est.begin_fit()
        return out

    def finish_layer(ests, states) -> None:
        for est in ests:
            t0 = time.perf_counter()
            state = states[est.uid]
            model = est.adopt_model(est.finish_fit(state))
            fitted_by_uid[est.uid] = model
            stage_wall[est.uid] = (stage_wall.get(est.uid, 0.0)
                                   + time.perf_counter() - t0)
            stage_kind[est.uid] = "fit-stream"
            # the final state, exported: the warm-start capital of a
            # refresh, saved with the model (a fold-tagged proxy's full
            # state only: fold states are one train's scaffolding)
            exporter = getattr(est, "export_full_state", None)
            final_states[est.uid] = (exporter(state) if exporter is not None
                                     else est.export_fit_state(state))
            if refresh_ctx is not None:
                refresh_ctx.note_finished(est, model)

    def layer_ests(li: int) -> List[Estimator]:
        out = [s for s in prefix[li]
               if isinstance(s, Estimator) and s.uid not in subs]
        if cv_ctx is not None:
            out = [cv_ctx.wrap(s) for s in out]
        return out

    def est_names(ests) -> str:
        return ", ".join(_est_name(e) for e in ests)

    def ensure_cv_folds(ests) -> None:
        """The folds are assigned before any fold-tagged update: from the
        labels of the first pass read, or, where the tagged layer fits on
        the first pass (or a resume restored every earlier pass without
        reading), from a pass of their own."""
        if (cv_ctx is None or cv_ctx.folds_ready
                or not cv_ctx.wraps_any(ests)):
            return
        if not cv_ctx.labels_ready:
            run_reader_pass("cv-labels", [], set(), lambda ds: None,
                            keep_unknown=False)
        cv_ctx.assign_folds()

    # -- what must materialize: the keep set and the tail's inputs ----------
    available = raw_names | set(out_stage)
    mat_cols: Set[str] = {n for layer in tail for s in layer
                          for n in s.input_names if n in available}
    mat_cols |= available if keep is None else set(keep) & available
    if cv_ctx is not None:
        # the fold validation transforms the fold rows through the during
        # DAG again: its upstream inputs and the label materialize too
        mat_cols |= cv_ctx.extra_columns & available
    est_idxs = [li for li in range(len(prefix)) if layer_ests(li)]
    all_targets: Set[str] = set(mat_cols)
    for li in est_idxs:
        for est in layer_ests(li):
            all_targets |= set(est.input_names)
    needed_uids = _closure(sorted(all_targets), out_stage)
    writer = _ColumnWriter(None)

    def materialize_only_pass() -> Dict[str, FeatureColumn]:
        """One pass over the fitted prefix writing every materialized
        column (no estimator to fit, or a checkpointed CV train whose
        estimator layers all ran as passes of their own)."""
        ordered = [s for layer in prefix for s in layer
                   if s.uid in needed_uids]
        rows = run_reader_pass(
            "materialize", ordered, set(mat_cols),
            lambda ds: writer.append(ds, [c for c in ds.names()
                                          if c in mat_cols or c in extras]),
            keep_unknown=True)
        writer.offset = rows
        return writer.finish()

    def fused_pass_and_cascade(fuse_at: int, total_rows: Optional[int]
                               ) -> Dict[str, FeatureColumn]:
        """The fused fit-and-retain reader pass at layer ``fuse_at``, then the
        block cascade over the retained chunks; returns the materialized
        columns."""
        fuse_ests = layer_ests(fuse_at)
        fuse_uids = {e.uid for e in fuse_ests}
        fuse_inputs: Set[str] = set()
        for est in fuse_ests:
            fuse_inputs |= set(est.input_names)
        # the cascade's chain: every stage from the fuse point on that an
        # unfitted estimator or a fuse output reaches
        pending = {e.uid for li in est_idxs if li >= fuse_at
                   for e in layer_ests(li)}
        down = {e.get_output().name for e in fuse_ests}
        chain_tail: List[PipelineStage] = []
        for lj in range(fuse_at, len(prefix)):
            for s in prefix[lj]:
                if s.uid in fuse_uids or s.uid not in needed_uids:
                    continue
                if s.uid in pending or any(n in down for n in s.input_names):
                    chain_tail.append(
                        cv_ctx.wrap(s) if (cv_ctx is not None
                                           and isinstance(s, Estimator))
                        else s)
                    down.add(s.get_output().name)
        consumed = set(mat_cols) | {n for s in chain_tail
                                    for n in s.input_names}
        chain = ([e for e in fuse_ests if e.get_output().name in consumed]
                 + chain_tail)
        chain_uids = {s.uid for s in chain}
        chain_outputs = {s.get_output().name for s in chain}
        block_cols = {n for s in chain for n in s.input_names} - chain_outputs
        direct_cols = set(mat_cols) - chain_outputs
        run_stages = [s for layer in prefix for s in layer
                      if s.uid in needed_uids and s.uid not in chain_uids
                      and s.uid not in fuse_uids]
        ensure_cv_folds(fuse_ests)
        states = init_states(fuse_ests)
        store = _BlockStore(_retain_budget_bytes())
        writer.total = total_rows

        def feed_and_capture(ds: ColumnarDataset) -> None:
            update_states(fuse_ests, states, ds)
            writer.append(ds, [c for c in ds.names()
                               if c in direct_cols or c in extras])
            if chain:
                store.append(ds.select([c for c in block_cols if c in ds]))

        try:
            rows = run_reader_pass(
                f"fit+materialize[layer {fuse_at}: {est_names(fuse_ests)}]",
                run_stages, fuse_inputs | direct_cols | block_cols,
                feed_and_capture, keep_unknown=True)
            writer.total = rows
            finish_layer(fuse_ests, states)
            ingest.spilled_bytes = store.spilled_bytes
            n_blocks = len(store)
            cur: object = store
            pos = 0
            while pos < len(chain):
                # a segment: the fitted stages up to the next layer of
                # unfitted estimators, which fit on this sweep of the blocks
                seg_end = pos
                seg_ests: List[Estimator] = []
                while seg_end < len(chain):
                    s = chain[seg_end]
                    if (isinstance(s, Estimator) and s.uid not in subs
                            and s.uid not in fitted_by_uid):
                        if (not seg_ests or stage_layer[s.uid]
                                == stage_layer[seg_ests[0].uid]):
                            seg_ests.append(s)
                            seg_end += 1
                            continue
                        break
                    if seg_ests:
                        break
                    seg_end += 1
                segment = [s for s in chain[pos:seg_end] if s not in seg_ests]
                remaining = chain[seg_end:]
                seg_inputs: Set[str] = set()
                for est in seg_ests:
                    seg_inputs |= set(est.input_names)
                retain_cols = ({n for s in remaining for n in s.input_names}
                               - {s.get_output().name for s in remaining})
                # an estimator's output is written by the next segment, once
                # its model exists
                seg_write = set(mat_cols) & {s.get_output().name
                                             for s in segment}
                needed_after = _liveness(segment,
                                         seg_inputs | retain_cols | seg_write)
                ensure_cv_folds(seg_ests)
                seg_states = init_states(seg_ests)
                apass = ingest.begin_pass(
                    "assemble" if not seg_ests else
                    f"fit-blocks[layer {stage_layer[seg_ests[0].uid]}: "
                    f"{est_names(seg_ests)}]")
                t_pass = time.perf_counter()
                nxt: List[Optional[ColumnarDataset]] = []
                offset = 0
                for bi in range(n_blocks):
                    if isinstance(cur, _BlockStore):
                        ds_b = cur.pop(bi)
                    else:
                        ds_b, cur[bi] = cur[bi], None
                    n_b = len(ds_b)
                    t0 = time.perf_counter()
                    for idx, st in enumerate(segment):
                        ds_b = timed_transform(st, ds_b)
                        ds_b = ds_b.select([c for c in ds_b.names()
                                            if c in needed_after[idx]])
                    if seg_ests:
                        if cv_ctx is not None:
                            cv_ctx.set_window(offset, n_b)
                        update_states(seg_ests, seg_states, ds_b)
                    writer.offset = offset
                    writer.append(ds_b, [c for c in ds_b.names()
                                         if c in seg_write])
                    if remaining or seg_ests:
                        kept: Dict[str, FeatureColumn] = {}
                        for c in retain_cols | seg_inputs:
                            if c in ds_b:
                                view = (writer.row_view(c, offset,
                                                        offset + n_b)
                                        if c in seg_write else None)
                                kept[c] = view if view is not None else ds_b[c]
                        nxt.append(ColumnarDataset(kept, _validated=True))
                    del ds_b
                    offset += n_b
                    apass.note_read(n_b, 0.0, 0)
                    apass.note_transform(bi, time.perf_counter() - t0)
                apass.wall_s = time.perf_counter() - t_pass
                cur = nxt
                if seg_ests:
                    finish_layer(seg_ests, seg_states)
                    # the just-fitted models transform in the next segment
                    pos = seg_end - len(seg_ests)
                else:
                    pos = seg_end
            writer.offset = rows
        finally:
            store.close()
        missing = (set(mat_cols) & chain_outputs) - set(writer.cols)
        if missing:
            raise RuntimeError(
                f"block cascade failed to materialize {sorted(missing)}")
        return writer.finish()

    if not est_idxs:
        # no estimator to fit: one pass writes every materialized column
        materialized = materialize_only_pass()
    else:
        # fuse at the second estimator layer when there is one (its pass
        # already computes the first layer's outputs, so the retained
        # blocks are derived, compact columns), else at the only one.  A
        # checkpointed CV train fuses past the last fold-tagged layer
        # (the fused pass is not checkpointed mid-pass, so the tagged
        # layers run as passes of their own, one more reader pass for an
        # exact mid-fold resume); with no layer after it, fuse_at is None:
        # every estimator layer a pass, then one materializing pass
        fuse_at: Optional[int] = (est_idxs[1] if len(est_idxs) >= 2
                                  else est_idxs[0])
        if cv_ctx is not None and manager is not None:
            tagged = [li for li in est_idxs
                      if cv_ctx.wraps_any(layer_ests(li))]
            if tagged:
                later = [li for li in est_idxs if li > max(tagged)]
                fuse_at = later[0] if later else None
        prefuse = [li for li in est_idxs if fuse_at is None or li < fuse_at]
        for pass_idx, li in enumerate(prefuse):
            ests = layer_ests(li)
            label = f"fit[layer {li}: {est_names(ests)}]"
            if resume is not None and pass_idx in resume.completed:
                # the pass completed before the crash: its models are
                # adopted, its data is not read again
                from .checkpoint import (CheckpointMismatchError,
                                         adopt_restored_model)

                done = resume.completed[pass_idx]
                for est in ests:
                    model = done["models"].get(est.uid)
                    if model is None:
                        raise CheckpointMismatchError(
                            f"checkpoint pass {pass_idx} is missing a "
                            f"model for estimator {est.uid}")
                    inner = getattr(est, "inner", est)
                    fitted_by_uid[est.uid] = adopt_restored_model(inner,
                                                                  model)
                    stage_kind[est.uid] = "fit-restored"
                    payload = (done.get("states") or {}).get(est.uid)
                    if payload is not None:
                        # a fold-tagged layer: its final state again, so
                        # that the CV validation has its fold states (a
                        # copy: the manager re-encodes the payload later)
                        st = est.import_fit_state(copy.deepcopy(payload))
                        tagged_est = hasattr(est, "export_full_state")
                        if cv_ctx is not None and tagged_est:
                            cv_ctx.note_fold_states(inner, st.folds)
                        final_states.setdefault(
                            est.uid, inner.export_fit_state(st.full)
                            if tagged_est else est.export_fit_state(st))
                if total_rows is None:
                    total_rows = done["rows"]
                continue
            targets: Set[str] = set()
            for est in ests:
                targets |= set(est.input_names)
            pass_uids = _closure(sorted(targets), out_stage)
            ordered = [s for lj in range(li) for s in prefix[lj]
                       if s.uid in pass_uids]
            ensure_cv_folds(ests)
            states = init_states(ests)
            skip = 0
            if (resume is not None and resume.current is not None
                    and int(resume.current["pass"]) == pass_idx):
                # the pass in flight: its states exactly, its cursor
                states = resume.states_for(ests)
                skip = int(resume.current["chunks_done"])
            on_chunk = None
            if manager is not None:
                def on_chunk(ci, rows_done, _pi=pass_idx, _lb=label,
                             _e=ests, _st=states):
                    if (ci + 1) % manager.every_chunks == 0:
                        t0 = time.perf_counter()
                        manager.save_progress(_pi, _lb, ci + 1, rows_done,
                                              _e, _st)
                        note_checkpoint(t0)
            rows = run_reader_pass(
                label, ordered, targets,
                lambda ds, e=ests, st=states: update_states(e, st, ds),
                keep_unknown=False, skip_chunks=skip, on_chunk=on_chunk)
            total_rows = rows if total_rows is None else total_rows
            finish_layer(ests, states)
            if manager is not None:
                t0 = time.perf_counter()
                manager.complete_pass(
                    pass_idx, label, rows,
                    {est.uid: fitted_by_uid[est.uid] for est in ests},
                    state_payloads={
                        est.uid: est.export_fit_state(states[est.uid])
                        for est in ests
                        if hasattr(est, "export_full_state")})
                note_checkpoint(t0)
        if fuse_at is None:
            writer.total = total_rows
            materialized = materialize_only_pass()
        else:
            materialized = fused_pass_and_cascade(fuse_at, total_rows)
        total_rows = writer.offset

    data = ColumnarDataset(materialized, _validated=True)
    # the workflow CV's validation, between the prefix and the tail: the
    # fold models from merged fold states, the sweep over the fold
    # matrices, the winner set for the tail's selector
    if cv_ctx is not None:
        cv_ctx.run_validation(data)
    fitted: List[PipelineStage] = []
    for layer in prefix:
        for s in layer:
            if isinstance(s, Estimator):
                fitted.append(fitted_by_uid.get(s.uid) or subs[s.uid])
                stage_kind.setdefault(s.uid, "substitute")
            else:
                fitted.append(s)
                stage_kind.setdefault(s.uid, "transform-stream")
    if on_stage is not None:
        for layer in prefix:
            for s in layer:
                on_stage(s, stage_wall.get(s.uid, 0.0))
    if profiler is not None:
        _profile_prefix(profiler, prefix, data, stage_wall, stage_layer,
                        stage_kind, total_rows or len(data), device)

    # -- tail: the non-streamable suffix, in-core on the packed columns ----
    if tail:
        fitted_tail, data = fit_and_transform_dag(
            StagesDAG(tail), data, on_stage=on_stage,
            fitted_substitutes=subs, profiler=profiler)
        fitted.extend(fitted_tail)
    if keep is not None:
        keep_set = set(keep)
        data = data.select([c for c in data.names()
                            if c in keep_set or c not in known_universe])
    if sink is not None:
        ingest.quarantined_records = sink.count - q0_records
        ingest.quarantined_rows = sink.rows - q0_rows
    if manager is not None:
        # a finished train's checkpoint must not resume into the next run
        manager.finish()
    return fitted, data, ingest, final_states


def _profile_prefix(profiler: PlanProfiler, prefix, data: ColumnarDataset,
                    stage_wall: Dict[str, float],
                    stage_layer: Dict[str, int], stage_kind: Dict[str, str],
                    rows: int, device) -> None:
    """A ``StageProfile`` for each streamed prefix stage: its host seconds
    over every pass, the run's rows, its inputs' width where they
    materialized."""
    backend = backend_name(device)
    for s in (st for layer in prefix for st in layer):
        op = type(s).__name__
        kind = stage_kind.get(s.uid, "transform-stream")
        width = sum(1 for _ in s.input_names) or 1
        dtype = ""
        for n in s.input_names:
            if n in data:
                v = data[n].values
                shape = getattr(v, "shape", None)
                if shape is not None and len(shape) >= 2:
                    width += int(shape[1]) - 1
                if not dtype:
                    dtype = str(getattr(v, "dtype", "") or "")
                    dtype = dtype.replace("torch.", "")
        profiler.record_stage(StageProfile(
            uid=s.uid, op=op, output=s.get_output().name,
            layer=stage_layer.get(s.uid, 0), kind=kind,
            device_heavy=s.device_heavy, wall_s=stage_wall.get(s.uid, 0.0),
            rows=rows, cols_added=1, cols=width, dtype=dtype,
            backend=backend, stage_kind=f"{op}:{kind}"))
    profiler.note_columns(len(data.columns))
