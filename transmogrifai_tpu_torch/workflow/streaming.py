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

Not ported: checkpoints and warm-start refresh (ROADMAP Queue A item
6.5), workflow CV (6.4), pods and meshes (6.7).
"""
from __future__ import annotations

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
from ..utils.profiling import IngestPass, IngestProfiler

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


def fit_dag_streaming(dag, reader, raw_features, chunk_rows: int,
                      keep: Optional[Sequence[str]] = None,
                      fitted_substitutes: Optional[Dict[str, Model]] = None,
                      prefetch: int = 2, chunk_filter=None, on_stage=None
                      ) -> Tuple[List[PipelineStage], ColumnarDataset,
                                 IngestProfiler, Dict[str, object]]:
    """Fit ``dag`` from ``reader``'s chunks of ``chunk_rows`` rows: (the
    fitted stages in layer order, the dataset of the ``keep`` columns and
    the tail's outputs, the ingest counters, each streamed estimator's
    final state by uid).  ``chunk_filter`` (dataset -> dataset) runs on
    every raw chunk before any transform (RawFeatureFilter's map-key
    cleaning); ``on_stage(stage, seconds)`` gets each prefix stage's
    host seconds summed over the passes, and each tail stage's."""
    from .dag import StagesDAG, fit_and_transform_dag

    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    subs = dict(fitted_substitutes or {})
    layers = [layer for layer in dag.non_generator_layers() if layer]
    split = _split_streamable(layers, subs)
    prefix, tail = layers[:split], layers[split:]
    ingest = IngestProfiler(chunk_rows)

    raw_names = {f.name for f in raw_features}
    out_stage: Dict[str, PipelineStage] = {
        s.get_output().name: s for layer in prefix for s in layer}
    known_universe = raw_names | {
        s.get_output().name for layer in layers for s in layer}
    fitted_by_uid: Dict[str, PipelineStage] = {}
    stage_wall: Dict[str, float] = {}
    stage_layer: Dict[str, int] = {
        s.uid: li for li, layer in enumerate(prefix) for s in layer}
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
                        keep_unknown: bool) -> int:
        """One prefetch-overlapped pass over the reader: each chunk goes
        through ``ordered`` (pruned by liveness) to ``per_chunk``; returns
        the rows.  Under a retry policy the reader's stream is wrapped in
        a ``RetryingChunkStream``."""
        pass_stats = ingest.begin_pass(label)
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
                per_chunk(ds)
                rows += len(chunk)
                pass_stats.note_transform(idx, time.perf_counter() - t0)
        finally:
            batcher.close()
        pass_stats.wall_s = time.perf_counter() - t_pass
        if rows == 0:
            raise ValueError("chunked reader produced no rows")
        return rows

    def update_states(ests, states, ds: ColumnarDataset) -> None:
        for est in ests:
            t0 = time.perf_counter()
            states[est.uid] = est.update_chunk(
                states[est.uid], ds, *[ds[n] for n in est.input_names])
            stage_wall[est.uid] = (stage_wall.get(est.uid, 0.0)
                                   + time.perf_counter() - t0)

    def finish_layer(ests, states) -> None:
        for est in ests:
            t0 = time.perf_counter()
            fitted_by_uid[est.uid] = est.adopt_model(
                est.finish_fit(states[est.uid]))
            stage_wall[est.uid] = (stage_wall.get(est.uid, 0.0)
                                   + time.perf_counter() - t0)
            final_states[est.uid] = states[est.uid]

    def layer_ests(li: int) -> List[Estimator]:
        return [s for s in prefix[li]
                if isinstance(s, Estimator) and s.uid not in subs]

    def est_names(ests) -> str:
        return ", ".join(type(e).__name__ for e in ests)

    # -- what must materialize: the keep set and the tail's inputs ----------
    available = raw_names | set(out_stage)
    mat_cols: Set[str] = {n for layer in tail for s in layer
                          for n in s.input_names if n in available}
    mat_cols |= available if keep is None else set(keep) & available
    est_idxs = [li for li in range(len(prefix)) if layer_ests(li)]
    all_targets: Set[str] = set(mat_cols)
    for li in est_idxs:
        for est in layer_ests(li):
            all_targets |= set(est.input_names)
    needed_uids = _closure(sorted(all_targets), out_stage)
    writer = _ColumnWriter(None)

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
                    chain_tail.append(s)
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
        states = {est.uid: est.begin_fit() for est in fuse_ests}
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
                seg_states = {est.uid: est.begin_fit() for est in seg_ests}
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
        ordered = [s for layer in prefix for s in layer
                   if s.uid in needed_uids]
        total_rows = run_reader_pass(
            "materialize", ordered, set(mat_cols),
            lambda ds: writer.append(ds, [c for c in ds.names()
                                          if c in mat_cols or c in extras]),
            keep_unknown=True)
        materialized = writer.finish()
    else:
        # fuse at the second estimator layer when there is one (its pass
        # already computes the first layer's outputs, so the retained
        # blocks are derived, compact columns), else at the only one
        fuse_at = est_idxs[1] if len(est_idxs) >= 2 else est_idxs[0]
        for li in [li for li in est_idxs if li < fuse_at]:
            ests = layer_ests(li)
            targets: Set[str] = set()
            for est in ests:
                targets |= set(est.input_names)
            pass_uids = _closure(sorted(targets), out_stage)
            ordered = [s for lj in range(li) for s in prefix[lj]
                       if s.uid in pass_uids]
            states = {est.uid: est.begin_fit() for est in ests}
            total_rows = run_reader_pass(
                f"fit[layer {li}: {est_names(ests)}]", ordered, targets,
                lambda ds, e=ests, st=states: update_states(e, st, ds),
                keep_unknown=False)
            finish_layer(ests, states)
        materialized = fused_pass_and_cascade(fuse_at, total_rows)
        total_rows = writer.offset

    data = ColumnarDataset(materialized, _validated=True)
    fitted: List[PipelineStage] = [
        fitted_by_uid.get(s.uid) or subs[s.uid]
        if isinstance(s, Estimator) else s
        for layer in prefix for s in layer]
    if on_stage is not None:
        for layer in prefix:
            for s in layer:
                on_stage(s, stage_wall.get(s.uid, 0.0))

    # -- tail: the non-streamable suffix, in-core on the packed columns ----
    if tail:
        fitted_tail, data = fit_and_transform_dag(
            StagesDAG(tail), data, on_stage=on_stage,
            fitted_substitutes=subs)
        fitted.extend(fitted_tail)
    if keep is not None:
        keep_set = set(keep)
        data = data.select([c for c in data.names()
                            if c in keep_set or c not in known_universe])
    if sink is not None:
        ingest.quarantined_records = sink.count - q0_records
        ingest.quarantined_rows = sink.rows - q0_rows
    return fitted, data, ingest, final_states
