"""Cross-validation and the train/validation split for the model selector
(counterpart of ``transmogrifai_tpu.selector.validators``).

Every fold is a 0/1 weight mask over the one resident matrix; the
train/validation split is one such fold.  The sweep is a work queue of
:class:`SweepUnit` (a candidate's fits over every fold), which
``SweepWorkQueue`` runs in candidate order: a run of units that share a
grid group fits as one batched block, with every member falling back to
its own sequential fit where the group declines or raises; a unit's
failure is recorded on its result and scores it worst; ``max_wait``
skips the units not yet started once the budget is spent; an
``ElasticContext`` (``parallel/elastic.py``) arms the device-loss retry
ladder and the straggler watchdog; a ``SweepCheckpointManager``
(``workflow/checkpoint.py``) restores finished units and persists each
one as the sweep advances.

Dispatch is asynchronous by default: the next block is launched before
the previous block's fold metrics are read, and every metric stays on
the device until one stacked copy at the end (non-blocking, into pinned
memory, then an event).  ``TMOG_SYNC_SWEEP=1`` (read at sweep time) runs
the synchronous loop, which waits for each group and gives the same
numbers.  ``validate_with_dag`` is workflow-level CV: the during-DAG is
refit on each fold's train rows and applied to its eval rows;
``validate_prefold`` sweeps over fold matrices built elsewhere (the
streaming workflow CV's, from merged fold states).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["ValidationResult", "OpCrossValidation", "OpTrainValidationSplit",
           "make_folds", "SweepUnit", "SweepWorkQueue"]


@dataclasses.dataclass
class ValidationResult:
    model_name: str
    params: Dict[str, Any]
    metric_name: str
    metric_value: float
    fold_values: List[float]
    #: fit or evaluation failure, budget skip or quarantine; a failed
    #: candidate scores worst
    error: Optional[str] = None

    def to_json(self):
        out = {"modelType": self.model_name, "params": self.params,
               "metricName": self.metric_name,
               "metricValue": self.metric_value,
               "foldValues": self.fold_values}
        if self.error is not None:
            out["error"] = self.error
        return out

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ValidationResult":
        """Inverse of ``to_json`` (a checkpoint's halving rung state)."""
        return ValidationResult(
            model_name=str(d.get("modelType", "")),
            params=dict(d.get("params", {})),
            metric_name=str(d.get("metricName", "")),
            metric_value=float(d.get("metricValue", float("-inf"))),
            fold_values=list(d.get("foldValues", [])),
            error=d.get("error"))


def make_folds(n: int, num_folds: int, y: Optional[np.ndarray] = None,
               stratify: bool = False, seed: int = 42) -> np.ndarray:
    """Fold id per row; stratified assignment keeps label ratios per
    fold (the JAX package's numpy draws, so the ids are bit-identical)."""
    rng = np.random.default_rng(seed)
    fold = np.zeros(n, dtype=np.int32)
    if stratify and y is not None:
        for lbl in np.unique(y):
            idx = np.where(y == lbl)[0]
            perm = rng.permutation(len(idx))
            fold[idx[perm]] = np.arange(len(idx)) % num_folds
    else:
        perm = rng.permutation(n)
        fold[perm] = np.arange(n) % num_folds
    return fold


class _ValidatorBase:
    """Candidates are tuples ``(name, params, fitter, group[,
    fit_params])``: ``fitter(X, y, w_train, params)`` returns a scoring
    function, ``eval_fn(y, scores, w_eval)`` a fold metric (a device
    scalar or a float), ``group.run(X, y, fold_ctxs)`` a (C, F) metric
    matrix or None."""

    #: ``validate(..., defer=True)`` returns the raw deferred results
    #: (the halving scheduler's on-device promotion)
    supports_defer: bool = True

    def __init__(self, seed: int, stratify: bool, parallelism: int,
                 max_wait: Optional[float]):
        self.seed = seed
        self.stratify = stratify
        #: recorded, as in the JAX package: the sweep's units run one
        #: after another on the card, their launches queued back to back
        self.parallelism = parallelism
        #: the sweep's wall-clock budget in seconds (None: unbounded)
        self.max_wait = max_wait

    def _sweep(self, candidates, X, y, fold_ctxs, eval_fn, metric_name,
               larger_better, checkpoint=None, elastic=None, defer=False):
        def run_fold(fitter, params, ctx):
            w_train, w_eval = ctx
            return eval_fn(y, fitter(X, y, w_train, params)(X), w_eval)

        return _run_sweep(candidates, fold_ctxs, run_fold, metric_name,
                          larger_better, self.max_wait,
                          run_group=lambda group: group.run(X, y, fold_ctxs),
                          checkpoint=checkpoint, elastic=elastic, defer=defer)

    def validate_prefold(self, candidates, per_fold, eval_fn,
                         metric_name: str, larger_better: bool = True,
                         checkpoint=None, elastic=None, defer: bool = False):
        """Validate over prebuilt fold matrices, each context
        ``(X_tr, y_tr, w_tr, X_ev, y_ev, w_ev)``: the workflow CV's sweep
        (in core, from the during-DAG refit a fold; streamed, from merged
        fold states, ``workflow/streaming_cv.py``), through the same work
        queue as ``validate`` (its checkpoint cursor and retry ladder)."""
        def run_fold(fitter, params, ctx):
            X_tr, y_tr, w_tr, X_ev, y_ev, w_ev = ctx
            return eval_fn(y_ev, fitter(X_tr, y_tr, w_tr, params)(X_ev),
                           w_ev)

        return _run_sweep(candidates, list(per_fold), run_fold, metric_name,
                          larger_better, self.max_wait,
                          checkpoint=checkpoint, elastic=elastic,
                          defer=defer)

    @staticmethod
    def _fold_matrices(data, during_dag, label_name: str,
                       features_name: str, tr_idx: np.ndarray,
                       ev_idx: np.ndarray, device):
        """Refit ``during_dag`` on the fold's train rows, apply the fitted
        stages to its eval rows, and read both sides' (X, y)."""
        from ..workflow.dag import fit_and_transform_dag

        fitted, train_t = fit_and_transform_dag(during_dag,
                                                data.take(tr_idx))
        eval_t = data.take(ev_idx)
        for model in fitted:
            eval_t = model.transform(eval_t)

        def matrix(col):
            v = col.values
            if isinstance(v, torch.Tensor):
                return v.to(torch.float32).contiguous()
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(v, np.float32))).to(device)

        def labels(col):
            return np.nan_to_num(np.asarray(col.values, dtype=np.float32))

        return (matrix(train_t[features_name]), labels(train_t[label_name]),
                matrix(eval_t[features_name]), labels(eval_t[label_name]))


class OpCrossValidation(_ValidatorBase):
    """k-fold cross-validation."""

    def __init__(self, num_folds: int = 3, seed: int = 42,
                 stratify: bool = False, parallelism: int = 8,
                 max_wait: Optional[float] = None):
        super().__init__(seed, stratify, parallelism, max_wait)
        self.num_folds = num_folds

    def validate(self, candidates, X, y: np.ndarray,
                 base_weights: np.ndarray, eval_fn, metric_name: str,
                 larger_better: bool = True, checkpoint=None, elastic=None,
                 defer: bool = False):
        """(index of the best candidate, its ValidationResults in
        candidate order); with ``defer`` the raw deferred results
        ``(queue, all_vals, errors)``."""
        folds = make_folds(len(y), self.num_folds, y=y,
                           stratify=self.stratify, seed=self.seed)
        fold_ctxs = []
        for k in range(self.num_folds):
            w_train = base_weights * (folds != k)
            w_eval = base_weights * (folds == k)
            if w_train.sum() == 0 or w_eval.sum() == 0:
                continue
            fold_ctxs.append((w_train, w_eval))
        return self._sweep(candidates, X, y, fold_ctxs, eval_fn, metric_name,
                           larger_better, checkpoint, elastic, defer)

    def validate_with_dag(self, candidates, data, during_dag,
                          label_name: str, features_name: str,
                          y: np.ndarray, base_weights: np.ndarray, eval_fn,
                          metric_name: str, larger_better: bool = True,
                          device=None):
        """Workflow-level CV: one refit of ``during_dag`` a fold, shared
        by every candidate, so that label-aware stages (SanityChecker)
        never see the fold's eval labels."""
        folds = make_folds(len(y), self.num_folds, y=y,
                           stratify=self.stratify, seed=self.seed)
        per_fold = []
        for k in range(self.num_folds):
            tr_idx = np.where(folds != k)[0]
            ev_idx = np.where(folds == k)[0]
            if not len(tr_idx) or not len(ev_idx):
                continue
            X_tr, y_tr, X_ev, y_ev = self._fold_matrices(
                data, during_dag, label_name, features_name, tr_idx, ev_idx,
                device)
            w_tr, w_ev = base_weights[tr_idx], base_weights[ev_idx]
            if w_tr.sum() == 0 or w_ev.sum() == 0:
                continue
            per_fold.append((X_tr, y_tr, w_tr, X_ev, y_ev, w_ev))
        return self.validate_prefold(candidates, per_fold, eval_fn,
                                     metric_name, larger_better)


class OpTrainValidationSplit(_ValidatorBase):
    """One train/validation split over the same candidate tuples as
    ``OpCrossValidation``: a row trains when its uniform draw falls below
    ``train_ratio``; stratified (``stratify``), each label's rows are
    permuted and the first round(count x ``train_ratio``) of them (at
    least one) train, so both sides keep the label ratios.  Both are the
    JAX package's numpy draws, row for row."""

    def __init__(self, train_ratio: float = 0.75, seed: int = 42,
                 stratify: bool = False, parallelism: int = 8,
                 max_wait: Optional[float] = None):
        super().__init__(seed, stratify, parallelism, max_wait)
        self.train_ratio = train_ratio

    def split_mask(self, n: int, y: np.ndarray) -> np.ndarray:
        """(n,) bool: the rows that train."""
        rng = np.random.default_rng(self.seed)
        if not self.stratify:
            return rng.random(n) < self.train_ratio
        in_train = np.zeros(n, bool)
        for cls in np.unique(y[np.isfinite(y)]):
            idx = np.where(y == cls)[0]
            perm = rng.permutation(idx)
            in_train[perm[:max(1, int(round(
                len(idx) * self.train_ratio)))]] = True
        return in_train

    def validate(self, candidates, X, y: np.ndarray,
                 base_weights: np.ndarray, eval_fn, metric_name: str,
                 larger_better: bool = True, checkpoint=None, elastic=None,
                 defer: bool = False):
        """(index of the best candidate, its ValidationResults in
        candidate order), each with one fold value."""
        in_train = self.split_mask(len(y), y)
        return self._sweep(candidates, X, y,
                           [(base_weights * in_train,
                             base_weights * ~in_train)],
                           eval_fn, metric_name, larger_better, checkpoint,
                           elastic, defer)

    def validate_with_dag(self, candidates, data, during_dag,
                          label_name: str, features_name: str,
                          y: np.ndarray, base_weights: np.ndarray, eval_fn,
                          metric_name: str, larger_better: bool = True,
                          device=None):
        in_train = self.split_mask(len(y), y)
        tr_idx, ev_idx = np.where(in_train)[0], np.where(~in_train)[0]
        X_tr, y_tr, X_ev, y_ev = self._fold_matrices(
            data, during_dag, label_name, features_name, tr_idx, ev_idx,
            device)
        return self.validate_prefold(
            candidates, [(X_tr, y_tr, base_weights[tr_idx], X_ev, y_ev,
                          base_weights[ev_idx])],
            eval_fn, metric_name, larger_better)


@dataclasses.dataclass
class SweepUnit:
    """One schedulable unit of sweep work: a candidate's fits over every
    fold.  ``fit_params`` runs the unit with other params than the
    candidate's identity (a halving rung's scaled rounds); results always
    report ``params``."""

    index: int                   # position in the original candidate list
    name: str
    params: Dict[str, Any]
    fitter: Any
    group: Any = None            # shared GridGroup for a batched fit
    fit_params: Optional[Dict[str, Any]] = None

    @property
    def run_params(self) -> Dict[str, Any]:
        return self.fit_params if self.fit_params is not None else self.params


class _GroupRow:
    """A deferred row of a grid group's (C, F) metric matrix."""

    __slots__ = ("matrix", "row")

    def __init__(self, matrix, row: int):
        self.matrix = matrix
        self.row = row


class SweepWorkQueue:
    """The selector sweep as a schedulable work queue: schedulers (the
    full sweep's ``run_all``, the halving rungs through fresh queues)
    decide which units run; unit execution, failure isolation, the
    ``max_wait`` budget, group batching and the elastic ladders live
    here.  A group's wall lands on ``group.seconds`` (on the card in the
    asynchronous loop: the span between two events recorded around its
    launches) and its exception on ``group.error``, so that its members'
    sequential fits do not hide it."""

    def __init__(self, candidates, fold_ctxs, run_fold, run_group=None):
        self.units = [
            SweepUnit(i, c[0], c[1], c[2],
                      group=(c[3] if len(c) >= 4 else None),
                      fit_params=(c[4] if len(c) >= 5 else None))
            for i, c in enumerate(tuple(c) for c in candidates)]
        self.fold_ctxs = fold_ctxs
        self._run_fold = run_fold
        self._run_group = run_group
        #: (group, start event, end event) of the asynchronous loop's
        #: groups, read after the final copy
        self._group_events: List[Tuple[Any, Any, Any]] = []

    # -- unit execution ------------------------------------------------------

    def _unit_attempt(self, unit: SweepUnit) -> List[Any]:
        """One attempt of a unit's fits.  The ``unit.slow`` and
        ``device.loss`` fault points fire here, once an attempt, keyed by
        the unit's queue index."""
        from ..utils import faults

        faults.fire("unit.slow", index=unit.index, tag=unit.name)
        faults.fire("device.loss", index=unit.index, tag=unit.name)
        return [self._run_fold(unit.fitter, unit.run_params, ctx)
                for ctx in self.fold_ctxs]

    def run_unit(self, unit: SweepUnit,
                 elastic=None) -> Tuple[List[Any], Optional[str]]:
        """One candidate across every fold, failure-isolated.  With an
        ``ElasticContext``: a classified device loss re-runs the unit on
        the same card within the retry budget, then quarantines it as
        ``failed: device_loss``; the straggler watchdog bounds each
        attempt at the context's deadline (timeout -> degraded re-run at
        twice the deadline -> ``failed: straggler``).  A workload failure
        scores worst with its error."""
        loss_attempt = 0
        slow_attempt = 0
        while True:
            try:
                deadline = (elastic.unit_deadline_s
                            if elastic is not None else None)
                if deadline is None:
                    return self._unit_attempt(unit), None
                from ..parallel.elastic import run_with_deadline

                fold_vals, timed_out = run_with_deadline(
                    lambda: self._unit_attempt(unit),
                    deadline * (2 ** slow_attempt),
                    abandoned=elastic.abandoned)
                if not timed_out:
                    return fold_vals, None
                if elastic.on_watchdog_timeout(unit.index, slow_attempt):
                    slow_attempt += 1
                    continue
                return [], (f"failed: straggler (unit exceeded its "
                            f"{deadline:.3f}s watchdog deadline "
                            f"{slow_attempt + 1}x)")
            except Exception as e:  # noqa: BLE001 - candidate isolation,
                # routed through the shared device-loss classifier
                if elastic is not None and elastic.classify(e):
                    if elastic.on_device_loss(unit.index, e, loss_attempt):
                        loss_attempt += 1
                        continue
                    return [], (f"failed: device_loss "
                                f"({type(e).__name__}: {e})")
                return [], f"{type(e).__name__}: {e}"

    def group_span(self, i: int) -> int:
        """End (exclusive) of the run of units sharing units[i]'s group."""
        group = self.units[i].group
        j = i
        while j < len(self.units) and self.units[j].group is group:
            j += 1
        return j

    def group_start(self, i: int) -> int:
        """Start of the run of units sharing units[i]'s group: a resume
        can enter a group mid-run, and the group's matrix rows count from
        its first unit."""
        group = self.units[i].group
        j = i
        while j > 0 and self.units[j - 1].group is group:
            j -= 1
        return j

    def run_group_block(self, i: int, j: int, elastic=None,
                        sync: bool = True):
        """The batched fit of units[i:j] (one shared group): its (C, F)
        metric matrix, or None where the group declines or raises (the
        units then fit one by one).  A device loss in it counts on the
        elastic context."""
        from ..utils import faults

        group = self.units[i].group
        group.error = None
        t0 = time.perf_counter()
        start = _cuda_event()
        try:
            # the unit fault points fire for every member, so that a plan
            # written against unit indices holds when they batch
            for k in range(i, j):
                faults.fire("device.loss", index=self.units[k].index,
                            tag=self.units[k].name)
            M = self._run_group(group)
        except Exception as e:  # noqa: BLE001 - fall back per candidate,
            # routed through the shared device-loss classifier
            if elastic is not None and elastic.classify(e):
                elastic.on_group_device_loss(e)
            group.error = f"{type(e).__name__}: {e}"
            warnings.warn(f"grid group {type(group).__name__} failed "
                          f"({group.error}); falling back to "
                          f"sequential candidate fits", RuntimeWarning)
            return None
        if M is None:
            return None
        if sync or M.device.type != "cuda" or start is None:
            if M.device.type == "cuda":
                torch.cuda.synchronize(M.device)
            group.seconds = time.perf_counter() - t0
        else:
            self._group_events.append((group, start, _cuda_event()))
        return M

    def strip_groups(self, i: int, j: int) -> None:
        for k in range(i, j):
            self.units[k].group = None

    # -- the default scheduler: every unit in order --------------------------

    def run_all(self, metric_name: str, larger_better: bool,
                max_wait: Optional[float], checkpoint=None, elastic=None,
                defer: bool = False):
        """Every unit in candidate order, the asynchronous loop unless
        ``TMOG_SYNC_SWEEP=1``.  ``checkpoint`` restores units already
        durable and records each finished one; ``elastic`` arms the
        ladders; ``defer=True`` (asynchronous only) returns the raw
        ``(all_vals, errors)`` with device values still on the device.
        Raises only when every candidate failed."""
        from .async_dispatch import sync_sweep_forced

        if elastic is not None:
            elastic.checkpoint = checkpoint
        if sync_sweep_forced() and not defer:
            return self._run_all_inner(metric_name, larger_better, max_wait,
                                       checkpoint, elastic)
        return self._run_all_async(metric_name, larger_better, max_wait,
                                   checkpoint, elastic, defer=defer)

    def _restored(self, checkpoint, unit):
        """A checkpoint's record of ``unit`` that fits this sweep's fold
        count (an error record always does), else None."""
        if checkpoint is None:
            return None
        rec = checkpoint.restore(unit.index)
        if rec is not None and (rec[1] is not None
                                or len(rec[0]) == len(self.fold_ctxs)):
            return rec
        return None

    @staticmethod
    def _budget_note(max_wait, t0: float, started: bool) -> Optional[str]:
        elapsed = time.monotonic() - t0
        if max_wait is not None and elapsed > max_wait and started:
            return (f"skipped: validation budget max_wait={max_wait}s "
                    f"exceeded after {elapsed:.1f}s")
        return None

    def _run_all_inner(self, metric_name: str, larger_better: bool,
                       max_wait: Optional[float], checkpoint=None,
                       elastic=None):
        """The synchronous loop: each group waited for as it finishes;
        with a checkpoint every unit's metrics copied and recorded as it
        finishes."""
        t0 = time.monotonic()
        all_vals: List[Any] = []
        errors: List[Optional[str]] = []
        i = 0
        while i < len(self.units):
            unit = self.units[i]
            rec = self._restored(checkpoint, unit)
            if rec is not None:
                all_vals.append(rec[0])
                errors.append(rec[1])
                i += 1
                continue
            note = self._budget_note(max_wait, t0, bool(all_vals))
            if note is not None:
                all_vals.append([])
                errors.append(note)
                i += 1
                continue
            if unit.group is not None and self._run_group is not None:
                j = self.group_span(i)
                if elastic is not None and elastic.groups_invalid:
                    self.strip_groups(i, j)
                    continue
                base = i - self.group_start(i)
                M = self.run_group_block(i, j, elastic=elastic, sync=True)
                if M is None:
                    self.strip_groups(i, j)
                    continue
                rows = [_GroupRow(M, base + r) for r in range(j - i)]
                if checkpoint is not None:
                    rows = _materialize(rows)
                    for r, vals in enumerate(rows):
                        checkpoint.record_unit(self.units[i + r].index,
                                               vals, None)
                all_vals.extend(rows)
                errors.extend([None] * (j - i))
                i = j
                continue
            fold_vals, err = self.run_unit(unit, elastic=elastic)
            if checkpoint is not None:
                fold_vals = _materialize([fold_vals])[0]
                checkpoint.record_unit(unit.index, fold_vals, err)
            all_vals.append(fold_vals)
            errors.append(err)
            i += 1
        if elastic is not None:
            elastic.drain()
        return self.collect(all_vals, errors, metric_name, larger_better)

    def _run_all_async(self, metric_name: str, larger_better: bool,
                       max_wait: Optional[float], checkpoint=None,
                       elastic=None, defer: bool = False):
        """The double-buffered loop: the units' semantics of
        ``_run_all_inner`` without a device wait inside it.  A
        checkpointed sweep copies and records the previous block only
        after the next one is launched; the last block's copy is the
        durability point.  Without a checkpoint, one stacked copy at the
        end reads every metric."""
        t0 = time.monotonic()
        all_vals: List[Any] = []
        errors: List[Optional[str]] = []
        #: positions launched but not yet durable (at most one block)
        pending: List[int] = []

        def flush_pending() -> None:
            if checkpoint is None or not pending:
                return
            rows = _materialize([all_vals[p] for p in pending])
            for p, vals in zip(pending, rows):
                all_vals[p] = vals
                checkpoint.record_unit(self.units[p].index, vals, errors[p])
            pending.clear()

        i = 0
        while i < len(self.units):
            unit = self.units[i]
            rec = self._restored(checkpoint, unit)
            if rec is not None:
                all_vals.append(rec[0])
                errors.append(rec[1])
                i += 1
                continue
            note = self._budget_note(max_wait, t0, bool(all_vals))
            if note is not None:
                all_vals.append([])
                errors.append(note)
                i += 1
                continue
            if unit.group is not None and self._run_group is not None:
                j = self.group_span(i)
                if elastic is not None and elastic.groups_invalid:
                    self.strip_groups(i, j)
                    continue
                base = i - self.group_start(i)
                M = self.run_group_block(i, j, elastic=elastic, sync=False)
                if M is None:
                    self.strip_groups(i, j)
                    continue
                block = list(range(len(all_vals), len(all_vals) + j - i))
                all_vals.extend(_GroupRow(M, base + r) for r in range(j - i))
                errors.extend([None] * (j - i))
                # this block is launched: the previous one's copy waits
                # behind it, then this block is the lagged window
                flush_pending()
                pending.extend(block)
                i = j
                continue
            fold_vals, err = self.run_unit(unit, elastic=elastic)
            all_vals.append(fold_vals)
            errors.append(err)
            flush_pending()
            pending.append(len(all_vals) - 1)
            i += 1
        flush_pending()
        if elastic is not None:
            elastic.drain()
        if defer:
            return all_vals, errors
        return self.collect(all_vals, errors, metric_name, larger_better,
                            one_copy=True)

    # -- result assembly -----------------------------------------------------

    def collect(self, all_vals, errors, metric_name: str,
                larger_better: bool, one_copy: bool = False
                ) -> Tuple[int, List[ValidationResult]]:
        """The results in candidate order and the best index; the mean
        is over each unit's finite folds (one faulted fold does not sink
        the folds that completed)."""
        worst = float("-inf") if larger_better else float("inf")
        host_vals = _materialize(all_vals, one_copy=one_copy)
        self.resolve_group_seconds()
        results: List[ValidationResult] = []
        for unit, fold_vals, err in zip(self.units, host_vals, errors):
            finite = [v for v in fold_vals if np.isfinite(v)]
            if fold_vals and not finite and err is None:
                err = "all fold metrics non-finite"
            mean = float(np.mean(finite)) if finite and err is None else worst
            results.append(ValidationResult(unit.name, unit.params,
                                            metric_name, mean,
                                            fold_vals, error=err))
        if all(r.error is not None for r in results):
            raise RuntimeError(
                "model selection failed: every candidate errored; "
                f"first error: {results[0].error}")
        best = _argbest([r.metric_value if r.error is None else worst
                         for r in results], larger_better)
        return best, results

    def resolve_group_seconds(self) -> None:
        """Each asynchronously launched group's seconds on the card, read
        from its events (they have completed once its metrics are
        copied)."""
        for group, start, end in self._group_events:
            end.synchronize()
            group.seconds = start.elapsed_time(end) / 1e3
        self._group_events.clear()


def _cuda_event():
    """An event recorded on the current CUDA stream, or None where CUDA
    is not in use."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _run_sweep(candidates, fold_ctxs, run_fold, metric_name: str,
               larger_better: bool, max_wait: Optional[float],
               run_group=None, checkpoint=None, elastic=None,
               defer: bool = False):
    """The full sweep over the work queue.  ``defer=True`` returns
    ``(queue, all_vals, errors)`` with device values deferred."""
    queue = SweepWorkQueue(candidates, fold_ctxs, run_fold,
                           run_group=run_group)
    out = queue.run_all(metric_name, larger_better, max_wait,
                        checkpoint=checkpoint, elastic=elastic, defer=defer)
    if defer:
        all_vals, errors = out
        return queue, all_vals, errors
    return out


def _argbest(vals: List[float], larger_better: bool) -> int:
    arr = np.asarray(vals, np.float64)
    if not larger_better:
        arr = -arr
    arr = np.where(np.isnan(arr), -np.inf, arr)
    return int(np.argmax(arr))


def _host_float64(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def _one_copy(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Every tensor in one float64 copy to the host: one stacked tensor,
    copied without blocking into pinned memory, then an event waited
    for."""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in tensors])
    if flat.device.type == "cuda":
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    else:
        host = flat
    out, off = [], 0
    arr = host.numpy()
    for t in tensors:
        out.append(arr[off:off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    return out


def _materialize(nested: List[Any], one_copy: bool = False
                 ) -> List[List[float]]:
    """Every fold metric as host floats.  A group row resolves from its
    matrix and the scalars of sequential fits from one stacked copy;
    ``one_copy`` copies the matrices and the scalars together in one.  A
    copy that raises (an asynchronous fault in the work behind it) falls
    back to one copy a value, NaN where a value cannot be read."""
    mats = []
    for v in nested:
        if isinstance(v, _GroupRow) and not any(m is v.matrix for m in mats):
            mats.append(v.matrix)
    scalars = [x for vals in nested if not isinstance(vals, _GroupRow)
               for x in vals if isinstance(x, torch.Tensor)]
    tensors = list(mats)
    if scalars:
        tensors.append(torch.stack([s.reshape(()).to(torch.float64)
                                    for s in scalars]))
    try:
        parts = (_one_copy(tensors) if one_copy and tensors
                 else [_host_float64(t) for t in tensors])
    except Exception as e:  # noqa: BLE001 - isolate the faulted values
        warnings.warn(f"metric copy failed ({type(e).__name__}: "
                      f"{str(e)[:300]}); reading value by value",
                      RuntimeWarning)
        return _materialize_each(nested)
    host_mats = parts[:len(mats)]
    host_scalars = parts[len(mats)] if scalars else []
    by_id = {id(m): h for m, h in zip(mats, host_mats)}
    it = iter(np.asarray(host_scalars).reshape(-1).tolist())
    out = []
    for vals in nested:
        if isinstance(vals, _GroupRow):
            out.append([float(x) for x in by_id[id(vals.matrix)][vals.row]])
        else:
            out.append([float(next(it)) if isinstance(x, torch.Tensor)
                        else float(x) for x in vals])
    return out


def _materialize_each(nested: List[Any]) -> List[List[float]]:
    def scalar(x) -> float:
        if not isinstance(x, torch.Tensor):
            return float(x)
        try:
            return float(x.double().cpu())
        except Exception:  # noqa: BLE001 - NaN marks the faulted value
            return float("nan")

    out = []
    for vals in nested:
        if isinstance(vals, _GroupRow):
            try:
                out.append([float(x) for x in
                            _host_float64(vals.matrix[vals.row])])
            except Exception:  # noqa: BLE001 - NaN marks the faulted row
                out.append([float("nan")] * int(vals.matrix.shape[1]))
        else:
            out.append([scalar(x) for x in vals])
    return out
