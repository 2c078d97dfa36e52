"""Fold-tagged streaming CV: workflow-level cross-validation out of core
(counterpart of ``transmogrifai_tpu.workflow.streaming_cv``).

The in-core workflow CV (``OpWorkflow.with_workflow_cv``) cuts the DAG
at the model selector and refits the label-aware "during" stages
(SanityChecker) inside every fold, which reads the training rows K
times.  An out-of-core train cannot, so it uses what the streaming-fit
protocol guarantees: a state is a mergeable monoid.  Fold ids are
assigned per global row id (``selector.validators.make_folds`` over the
splitter's train rows: the in-core validator's seeded assignment, so the
chunking does not change it); every during-DAG estimator's
``update_chunk`` also folds each fold's rows into a state of that fold,
and the fold-k model is ``finish_fit(merge(states[j] for j != k))``, the
complement's fit without another reader pass.  The fold metrics then
come from the materialized fold rows sent through the during DAG with
the fold models in place, and the candidates' fits are the in-core
sweep's.  The fold metrics match the in-core refit's within each stage's
``streaming_fit_tol``.

Fault point: ``cv.fold`` fires once a fold context as its matrices are
built (``index``: the context's ordinal).  The sweep runs through the
selector's work queue, with its checkpoint cursor and retry ladder.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..stages.base import Estimator, Model
from ..utils import faults

__all__ = ["StreamingCVContext", "FoldTaggedState", "FoldTaggedEstimator"]


class FoldTaggedState:
    """One streamed estimator's CV state: the state of all rows (the
    model the DAG adopts) and one mergeable state a fold of the
    splitter's train rows (holdout rows ride the full state only)."""

    __slots__ = ("full", "folds")

    def __init__(self, full, folds: List[Any]):
        self.full = full
        self.folds = folds


#: the checkpoint codec's marker of a fold-tagged payload
_TAG = "__fold_tagged__"


class FoldTaggedEstimator(Estimator):
    """The streaming-protocol proxy of a during-DAG estimator: each
    ``update_chunk`` folds the whole chunk into the full state (the
    order of a plain streaming train) and each fold's rows into that
    fold's state (row to fold through the context's global assignment).
    The inner estimator's export/import hooks carry every part through
    the checkpoint codec, so a kill mid-pass restores every fold state
    exactly."""

    # no super().__init__: the proxy answers for the inner stage's
    # identity (uid, wiring) rather than minting its own
    def __init__(self, inner: Estimator, ctx: "StreamingCVContext"):
        self.inner = inner
        self.ctx = ctx
        self.uid = inner.uid
        self.operation_name = inner.operation_name
        self.output_type = inner.output_type
        self.input_features = inner.input_features
        self._output_feature = inner._output_feature
        self.metadata = inner.metadata

    @property
    def supports_streaming_fit(self) -> bool:
        return bool(self.inner.supports_streaming_fit)

    @property
    def streaming_fit_tol(self) -> float:
        return float(self.inner.streaming_fit_tol)

    @property
    def device_heavy(self) -> bool:
        return self.inner.device_heavy

    @property
    def device(self):
        return getattr(self.inner, "device", None)

    def adopt_model(self, model: Model) -> Model:
        return self.inner.adopt_model(model)

    def begin_fit(self) -> FoldTaggedState:
        return FoldTaggedState(self.inner.begin_fit(),
                               [self.inner.begin_fit()
                                for _ in range(self.ctx.num_folds)])

    def update_chunk(self, state: FoldTaggedState, data, *cols
                     ) -> FoldTaggedState:
        state.full = self.inner.update_chunk(state.full, data, *cols)
        g = self.ctx.window_folds(len(data))
        for k in range(self.ctx.num_folds):
            idx = np.flatnonzero(g == k)
            if not len(idx):
                continue
            sub = data.take(idx)
            state.folds[k] = self.inner.update_chunk(
                state.folds[k], sub, *[sub[n] for n in self.inner.input_names])
        return state

    def merge_states(self, a: FoldTaggedState,
                     b: FoldTaggedState) -> FoldTaggedState:
        return FoldTaggedState(
            self.inner.merge_states(a.full, b.full),
            [self.inner.merge_states(x, y)
             for x, y in zip(a.folds, b.folds)])

    def finish_fit(self, state: FoldTaggedState) -> Model:
        # the fold states go to the context before finish_fit (which may
        # finalize a state in place)
        self.ctx.note_fold_states(self.inner, state.folds)
        return self.inner.finish_fit(state.full)

    def export_fit_state(self, state: FoldTaggedState):
        return {_TAG: True,
                "full": self.inner.export_fit_state(state.full),
                "folds": [self.inner.export_fit_state(s)
                          for s in state.folds]}

    def export_full_state(self, state: FoldTaggedState):
        """The full-data part only: what rides on the model as
        ``fit_states`` (fold states are one train's scaffolding)."""
        return self.inner.export_fit_state(state.full)

    def import_fit_state(self, payload) -> FoldTaggedState:
        if isinstance(payload, dict) and payload.get(_TAG):
            return FoldTaggedState(
                self.inner.import_fit_state(payload["full"]),
                [self.inner.import_fit_state(p) for p in payload["folds"]])
        # a plain payload (a refresh from the base model's full state):
        # the full state resumes, the fold states start from this run
        return FoldTaggedState(
            self.inner.import_fit_state(payload),
            [self.inner.begin_fit() for _ in range(self.ctx.num_folds)])


class StreamingCVContext:
    """The fold bookkeeping and the validation of one streaming
    workflow-CV train (built by ``OpWorkflow`` from the CV cut, driven by
    ``workflow.streaming.fit_dag_streaming``)."""

    def __init__(self, selector, during_dag, subs: Dict[str, Model]):
        self.selector = selector
        self.during_dag = during_dag
        self.subs = dict(subs or {})
        during = [s for layer in during_dag.layers for s in layer]
        self.during_uids: Set[str] = {
            s.uid for s in during
            if isinstance(s, Estimator) and s.uid not in self.subs}
        outputs = {s.get_output().name for s in during}
        #: the during DAG's inputs made upstream: they must materialize,
        #: so that the fold rows can be transformed again a fold
        self.extra_columns: Set[str] = {
            n for s in during for n in s.input_names} - outputs
        self.label_name = selector.input_features[0].name
        self.features_name = selector.input_features[1].name
        self.extra_columns.add(self.label_name)

        from ..selector.validators import OpTrainValidationSplit

        v = selector.validator
        self._is_split = isinstance(v, OpTrainValidationSplit)
        self.num_folds = 2 if self._is_split else int(v.num_folds)
        self._wrapped: Dict[str, FoldTaggedEstimator] = {}
        self._label_parts: List[np.ndarray] = []
        self.labels_ready = False
        self.folds_ready = False
        self.y: Optional[np.ndarray] = None
        self._global_folds: Optional[np.ndarray] = None
        self._train_idx: Optional[np.ndarray] = None
        self._folds_sub: Optional[np.ndarray] = None
        self._base_w: Optional[np.ndarray] = None
        self._win: Tuple[int, int] = (0, 0)
        self._fold_states: Dict[str, List[Any]] = {}
        self.validated = False

    def fingerprint(self) -> Dict[str, Any]:
        """The fold geometry a streaming-CV checkpoint is pinned to: a
        resume with other folds, seed or stratification is refused with
        the key-level diff (its fold states were folded under this
        assignment)."""
        v = self.selector.validator
        return {"cv": {
            "validator": type(v).__name__,
            "numFolds": None if self._is_split else int(v.num_folds),
            "trainRatio": float(v.train_ratio) if self._is_split else None,
            "seed": int(v.seed),
            "stratify": bool(getattr(v, "stratify", False)),
        }}

    # -- the labels, from the first reader pass ------------------------------

    @property
    def collecting_labels(self) -> bool:
        return not self.labels_ready

    def begin_label_pass(self) -> None:
        if not self.labels_ready:
            self._label_parts = []

    def collect_labels(self, chunk) -> None:
        if self.labels_ready or self.label_name not in chunk:
            return
        self._label_parts.append(np.nan_to_num(np.asarray(
            chunk[self.label_name].values, np.float64)))

    def finish_label_pass(self, rows: int) -> None:
        if self.labels_ready:
            return
        got = sum(len(p) for p in self._label_parts)
        if got != rows:
            raise RuntimeError(
                f"workflow CV could not collect the label column "
                f"{self.label_name!r} over the reader pass ({got} of "
                f"{rows} rows)")
        self.y = (np.concatenate(self._label_parts) if self._label_parts
                  else np.zeros(0))
        self._label_parts = []
        self.labels_ready = True

    # -- the fold of each global row -----------------------------------------

    def assign_folds(self) -> None:
        """A fold id a global row, as the in-core ``find_best_estimator``
        assigns them: the splitter reserves the holdout and weights the
        train rows, then the folds are drawn over the train rows with the
        validator's seed and stratification.  Rows outside the train rows
        get fold -1 (the full state only)."""
        if self.folds_ready:
            return
        if not self.labels_ready:
            raise RuntimeError("fold assignment before label collection")
        from ..selector.validators import make_folds

        y = self.y
        n = len(y)
        self.selector._capture_class_space(y)
        _, train_mask, _, base_w = self.selector._split(y)
        train_idx = np.flatnonzero(train_mask)
        v = self.selector.validator
        if self._is_split:
            in_train = v.split_mask(len(train_idx), y[train_idx])
            folds_sub = np.where(in_train, 1, 0).astype(np.int32)
        else:
            folds_sub = make_folds(len(train_idx), v.num_folds,
                                   y=y[train_idx], stratify=v.stratify,
                                   seed=v.seed)
        g = np.full(n, -1, dtype=np.int32)
        g[train_idx] = folds_sub
        self._base_w = base_w
        self._train_idx = train_idx
        self._folds_sub = folds_sub
        self._global_folds = g
        self.folds_ready = True

    # -- the driver's hooks --------------------------------------------------

    def wrap(self, est: Estimator) -> Estimator:
        """The fold-tagged proxy of a during-DAG estimator (one object a
        uid, whichever code path asks), else ``est``."""
        if est.uid not in self.during_uids:
            return est
        got = self._wrapped.get(est.uid)
        if got is None:
            got = self._wrapped[est.uid] = FoldTaggedEstimator(est, self)
        return got

    @staticmethod
    def wraps_any(ests: Sequence[Estimator]) -> bool:
        return any(isinstance(e, FoldTaggedEstimator) for e in ests)

    def set_window(self, start_row: int, n_rows: int) -> None:
        self._win = (int(start_row), int(n_rows))

    def window_folds(self, n: int) -> np.ndarray:
        if not self.folds_ready:
            raise RuntimeError("fold-tagged update before fold assignment")
        start, wn = self._win
        if n != wn:
            raise RuntimeError(
                f"fold window desync: chunk has {n} rows, window {wn}")
        return self._global_folds[start:start + n]

    def note_fold_states(self, inner: Estimator, folds: List[Any]) -> None:
        self._fold_states[inner.uid] = folds

    # -- the validation, between the prefix and the tail ---------------------

    def _fold_model(self, inner: Estimator,
                    train_folds: Sequence[int]) -> Model:
        """``finish_fit`` of the merged complement's fold states (deep
        copies), wired as a transform of its own.  The estimator's live
        metadata, written by the full-data finish that already ran, is
        shielded from the fold finishes, as in core, where the full fit
        lands last."""
        states = self._fold_states[inner.uid]
        parts = [copy.deepcopy(states[j]) for j in train_folds]
        merged = parts[0]
        for p in parts[1:]:
            merged = inner.merge_states(merged, p)
        saved = inner.metadata
        inner.metadata = {}
        try:
            model = inner.finish_fit(merged)
            model.uid = inner.uid
            model.operation_name = inner.operation_name
            model.input_features = list(inner.input_features)
            model._output_feature = inner._output_feature
            model.metadata = inner.metadata
        finally:
            inner.metadata = saved
        return model

    def _fold_matrices(self, data, tr_idx: np.ndarray, ev_idx: np.ndarray,
                       fold_subs: Dict[str, Model]):
        """The fold's (X_tr, y_tr, X_ev, y_ev): its rows sent through the
        during DAG with the fold models in place of its estimators."""
        from .dag import fit_and_transform_dag

        fitted, train_t = fit_and_transform_dag(
            self.during_dag, data.take(tr_idx), fitted_substitutes=fold_subs)
        eval_t = data.take(ev_idx)
        for model in fitted:
            eval_t = model.transform(eval_t)
        dev = self.selector.device

        def matrix(col):
            v = col.values
            if isinstance(v, torch.Tensor):
                return v.to(torch.float32).contiguous()
            from ..device import resolve_device

            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(v, np.float32))).to(resolve_device(dev))

        def labels(col):
            return np.nan_to_num(np.asarray(col.values, dtype=np.float32))

        return (matrix(train_t[self.features_name]),
                labels(train_t[self.label_name]),
                matrix(eval_t[self.features_name]),
                labels(eval_t[self.label_name]))

    def fold_contexts(self) -> List[Tuple[Tuple[int, ...], int]]:
        """(train folds, eval fold) a validation context: the K
        leave-one-out complements for CV, the one pair for a
        train/validation split."""
        if self._is_split:
            return [((1,), 0)]
        k = self.num_folds
        return [(tuple(j for j in range(k) if j != fold), fold)
                for fold in range(k)]

    def run_validation(self, data) -> None:
        """Build each fold's matrices from the merged fold states and run
        the selector's sweep over them; the winner is set on the selector
        so that the tail's fit takes it without validating again (the
        in-core ``find_best_estimator``'s contract)."""
        if self.validated:
            return
        self.assign_folds()
        missing = self.during_uids - set(self._fold_states)
        if missing:
            raise RuntimeError(
                f"workflow CV reached validation with unfitted during-DAG "
                f"estimators: {sorted(missing)}")
        per_fold = []
        for ci, (train_folds, eval_fold) in enumerate(self.fold_contexts()):
            faults.fire("cv.fold", index=ci)
            tr_idx = self._train_idx[np.isin(self._folds_sub, train_folds)]
            ev_idx = self._train_idx[self._folds_sub == eval_fold]
            if not len(tr_idx) or not len(ev_idx):
                continue
            w_tr = self._base_w[tr_idx]
            w_ev = self._base_w[ev_idx]
            if w_tr.sum() == 0 or w_ev.sum() == 0:
                continue
            fold_subs = dict(self.subs)
            for uid in self.during_uids:
                fold_subs[uid] = self._fold_model(self._wrapped[uid].inner,
                                                  train_folds)
            X_tr, y_tr, X_ev, y_ev = self._fold_matrices(data, tr_idx,
                                                         ev_idx, fold_subs)
            per_fold.append((X_tr, y_tr, w_tr, X_ev, y_ev, w_ev))
        if not per_fold:
            raise RuntimeError(
                "workflow CV produced no usable fold contexts (every fold "
                "had an empty or zero-weight side)")
        self.selector.find_best_estimator_prefold(
            per_fold, y=self.y, n_rows=len(self._train_idx))
        self.validated = True
