"""Cross-validation and the train/validation split for the model selector
(counterpart of ``transmogrifai_tpu.selector.validators``).

Every fold is a 0/1 weight mask over the one resident matrix; the
train/validation split is one such fold.  The sweep
is plain and sequential: first every candidate group's batched fit (one
(candidates x folds) metric matrix per group), then, one by one, each
candidate whose group declined or failed, through its estimator's
``fit_raw``.  A candidate's failure is recorded on its result and scores
it worst; the sweep goes on.

Not ported yet (ROADMAP Queue A): the schedulable work queue with its
asynchronous dispatch, checkpoints, elastic retries, the straggler
watchdog and the ``max_wait`` budget.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["ValidationResult", "OpCrossValidation", "OpTrainValidationSplit",
           "make_folds"]


@dataclasses.dataclass
class ValidationResult:
    model_name: str
    params: Dict[str, Any]
    metric_name: str
    metric_value: float
    fold_values: List[float]
    #: fit or evaluation failure; a failed candidate scores worst
    error: Optional[str] = None

    def to_json(self):
        out = {"modelType": self.model_name, "params": self.params,
               "metricName": self.metric_name,
               "metricValue": self.metric_value,
               "foldValues": self.fold_values}
        if self.error is not None:
            out["error"] = self.error
        return out


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


def _check_dispatch(parallelism, max_wait) -> None:
    if parallelism is not None:
        raise NotImplementedError(
            "parallel candidate dispatch is not ported yet: the sweep "
            "runs its fits one after another (ROADMAP Queue A)")
    if max_wait is not None:
        raise NotImplementedError(
            "the max_wait sweep budget is not ported yet "
            "(ROADMAP Queue A)")


def _validate_on(candidates, X, y, fold_ctxs, eval_fn, metric_name: str,
                 larger_better: bool):
    """The sweep over ``fold_ctxs``, (train, eval) weight pairs."""
    def run_fold(fitter, params, ctx):
        w_train, w_eval = ctx
        return eval_fn(y, fitter(X, y, w_train, params)(X), w_eval)

    return _run_sweep(candidates, fold_ctxs, run_fold,
                      lambda group: group.run(X, y, fold_ctxs),
                      metric_name, larger_better)


class OpCrossValidation:
    """k-fold cross-validation over candidate tuples ``(name, params,
    fitter, group)``: ``fitter(X, y, w_train, params)`` returns a scoring
    function, ``eval_fn(y, scores, w_eval)`` a fold metric;
    ``group.run(X, y, fold_ctxs)`` a (C, F) metric matrix or None."""

    def __init__(self, num_folds: int = 3, seed: int = 42,
                 stratify: bool = False, parallelism: Optional[int] = None,
                 max_wait: Optional[float] = None):
        _check_dispatch(parallelism, max_wait)
        self.num_folds = num_folds
        self.seed = seed
        self.stratify = stratify

    def validate(self, candidates, X, y: np.ndarray,
                 base_weights: np.ndarray, eval_fn, metric_name: str,
                 larger_better: bool = True):
        """(index of the best candidate, its ValidationResults in
        candidate order)."""
        folds = make_folds(len(y), self.num_folds, y=y,
                           stratify=self.stratify, seed=self.seed)
        fold_ctxs = []
        for k in range(self.num_folds):
            w_train = base_weights * (folds != k)
            w_eval = base_weights * (folds == k)
            if w_train.sum() == 0 or w_eval.sum() == 0:
                continue
            fold_ctxs.append((w_train, w_eval))
        return _validate_on(candidates, X, y, fold_ctxs, eval_fn,
                            metric_name, larger_better)


class OpTrainValidationSplit:
    """One train/validation split over the same candidate tuples as
    ``OpCrossValidation``: a row trains when its uniform draw falls below
    ``train_ratio``, the JAX package's numpy draw.  Its stratified split
    comes with the binary train/validation split (ROADMAP Queue A)."""

    def __init__(self, train_ratio: float = 0.75, seed: int = 42,
                 parallelism: Optional[int] = None,
                 max_wait: Optional[float] = None):
        _check_dispatch(parallelism, max_wait)
        self.train_ratio = train_ratio
        self.seed = seed

    def validate(self, candidates, X, y: np.ndarray,
                 base_weights: np.ndarray, eval_fn, metric_name: str,
                 larger_better: bool = True):
        """(index of the best candidate, its ValidationResults in
        candidate order), each with one fold value."""
        in_train = (np.random.default_rng(self.seed).random(len(y))
                    < self.train_ratio)
        return _validate_on(candidates, X, y,
                            [(base_weights * in_train,
                              base_weights * ~in_train)],
                            eval_fn, metric_name, larger_better)


def _run_sweep(candidates, fold_ctxs, run_fold, run_group,
               metric_name: str, larger_better: bool):
    """Groups first, then every candidate left without a group result,
    one at a time.  Fold metrics stay on the device until one fetch per
    group matrix and one for the sequential fits.  Each group's wall,
    synchronised with its device, lands on ``group.seconds``; a group's
    exception lands on ``group.error``, so that its members' sequential
    fits do not hide it."""
    n = len(candidates)
    vals: List[Any] = [None] * n
    errors: List[Optional[str]] = [None] * n
    groups: List[Any] = []
    for c in candidates:
        if c[3] is not None and not any(c[3] is g for g in groups):
            groups.append(c[3])
    for group in groups:
        members = [i for i, c in enumerate(candidates) if c[3] is group]
        t0 = time.perf_counter()
        group.error = None
        try:
            M = run_group(group)
        except Exception as e:  # noqa: BLE001 - the members fall back to
            # sequential fits, which isolate their own failures
            group.error = f"{type(e).__name__}: {e}"
            warnings.warn(f"grid group {type(group).__name__} failed "
                          f"({group.error}); falling back to "
                          f"sequential candidate fits", RuntimeWarning)
            M = None
        if M is None:
            continue
        if M.device.type == "cuda":
            torch.cuda.synchronize(M.device)
        group.seconds = time.perf_counter() - t0
        host = M.detach().to("cpu", torch.float64).numpy()
        for r, i in enumerate(members):
            vals[i] = [float(v) for v in host[r]]
    pending = [i for i in range(n) if vals[i] is None]
    for i in pending:
        name, params, fitter = candidates[i][:3]
        try:
            vals[i] = [run_fold(fitter, params, ctx) for ctx in fold_ctxs]
        except Exception as e:  # noqa: BLE001 - candidate isolation: the
            # failure is recorded on the candidate's result
            vals[i], errors[i] = [], f"{type(e).__name__}: {e}"
    dev_vals = [v for i in pending for v in vals[i]
                if isinstance(v, torch.Tensor)]
    if dev_vals:
        fetched = iter(torch.stack([v.to(torch.float64) for v in dev_vals])
                       .cpu().tolist())
        for i in pending:
            vals[i] = [next(fetched) if isinstance(v, torch.Tensor)
                       else float(v) for v in vals[i]]
    return _collect(candidates, vals, errors, metric_name, larger_better)


def _collect(candidates, vals, errors, metric_name: str,
             larger_better: bool):
    worst = float("-inf") if larger_better else float("inf")
    results = []
    for (name, params, *_), fold_vals, err in zip(candidates, vals, errors):
        # the mean over finite folds only: one faulted fold does not sink
        # the folds that completed
        finite = [v for v in fold_vals if np.isfinite(v)]
        if fold_vals and not finite and err is None:
            err = "all fold metrics non-finite"
        mean = float(np.mean(finite)) if finite and err is None else worst
        results.append(ValidationResult(name, params, metric_name, mean,
                                        fold_vals, error=err))
    if all(r.error is not None for r in results):
        raise RuntimeError("model selection failed: every candidate "
                           f"errored; first error: {results[0].error}")
    best = _argbest([r.metric_value if r.error is None else worst
                     for r in results], larger_better)
    return best, results


def _argbest(vals: List[float], larger_better: bool) -> int:
    arr = np.asarray(vals, np.float64)
    if not larger_better:
        arr = -arr
    arr = np.where(np.isnan(arr), -np.inf, arr)
    return int(np.argmax(arr))
