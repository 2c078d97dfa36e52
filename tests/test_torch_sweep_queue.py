"""The port's sweep work queue (``selector/validators.py``) against the
JAX package's, on the CPU.

* Units, isolation and the fit-params override through the queue's API
  (the JAX package's ``TestSweepQueueParity`` cases, in both packages).
* ``max_wait`` skips the same candidates in both packages, made
  deterministic by a ``unit.slow`` fault on the first unit.
* ``parallelism=8`` (the JAX factories' default) is accepted.
* The asynchronous loop (default) gives the synchronous loop's
  (``TMOG_SYNC_SWEEP=1``) winner and fold metrics bitwise, and the
  synchronous loop gives the pre-queue sweep's (groups first, then each
  candidate left without a group result; kept below as the reference)
  bitwise.
"""
import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
from transmogrifai_tpu.selector.model_selector import ModelSelector as JMS
from transmogrifai_tpu.selector.model_selector import grid as jgrid
from transmogrifai_tpu.selector.validators import OpCrossValidation as JCV
from transmogrifai_tpu.selector.validators import SweepUnit as JUnit
from transmogrifai_tpu.selector.validators import SweepWorkQueue as JQueue
from transmogrifai_tpu.utils import faults as jfaults
from transmogrifai_tpu_torch.models.classification import \
    OpLogisticRegression
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.selector import validators as tv
from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, ModelSelector, grid)
from transmogrifai_tpu_torch.selector.validators import (OpCrossValidation,
                                                         SweepUnit,
                                                         SweepWorkQueue)
from transmogrifai_tpu_torch.utils import faults as tfaults


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_port_faults():
    tfaults.install_faults(None)
    yield
    tfaults.install_faults(None)


def _data(n=600, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    logits = X[:, 0] * 2.0 - X[:, 1] + 0.3 * X[:, 2]
    y = (logits + rng.normal(scale=0.7, size=n) > 0).astype(np.float32)
    return X, y


@pytest.mark.parametrize("port", [False, True])
def test_queue_units_and_isolation(port):
    Queue = SweepWorkQueue if port else JQueue

    def ok_fitter(X, y, w, p):
        return lambda Xe: Xe[:, 0]

    def boom_fitter(X, y, w, p):
        raise FloatingPointError("boom")

    X = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)

    def run_fold(fitter, params, ctx):
        return float(np.mean(fitter(X, y, None, params)(X) * y))

    q = Queue([("a", {"i": 0}, ok_fitter), ("b", {"i": 1}, boom_fitter)],
              fold_ctxs=[None, None], run_fold=run_fold)
    assert [u.index for u in q.units] == [0, 1]
    vals, err = q.run_unit(q.units[0])
    assert err is None and len(vals) == 2
    vals, err = q.run_unit(q.units[1])
    assert vals == [] and err == "FloatingPointError: boom"
    best, results = q.run_all("m", True, None)
    assert best == 0
    assert results[1].error == "FloatingPointError: boom"
    assert results[1].metric_value == float("-inf")


@pytest.mark.parametrize("port", [False, True])
def test_fit_params_override_reported_params(port):
    Unit, Queue = (SweepUnit, SweepWorkQueue) if port else (JUnit, JQueue)
    seen = []

    def fitter(X, y, w, p):
        seen.append(dict(p))
        return lambda Xe: Xe[:, 0]

    unit = Unit(0, "a", {"max_iter": 50}, fitter,
                fit_params={"max_iter": 5})
    assert unit.run_params == {"max_iter": 5}
    q = Queue([("a", {"max_iter": 50}, fitter, None, {"max_iter": 5})],
              fold_ctxs=[None],
              run_fold=lambda f, p, c: (f(None, None, None, p), 1.0)[1])
    _, results = q.run_all("m", True, None)
    assert seen == [{"max_iter": 5}]
    assert results[0].params == {"max_iter": 50}


@pytest.mark.parametrize("sync", ["1", ""])
def test_max_wait_skips_the_same_candidates(monkeypatch, sync):
    """A 1 s ``unit.slow`` on the first unit spends a 0.3 s budget: the
    first candidate runs, the other three are skipped, in both packages
    and both loops."""
    monkeypatch.setenv("TMOG_SYNC_SWEEP", sync)
    X, y = _data(n=200)
    out = {}
    for port in (False, True):
        ms, lr, cv, g, fl = ((ModelSelector, OpLogisticRegression,
                              OpCrossValidation, grid, tfaults) if port
                             else (JMS, JLR, JCV, jgrid, jfaults))
        sel = ms([(lr(), g(reg_param=[0.01, 0.1, 0.3, 1.0]))],
                 problem_type="binary",
                 validator=cv(num_folds=2, stratify=True, max_wait=0.3))
        with fl.inject(fl.FaultSpec(point="unit.slow", action="slow", at=0,
                                    times=1, delay_s=1.0)):
            best, results = sel.validator.validate(
                sel._candidates(with_groups=False),
                torch.from_numpy(X) if port else X, y,
                np.ones(len(y), np.float32), eval_fn=sel._metric,
                metric_name="AuPR")
        out[port] = (best, [(r.error or "")[:45] for r in results])
        assert results[0].error is None
        assert all(r.metric_value == float("-inf") for r in results[1:])
    assert out[True] == out[False]
    assert out[True][1][1:] == ["skipped: validation budget max_wait=0.3s "
                                "exce"] * 3


def test_parallelism_is_accepted_and_recorded():
    sel = BinaryClassificationModelSelector.with_cross_validation(
        parallelism=8, max_wait=30.0)
    assert sel.validator.parallelism == 8 and sel.validator.max_wait == 30.0
    tvs = BinaryClassificationModelSelector.with_train_validation_split(
        parallelism=8)
    assert tvs.validator.parallelism == 8


def _grid_selector(validator=None):
    return ModelSelector(
        [(OpLogisticRegression(), grid(reg_param=[0.001, 0.01, 0.1])),
         (OpRandomForestClassifier(num_trees=4, seed=5),
          grid(max_depth=[3, 5], min_instances_per_node=[10]))],
        problem_type="binary",
        validator=validator or OpCrossValidation(num_folds=3,
                                                 stratify=True))


def _sweep(sel, X, y, sync: bool, monkeypatch):
    if sync:
        monkeypatch.setenv("TMOG_SYNC_SWEEP", "1")
    else:
        monkeypatch.delenv("TMOG_SYNC_SWEEP", raising=False)
    cands = sel._candidates()
    best, results = sel.validator.validate(
        cands, torch.from_numpy(X), y, np.ones(len(y), np.float32),
        eval_fn=sel._metric, metric_name="AuPR")
    groups = {type(c[3]).__name__: c[3].seconds for c in cands if c[3]}
    return best, [(r.fold_values, r.metric_value, r.error)
                  for r in results], groups


@pytest.mark.parametrize("tvs", [False, True])
def test_async_equals_sync(monkeypatch, tvs):
    from transmogrifai_tpu_torch.selector.validators import \
        OpTrainValidationSplit

    X, y = _data()
    v = (OpTrainValidationSplit(stratify=True) if tvs else None)
    sb, sres, sgroups = _sweep(_grid_selector(v), X, y, True, monkeypatch)
    ab, ares, agroups = _sweep(_grid_selector(v), X, y, False, monkeypatch)
    assert ab == sb
    assert ares == sres
    assert set(agroups) == set(sgroups) == {"LogRegGridGroup",
                                            "RFGridGroup"}
    assert all(s is not None and s >= 0 for s in agroups.values())


def _pre_queue_sweep(candidates, fold_ctxs, run_fold, run_group):
    """The sweep before the work queue: every group first, then each
    candidate left without a group result, one at a time; the metrics
    fetched per group matrix and in one stack for the sequential fits."""
    n = len(candidates)
    vals, errors, groups = [None] * n, [None] * n, []
    for c in candidates:
        if c[3] is not None and not any(c[3] is g for g in groups):
            groups.append(c[3])
    for group in groups:
        members = [i for i, c in enumerate(candidates) if c[3] is group]
        try:
            M = run_group(group)
        except Exception:  # noqa: BLE001 - the members fit one by one
            M = None
        if M is None:
            continue
        host = M.detach().to("cpu", torch.float64).numpy()
        for r, i in enumerate(members):
            vals[i] = [float(v) for v in host[r]]
    pending = [i for i in range(n) if vals[i] is None]
    for i in pending:
        try:
            vals[i] = [run_fold(candidates[i][2], candidates[i][1], ctx)
                       for ctx in fold_ctxs]
        except Exception as e:  # noqa: BLE001 - recorded on the result
            vals[i], errors[i] = [], f"{type(e).__name__}: {e}"
    dev = [v for i in pending for v in vals[i] if isinstance(v, torch.Tensor)]
    if dev:
        it = iter(torch.stack([v.to(torch.float64) for v in dev]).cpu()
                  .tolist())
        for i in pending:
            vals[i] = [next(it) if isinstance(v, torch.Tensor) else float(v)
                       for v in vals[i]]
    return vals, errors


class _Declining:
    """Wraps a group so that it declines: its members fit one by one."""

    def __init__(self, group):
        self.group = group
        self.seconds = self.error = None
        self.grid_points = group.grid_points

    def run(self, X, y, ctxs):
        return None


@pytest.mark.parametrize("decline", [False, True])
def test_sync_loop_gives_the_pre_queue_results(monkeypatch, decline):
    monkeypatch.setenv("TMOG_SYNC_SWEEP", "1")
    X, y = _data()
    sel = _grid_selector()
    cands = sel._candidates()
    if decline:   # the LR group declines: its members fit sequentially
        lr_group = _Declining(cands[0][3])
        cands = [c[:3] + ((lr_group,) if c[3] is cands[0][3] else (c[3],))
                 for c in cands]
    Xt, w = torch.from_numpy(X), np.ones(len(y), np.float32)
    folds = tv.make_folds(len(y), 3, y=y, stratify=True, seed=42)
    ctxs = [(w * (folds != k), w * (folds == k)) for k in range(3)]

    def run_fold(fitter, params, ctx):
        return sel._metric(y, fitter(Xt, y, ctx[0], params)(Xt), ctx[1])

    want, werr = _pre_queue_sweep(cands, ctxs, run_fold,
                                  lambda g: g.run(Xt, y, ctxs))
    _, results = sel.validator.validate(
        sel._candidates() if not decline else cands, Xt, y, w,
        eval_fn=sel._metric, metric_name="AuPR")
    assert [r.fold_values for r in results] == want
    assert [r.error for r in results] == werr


def test_metric_copy_is_one_stack():
    """The asynchronous loop's end: group matrices and scalars in one
    float64 copy, the values those of the per-matrix copies."""
    M = torch.rand(3, 2)
    vals = [tv._GroupRow(M, 0), tv._GroupRow(M, 2),
            [torch.tensor(0.25), 0.5], [], [torch.tensor(0.75)]]
    assert tv._materialize(vals, one_copy=True) == tv._materialize(vals)
    host = M.double().numpy()
    assert tv._materialize(vals)[:2] == [list(host[0]), list(host[2])]
