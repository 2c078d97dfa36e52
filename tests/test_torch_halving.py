"""The port's successive halving (``tuning/halving.py``) and its device
promotion (``selector/async_dispatch.py``) against the JAX package's, on
the CPU.

* ``rung_schedule`` equals the JAX package's over a grid of (rows,
  candidates, eta, min_rows); ``nested_subsample_order`` and
  ``_scaled_params`` are bit-equal.
* ``halving_validate`` on the same 6 000 seeded rows x 10 columns in both
  packages (``HalvingConfig(min_rows=256)``, so that a ladder exists; LR 4
  x 1 and 5-tree forests 2 x 2): the same schedule JSON
  (walls aside), each rung's metrics (RF within 1e-6: the port draws the
  JAX package's bags; LR within 1e-4), the same promotions, where no two
  rung scores at the promotion cut lie within those tolerances (the test
  says so where they do, and compares up to that tie), and the same
  winner.
* ``device_promote`` breaks ties toward the lower index and ranks NaN
  worst; the asynchronous ladder's promotions and results equal the
  synchronous one's bitwise.
"""
import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.models import gbdt_kernels as jg
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
from transmogrifai_tpu.models.trees import OpRandomForestClassifier as JRF
from transmogrifai_tpu.selector.model_selector import ModelSelector as JMS
from transmogrifai_tpu.selector.model_selector import grid as jgrid
from transmogrifai_tpu.selector.splitters import DataSplitter as JSplitter
from transmogrifai_tpu.selector.validators import \
    OpCrossValidation as JCV
from transmogrifai_tpu.tuning import halving as jh
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.models.classification import \
    OpLogisticRegression
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.selector import async_dispatch as ad
from transmogrifai_tpu_torch.selector.model_selector import (ModelSelector,
                                                             grid)
from transmogrifai_tpu_torch.selector.splitters import DataSplitter
from transmogrifai_tpu_torch.selector.validators import OpCrossValidation
from transmogrifai_tpu_torch.tuning import halving as th
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import FeatureColumn

RF_TOL, LR_TOL = 1e-6, 1e-4
TIMING_KEYS = ("wallSecs", "candidateSeconds")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_bags(monkeypatch):
    """The port's forests draw the JAX package's bags (its draws compile
    a program a shape, so only the parity test takes them)."""
    def bags(seed, n_trees, n, d, msub, subsample_rate, device):
        bw, idx = jg.rf_bags_and_features(seed, n_trees, n, d, msub,
                                          subsample_rate)
        return (torch.from_numpy(np.array(bw)).to(device),
                torch.from_numpy(np.array(idx)).long().to(device))

    monkeypatch.setattr(tk, "rf_bags_and_features", bags)


def _data(n=6000, d=10, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    logits = X[:, 0] * 2.0 - X[:, 1] + 0.3 * X[:, 2] + np.sin(3 * X[:, 3])
    y = (logits + rng.normal(scale=0.9, size=n) > 0).astype(np.float32)
    return X, y


def _selector(port: bool, strategy="full", halving=None):
    lr, rf, ms, cv, g, sp = ((OpLogisticRegression, OpRandomForestClassifier,
                              ModelSelector, OpCrossValidation, grid,
                              DataSplitter) if port
                             else (JLR, JRF, JMS, JCV, jgrid, JSplitter))
    return ms(models_and_params=[
        (lr(), g(reg_param=[0.001, 0.01, 0.1, 0.3])),
        (rf(num_trees=5, seed=3),
         g(max_depth=[3, 5], min_instances_per_node=[10, 100]))],
        problem_type="binary",
        validator=cv(num_folds=3, stratify=True),
        splitter=sp(reserve_test_fraction=0.1),
        validation_metric="AuPR", strategy=strategy, halving=halving)


class _Recording:
    """A validator that keeps each rung's (params, results)."""

    def __init__(self, inner):
        self.inner = inner
        self.rungs = []

    def validate(self, cands, *args, **kwargs):
        best, results = self.inner.validate(cands, *args, **kwargs)
        self.rungs.append([(c[0], c[1]) for c in cands])
        self.rungs[-1] = list(zip(self.rungs[-1],
                                  [(r.fold_values, r.metric_value)
                                   for r in results]))
        return best, results


def _halving(port: bool, X, y, record: bool):
    sel = _selector(port)
    mod = th if port else jh
    validator = _Recording(sel.validator) if record else sel.validator
    return (mod.halving_validate(
        validator, sel._candidates(with_groups=False),
        torch.from_numpy(X) if port else X, y, np.ones(len(y), np.float32),
        eval_fn=sel._metric, metric_name="AuPR", larger_better=True,
        config=mod.HalvingConfig(min_rows=256)), validator)


def _strip(sched):
    out = dict(sched)
    out.pop("candidateSeconds", None)
    out["rungs"] = [{k: v for k, v in r.items() if k not in TIMING_KEYS}
                    for r in sched["rungs"]]
    return out


@pytest.mark.parametrize("n,k,eta,min_rows", [
    (100_000, 12, 3, 2048), (1_000_000, 26, 3, 2048), (6_000, 26, 3, 256),
    (6_000, 8, 3, 2048), (1000, 12, 3, 2048), (100_000, 2, 3, 2048),
    (50_000, 100, 4, 500), (3, 3, 2, 1), (2_000_000, 7, 2, 10_000)])
def test_rung_schedule_matches_jax(n, k, eta, min_rows):
    t = th.rung_schedule(n, k, th.HalvingConfig(eta=eta, min_rows=min_rows))
    j = jh.rung_schedule(n, k, jh.HalvingConfig(eta=eta, min_rows=min_rows))
    assert [r.to_json() for r in t] == [r.to_json() for r in j]


def test_smoke_schedule():
    """The card smoke's default selector: 26 candidates on 1M rows."""
    rows = [(r.rows, r.survivors_in) for r in th.rung_schedule(
        1_000_000, 26)]
    assert rows == [(37_038, 26), (111_112, 9), (333_334, 3), (1_000_000, 1)]


@pytest.mark.parametrize("seed,stratify,classes", [
    (7, True, 2), (3, True, 5), (11, False, 2), (7, True, 1)])
def test_nested_order_and_scaled_params_bit_equal(seed, stratify, classes):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, 5000).astype(np.float32)
    y[rng.random(5000) < 0.01] = np.nan
    np.testing.assert_array_equal(
        th.nested_subsample_order(y, seed, stratify=stratify),
        jh.nested_subsample_order(y, seed, stratify=stratify))
    for params, frac in (({"max_iter": 50, "reg_param": 0.1}, 0.1),
                         ({"num_round": 200}, 0.01),
                         ({"max_iter": 1, "num_round": 7.0}, 0.5),
                         ({"max_iter": 50}, 1.0)):
        tp = th._scaled_params(params, frac, th.HalvingConfig())
        jp = jh._scaled_params(params, frac, jh.HalvingConfig())
        assert tp == jp
        assert (tp is params) == (jp is params)


def test_halving_validate_matches_jax(monkeypatch, jax_bags):
    monkeypatch.setenv("TMOG_SYNC_SWEEP", "1")
    X, y = _data()
    (tb, tres, tsched), trec = _halving(True, X, y, record=True)
    (jb, jres, jsched), jrec = _halving(False, X, y, record=True)
    assert _strip(tsched) == _strip(jsched) or _ties_explain(
        trec, jrec, tsched, jsched)
    assert len(tsched["rungs"]) == 3
    assert [r["survivorsIn"] for r in tsched["rungs"]] == [8, 3, 1]
    for rt, rj in zip(trec.rungs, jrec.rungs):
        for ((name, p), (tf, tm)), ((jname, jp), (jf, jm)) in zip(rt, rj):
            assert (name, p) == (jname, jp)
            tol = RF_TOL if "Forest" in name else LR_TOL
            np.testing.assert_allclose(tf, jf, rtol=0, atol=tol)
    assert tb == jb
    for a, b in zip(tres, jres):
        assert (a.model_name, a.params) == (b.model_name, b.params)
        assert (a.error or "")[:40] == (b.error or "")[:40]
    assert sum("halving: eliminated" in (r.error or "") for r in tres) == 7


def _ties_explain(trec, jrec, tsched, jsched) -> bool:
    """Where the promotions differ, each difference must sit at a cut
    where two rung scores lie within the tolerance: the test says so."""
    for rung, (rt, ts, js) in enumerate(zip(trec.rungs, tsched["rungs"],
                                            jsched["rungs"])):
        if ts["promoted"] == js["promoted"]:
            continue
        scores = sorted((m for _, (_, m) in rt), reverse=True)
        cut = ts["survivorsOut"]
        gap = scores[cut - 1] - scores[cut]
        print(f"rung {rung}: promotions differ at a near-tie "
              f"(gap {gap:.2e}): {ts['promoted']} vs {js['promoted']}")
        if gap > LR_TOL:
            return False
    return True


def test_async_and_sync_ladders_identical(monkeypatch):
    """The deferred ladder (device promotion, one copy at the end) gives
    the synchronous ladder's promotions and results bitwise."""
    X, y = _data(n=2000, seed=4)
    monkeypatch.setenv("TMOG_SYNC_SWEEP", "1")
    (sb, sres, ssched), _ = _halving(True, X, y, record=False)
    monkeypatch.delenv("TMOG_SYNC_SWEEP")
    (ab, ares, asched), _ = _halving(True, X, y, record=False)
    assert _strip(asched) == _strip(ssched)
    assert ab == sb
    assert [(r.fold_values, r.metric_value, r.error) for r in ares] == \
        [(r.fold_values, r.metric_value, r.error) for r in sres]


def test_device_promote_ties_go_to_the_lower_index():
    s = torch.tensor([0.5, 0.9, 0.5, 0.9, float("nan"), 0.1, 0.9])
    assert ad.device_promote(s, 2, True) == [1, 3]
    assert ad.device_promote(s, 4, True) == [0, 1, 3, 6]
    assert ad.device_promote(s, 2, False) == [0, 5]
    assert ad.device_promote(s, 7, True)[-1] == 6
    # the host promotion's order, candidate for candidate
    alive = list(range(7))
    scores = {i: (float(v) if np.isfinite(float(v)) else float("-inf"))
              for i, v in enumerate(s)}
    for k in range(1, 7):
        assert ad.device_promote(s, k, True) == th._host_promote(
            alive, scores, k, True)


def test_device_rung_scores_float32_finite_means():
    from transmogrifai_tpu_torch.selector.validators import _GroupRow

    M = torch.tensor([[0.5, float("nan")], [0.25, 0.75]], dtype=torch.float64)
    vals = [_GroupRow(M, 0), _GroupRow(M, 1),
            [torch.tensor(0.1), 0.3], [], [float("nan"), float("nan")]]
    errors = [None, None, None, "boom", None]
    got = ad.device_rung_scores(vals, errors, True)
    assert got.dtype == torch.float32
    mean = (np.float32(0.1) + np.float32(0.3)) / np.float32(2)
    np.testing.assert_array_equal(
        got[:4].numpy(), np.float32([0.5, 0.5, mean, -np.inf]))
    assert torch.isnan(got[4])


def test_selector_halving_strategy_end_to_end():
    """``strategy="halving"`` through the port's selector: the schedule,
    the annotated eliminations and a full-data winner."""
    X, y = _data(n=2500, seed=2)
    sel = _selector(True, strategy="halving",
                    halving=th.HalvingConfig(min_rows=256))
    model = sel.fit_columns(None, FeatureColumn.from_values(
        ft.RealNN, y.astype(np.float64)),
        FeatureColumn(ft.OPVector, torch.from_numpy(X)))
    sched = sel.metadata["halving_schedule"]
    assert sched["rungs"] and sched["rungs"][-1]["fraction"] == 1.0
    summ = sel.metadata["model_selector_summary"]
    errs = [r.get("error") for r in summ["validationResults"]]
    assert sum(bool(e and "halving: eliminated" in e) for e in errs) == 7
    winner = [r for r in summ["validationResults"] if not r.get("error")]
    assert len(winner) == 1
    assert (winner[0]["modelType"], winner[0]["params"]) == (
        model.best_name, model.best_params)
    assert sel.metadata["elastic"]["quarantined"] == 0
