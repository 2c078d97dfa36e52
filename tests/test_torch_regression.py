"""The port's regression AutoML path against the JAX package, on the CPU.

Held, on numpy-seeded inputs in both packages (the JAX runs with
``TMOG_SYNC_SWEEP=1`` and ``TMOG_COST_HISTORY=0``):

* the regression metrics and evaluator: within 1e-6 relative (the JAX
  kernel sums in float32, the port in float64);
* ``fit_linear_regression`` / ``fit_linreg_grid`` and the estimator:
  coefficients within 1e-4, CV metrics within 1e-5 (an iterative float32
  solve whose products sum in another order);
* ``IntegralVectorizer``: fills (the mode, ties to the smallest value) and
  null-indicator columns exact;
* bagged regression forests with the JAX package's bags and feature
  subsets injected, at depths 3 and 12 (depth 12 on 600 rows compacts its
  node ids): trees equal up to ties that route every row alike (two
  features that order a small node's rows the same way: float32 sums in
  another order pick either), leaves and truncation snapshots within 1e-5
  relative;
* the sequential boosted regressors (``OpGBTRegressor``,
  ``OpXGBoostRegressor`` with early stopping): equal trees, stop round and
  starting margin, predictions within 1e-5 relative;
* the whole slice, ``RegressionModelSelector.with_cross_validation()`` and
  ``.with_train_validation_split()`` on a Boston-shaped frame (12 RealNN,
  an Integral, a PickList, a RealNN label; 3 000 training rows): the same
  winner and splitter summary, every candidate's CV RMSE within 1e-5,
  holdout RMSE within 1e-5.  The grid is the default families on a
  reduced grid; the GBT candidates take ``min_child_weight`` 10, where no
  two features cut a node's rows alike (``tests/test_torch_gbt_grid.py``
  holds the default ``min_child_weight`` 1 to trees up to such ties);
* saved models across the packages: scores within 1e-6 relative either
  way, the port's own round trip bitwise.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import transmogrifai_tpu_torch as tt
from test_torch_gbt_grid import _assert_same_tree
from transmogrifai_tpu.evaluators import metrics as jm
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JEvaluators
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models import gbdt_kernels as jg
from transmogrifai_tpu.models import linear as jl
from transmogrifai_tpu.models.regression import \
    OpLinearRegression as JLinReg
from transmogrifai_tpu.models.trees import OpGBTRegressor as JGBT
from transmogrifai_tpu.models.trees import OpRandomForestRegressor as JRF
from transmogrifai_tpu.models.trees import OpXGBoostRegressor as JXGBR
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JSanityChecker
from transmogrifai_tpu.selector.model_selector import \
    RegressionModelSelector as JRMS
from transmogrifai_tpu.selector.model_selector import grid as jgrid
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import ColumnarDataset as JDataset
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu.workflow.workflow import \
    OpWorkflowModel as JWorkflowModel
from transmogrifai_tpu_torch.evaluators import metrics as tm
from transmogrifai_tpu_torch.evaluators.evaluators import (
    Evaluators, OpRegressionEvaluator)
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.local import score_function
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.models import linear as tl
from transmogrifai_tpu_torch.models.prediction import PredictionBatch
from transmogrifai_tpu_torch.models.regression import (LinearRegressionModel,
                                                       OpLinearRegression)
from transmogrifai_tpu_torch.models.trees import (OpGBTRegressor,
                                                  OpRandomForestRegressor,
                                                  OpXGBoostRegressor,
                                                  TreeEnsembleModel)
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.selector.model_selector import (
    ModelSelector, RegressionModelSelector, SelectedModel, grid)
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import ColumnarDataset, FeatureColumn
from transmogrifai_tpu_torch.workflow.workflow import (OpWorkflow,
                                                       OpWorkflowModel)

REGRESSION_METRICS = ("RootMeanSquaredError", "MeanSquaredError",
                      "MeanAbsoluteError", "R2")


# ---------------------------------------------------------------------------
# metrics and the evaluator
# ---------------------------------------------------------------------------

def _reg_scores(seed, n=2000):
    rng = np.random.default_rng(seed)
    y = (22.5 + 9 * rng.normal(size=n)).astype(np.float32)
    p = (y + 3 * rng.normal(size=n)).astype(np.float32)
    w = rng.integers(0, 3, n).astype(np.float32)
    return y, p, w


@pytest.mark.parametrize("metric", REGRESSION_METRICS)
def test_regression_metric_matches_jax(metric):
    """The device metric against the JAX kernel (float32 sums: 1e-6
    relative) and the host metric set (float64 in both: 1e-12)."""
    y, p, w = _reg_scores(1)
    got = float(tm.regression_metric_device(torch.from_numpy(y),
                                            torch.from_numpy(p),
                                            torch.from_numpy(w), metric))
    want = float(jm._regression_metric_dev(jnp.asarray(y), jnp.asarray(p),
                                           jnp.asarray(w), metric))
    assert got == pytest.approx(want, rel=1e-6)
    host = jm.regression_metrics(y, p, w)
    assert tm.regression_metrics(torch.from_numpy(y), torch.from_numpy(p),
                                 torch.from_numpy(w))[metric] == \
        pytest.approx(host[metric], rel=1e-12)


def test_regression_metric_grid_matches_jax():
    """(F, C, N) predictions and (F, N) weights -> (F, C), within 1e-6
    relative; the minimised metrics and an unknown metric."""
    rng = np.random.default_rng(2)
    y = (22 + 9 * rng.normal(size=1500)).astype(np.float32)
    P = (y[None, None, :] + 4 * rng.normal(size=(3, 4, 1500))).astype(
        np.float32)
    W = (rng.random((3, 1500)) < 0.3).astype(np.float32)
    for metric in REGRESSION_METRICS:
        want = np.asarray(jm.regression_metric_grid(
            jnp.asarray(y), jnp.asarray(P), jnp.asarray(W), metric))
        got = tm.regression_metric_grid(torch.from_numpy(y),
                                        torch.from_numpy(P),
                                        torch.from_numpy(W), metric)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert tm.regression_metric_grid(torch.from_numpy(y),
                                     torch.from_numpy(P),
                                     torch.from_numpy(W), "AuPR") is None
    assert set(REGRESSION_METRICS) - {"R2"} <= set(tm.MINIMIZE_METRICS)
    assert set(tm.MINIMIZE_METRICS) <= set(jm.MINIMIZE_METRICS)


def test_regression_evaluator_matches_jax():
    """``OpRegressionEvaluator`` on a prediction column (the prediction
    only) against the JAX package's host metric set: within 1e-6
    relative, weighted and not; the factories' names and directions."""
    y, p, w = _reg_scores(3)
    data = ColumnarDataset({
        "label": FeatureColumn.from_values(ft.RealNN, y),
        "pred": FeatureColumn(ft.Prediction, PredictionBatch(
            prediction=torch.from_numpy(p.astype(np.float64))))})
    ev = OpRegressionEvaluator(label_col="label", prediction_col="pred")
    for weights in (None, w):
        got = ev.evaluate(data, sample_weight=weights)
        want = jm.regression_metrics(y.astype(np.float64),
                                     p.astype(np.float64), weights)
        assert set(got) == set(want) == set(REGRESSION_METRICS)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-6), k
    for name in ("rmse", "mse", "mae", "r2"):
        a = getattr(Evaluators.Regression, name)()
        b = getattr(JEvaluators.Regression, name)()
        assert (a.default_metric, a.larger_better) == (b.default_metric,
                                                       b.larger_better)


# ---------------------------------------------------------------------------
# linear regression
# ---------------------------------------------------------------------------

def _lin_problem(n=800, d=10, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 3] *= 40.0                                    # a wide column
    X[:, 4] = (rng.random(n) < 0.2).astype(np.float32)  # an indicator
    beta = rng.normal(size=d)
    y = (20 + X @ beta * 0.5 + rng.normal(size=n)).astype(np.float32)
    folds = rng.integers(0, 3, n)
    W = np.stack([(folds != k).astype(np.float32) for k in range(3)])
    Wev = np.stack([(folds == k).astype(np.float32) for k in range(3)])
    return X, y, W, Wev


@pytest.mark.parametrize("reg,alpha", [(0.0, 0.0), (0.1, 0.0), (0.05, 0.5),
                                       (0.2, 1.0)])
def test_fit_linear_regression_matches_jax(reg, alpha):
    """One weighted fit, ridge or FISTA: coefficients and intercept within
    1e-4."""
    X, y, W, _ = _lin_problem()
    jf = jl.fit_linear_regression(jnp.asarray(X), jnp.asarray(y),
                                  jnp.asarray(W[0]), reg_param=reg,
                                  elastic_net_param=alpha, max_iter=200,
                                  tol=1e-7)
    tf = tl.fit_linear_regression(torch.from_numpy(X), torch.from_numpy(y),
                                  torch.from_numpy(W[0]), reg_param=reg,
                                  elastic_net_param=alpha, max_iter=200,
                                  tol=1e-7)
    np.testing.assert_allclose(tf.coef.numpy(), np.asarray(jf.coef),
                               rtol=0, atol=1e-4)
    assert float(tf.intercept) == pytest.approx(float(jf.intercept),
                                                abs=1e-4)
    assert tf.converged == bool(jf.converged)


@pytest.mark.parametrize("standardization", [True, False])
def test_fit_linreg_grid_matches_jax(standardization):
    """Every (fold, candidate) solve of the default grid's (reg, alpha)
    pairs and one more full-train row: coefficients within 1e-4, CV RMSE
    within 1e-5."""
    X, y, W, Wev = _lin_problem()
    W_aug = np.vstack([W, W.sum(0, keepdims=True) > 0]).astype(np.float32)
    regs = np.repeat(np.asarray([0.001, 0.01, 0.1, 0.2], np.float32), 2)
    alphas = np.tile(np.asarray([0.1, 0.5], np.float32), 4)
    kw = dict(max_iter=200, tol=1e-7, fit_intercept=True,
              standardization=standardization)
    jp, jc, ji = jl.fit_linreg_grid(jnp.asarray(X), jnp.asarray(y),
                                    jnp.asarray(W_aug), jnp.asarray(regs),
                                    jnp.asarray(alphas), **kw)
    tp, tc, ti = tl.fit_linreg_grid(torch.from_numpy(X), torch.from_numpy(y),
                                    torch.from_numpy(W_aug),
                                    torch.from_numpy(regs),
                                    torch.from_numpy(alphas), **kw)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0,
                               atol=1e-4)
    want = np.asarray(jm.regression_metric_grid(
        jnp.asarray(y), jp[:3], jnp.asarray(Wev), "RootMeanSquaredError"))
    got = tm.regression_metric_grid(torch.from_numpy(y), tp[:3],
                                    torch.from_numpy(Wev),
                                    "RootMeanSquaredError").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_linear_regression_estimator_matches_jax():
    """``OpLinearRegression.fit_raw`` (standardized, weighted) against the
    JAX estimator: coefficients within 1e-4; the fitted model's batch
    holds the prediction only."""
    tt.set_device("cpu")
    X, y, W, _ = _lin_problem()
    for reg, alpha in ((0.01, 0.0), (0.1, 0.5)):
        jmod = JLinReg(reg_param=reg, elastic_net_param=alpha).fit_raw(
            X, y, W[1])
        tmod = OpLinearRegression(reg_param=reg,
                                  elastic_net_param=alpha).fit_raw(
            X, y, W[1])
        np.testing.assert_allclose(tmod.coef.numpy(),
                                   np.asarray(jmod.coef), rtol=0, atol=1e-4)
        assert tmod.intercept == pytest.approx(jmod.intercept, abs=1e-3)
        batch = tmod.predict_batch(torch.from_numpy(X))
        assert batch.probability is None and batch.raw_prediction is None
        assert batch.prediction.dtype == torch.float64
        assert batch.rows()[0].keys() == {"prediction"}


# ---------------------------------------------------------------------------
# IntegralVectorizer and transmogrify's integral group
# ---------------------------------------------------------------------------

def _integral_data(cls_ds, cls_col, types):
    a = [3, 1, None, 3, 1, 7, None, 2, 2, 7] * 30      # modes 1/2/3/7 tie
    b = [5, 5, 5, None, 4, None, 4, 5, 0, 0] * 30
    c = [None] * 300                                   # all missing
    r = np.linspace(-1, 1, 300)
    return cls_ds({"a": cls_col.from_values(types.Integral, a),
                   "b": cls_col.from_values(types.Integral, b),
                   "c": cls_col.from_values(types.Integral, c),
                   "r": cls_col.from_values(types.Real, r)})


def test_integral_vectorizer_matches_jax():
    """``transmogrify`` sends Integral features to ``IntegralVectorizer``
    (after the reals, as the JAX dispatcher orders its groups): fills
    (the mode, ties to the smallest value; 0 for an all missing column),
    the matrix and its null-indicator columns exact."""
    tt.set_device("cpu")
    vecs = []
    for fb, tr, wf, ds in ((JFB, jtransmogrify, JWorkflow,
                            _integral_data(JDataset, JColumn, jft)),
                           (FeatureBuilder, transmogrify, OpWorkflow,
                            _integral_data(ColumnarDataset, FeatureColumn,
                                           ft))):
        feats = [fb.Integral(n).as_predictor() for n in "abc"]
        vec = tr(feats + [fb.Real("r").as_predictor()])
        model = wf().set_result_features(vec).set_input_data(ds).train()
        fitted = [s for s in model.stages
                  if type(s).__name__ == "RealVectorizerModel"]
        vecs.append((np.asarray(model.score(ds)[vec.name].values),
                     [list(s.fills) for s in fitted]))
    (jv, jfills), (tv, tfills) = vecs
    assert tfills == jfills
    assert [1.0, 5.0, 0.0] in tfills
    np.testing.assert_array_equal(tv, jv)
    assert tv.shape == (300, 8)


def test_transmogrify_refuses_dates():
    """Date features (an Integral subtype) form the JAX package's date
    group: transmogrify refuses them to the integral vectorizer and gives
    them the date group's unit-circle vectorizer."""
    from transmogrifai_tpu_torch.ops.date_geo import \
        DateToUnitCircleVectorizer
    from transmogrifai_tpu_torch.ops.vectorizers import IntegralVectorizer

    out = transmogrify([FeatureBuilder.Date("d").as_predictor()])
    assert isinstance(out.origin_stage, DateToUnitCircleVectorizer)
    assert not isinstance(out.origin_stage, IntegralVectorizer)


# ---------------------------------------------------------------------------
# bagged regression forests
# ---------------------------------------------------------------------------

def _bags(monkeypatch):
    def bags(seed, n_trees, n, d, msub, rate, device):
        bw, idx = jg.rf_bags_and_features(seed, n_trees, n, d, msub, rate)
        return (torch.from_numpy(np.array(bw)),
                torch.from_numpy(np.array(idx)).long())
    monkeypatch.setattr(tk, "rf_bags_and_features", bags)


@pytest.mark.parametrize("depth,n", [(3, 2500), (12, 600)])
def test_bagged_regression_grid_matches_jax(depth, n, monkeypatch):
    """``grow_rf_grid(regression=True)`` (channels (bw y, bw), variance
    gain, bag-weighted mean leaves) against the JAX grower in bag mode
    "bagged", with its bags: trees equal up to ties that route every row
    alike, leaves and snapshots within 1e-5 relative, histogram levels
    counted.  Depth 12 on 600 rows compacts the node ids of levels past
    1 024 nodes."""
    rng = np.random.default_rng(depth)
    d = 12
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 1] = np.round(X[:, 1])
    y = (22.5 + 6 * X[:, 0] + 4 * np.tanh(X[:, 2] * X[:, 3])
         + 2 * rng.normal(size=n)).astype(np.float32)
    edges = tk.quantile_bins(torch.from_numpy(X), 32)
    binned = tk.apply_bins(torch.from_numpy(X), edges)
    folds = rng.integers(0, 3, n)
    W = np.stack([(folds != k).astype(np.float32) for k in range(3)])
    levels = (1, 2) if depth == 3 else (3, 6)
    pairs = dict(pair_fold=np.array([0, 1, 2, 0], np.int32),
                 pair_min_ig=np.array([0.001, 0.01, 0.1, 0.001], np.float32),
                 pair_min_inst=np.array([5, 10, 5, 100], np.float32),
                 pair_depth=np.array([depth] * 3 + [depth - 1], np.int32))
    kw = dict(seed=9, n_trees=3, msub=d // 3, subsample_rate=1.0, n_bins=32,
              leaf_levels=levels, **pairs)
    jf, jt, jlf, jsnaps = jg.grow_rf_grid(
        jnp.asarray(binned.numpy().astype(np.int8)), jnp.asarray(y[:, None]),
        jnp.asarray(W), onehot_targets=False, **kw)
    _bags(monkeypatch)
    g = tk.grow_rf_grid(binned, torch.from_numpy(y), torch.from_numpy(W),
                        regression=True, **kw)
    bw, _ = jg.rf_bags_and_features(9, 3, n, d, d // 3, 1.0)
    bw = np.asarray(bw)
    assert g.leaf.shape == (4, 3, 2 ** depth, 1)
    ties = 0
    for p in range(4):
        for t in range(3):
            rows = W[pairs["pair_fold"][p]] * bw[t] > 0
            ties += _assert_same_tree(
                np.asarray(jf[p, t]), np.asarray(jt[p, t]),
                np.asarray(jlf[p, t]), g.feat[p, t].numpy(),
                g.thresh[p, t].numpy(), g.leaf[p, t].numpy(),
                binned.numpy(), rows, depth)
            # the truncation snapshots: the tree cut at the level
            for lv in levels:
                nd = 2 ** lv - 1
                ties += _assert_same_tree(
                    np.asarray(jf[p, t, :nd]), np.asarray(jt[p, t, :nd]),
                    np.asarray(jsnaps[lv][p, t]), g.feat[p, t, :nd].numpy(),
                    g.thresh[p, t, :nd].numpy(), g.snaps[lv][p, t].numpy(),
                    binned.numpy(), rows, lv)
    assert ties == 0
    assert 0 < g.levels <= 3 * (3 * depth + depth - 1)


def test_random_forest_regressor_matches_jax(monkeypatch):
    """``OpRandomForestRegressor.fit_raw``: one-third feature subsets
    (``auto``), the JAX package's bags; trees equal and predictions (the
    mean of the trees) within 1e-5 relative."""
    tt.set_device("cpu")
    rng = np.random.default_rng(8)
    X = rng.normal(size=(1500, 9)).astype(np.float32)
    y = (20 + 5 * X[:, 0] - 3 * X[:, 4] + rng.normal(size=1500)).astype(
        np.float32)
    kw = dict(num_trees=4, max_depth=5, min_instances_per_node=10)
    jmod = JRF(**kw).fit_raw(X, y)
    _bags(monkeypatch)
    est = OpRandomForestRegressor(**kw)
    tmod = est.fit_raw(X, y, device="cpu")
    assert tmod.mode == jmod.mode == "rf_reg"
    np.testing.assert_array_equal(tmod.feat.numpy(), np.asarray(jmod.feat))
    np.testing.assert_array_equal(tmod.thresh.numpy(),
                                  np.asarray(jmod.thresh))
    got = tmod.predict_batch(torch.from_numpy(X)).prediction.numpy()
    want = np.asarray(jmod.predict_batch(X).prediction)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert est.metadata["hist_levels"] > 0


# ---------------------------------------------------------------------------
# the sequential boosted regressors
# ---------------------------------------------------------------------------

def _gbt_problem(seed=6, n=3000):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = (22.5 + 5 * X[:, 0] - 3 * X[:, 1] + 3 * np.tanh(X[:, 2] * X[:, 3])
         + 3 * rng.normal(size=n)).astype(np.float32)
    return X, y


@pytest.mark.parametrize("kind", ["gbt", "xgb_es"])
def test_boosted_regressor_matches_jax(kind, monkeypatch):
    """``OpGBTRegressor`` (depth 4, 12 rounds) and ``OpXGBoostRegressor``
    (early stopping on minus the validation MSE, patience 3): the same
    starting margin, stop round and trees (no tie here), predictions
    within 1e-5 relative."""
    monkeypatch.setenv("TMOG_COST_HISTORY", "0")
    tt.set_device("cpu")
    X, y = _gbt_problem()
    if kind == "gbt":
        kw = dict(max_depth=4, max_iter=12, step_size=0.2,
                  min_child_weight=10.0)
        jest, est = JGBT(**kw), OpGBTRegressor(**kw)
    else:
        kw = dict(max_depth=5, num_round=60, eta=0.3, min_child_weight=10.0,
                  early_stopping_rounds=3)
        jest, est = JXGBR(**kw), OpXGBoostRegressor(**kw)
    jmod = jest.fit_raw(X, y)
    tmod = est.fit_raw(X, y, device="cpu")
    assert tmod.mode == jmod.mode == "gbdt_reg"
    assert tmod.base_score == jmod.base_score
    jf, jt, jlf = (np.asarray(a) for a in (jmod.feat, jmod.thresh,
                                           jmod.leaf))
    assert tmod.feat.shape[0] == jf.shape[0] == est.metadata["best_len"]
    if kind == "xgb_es":
        assert jf.shape[0] < 60
    binned = tk.apply_bins(torch.from_numpy(X), tmod.edges).numpy()
    depth = int(np.log2(jf.shape[1] + 1))
    train = np.ones(len(y), bool)
    if kind == "xgb_es":
        train = np.random.default_rng(est.seed).random(len(y)) >= 0.2
    ties = sum(_assert_same_tree(jf[r], jt[r], jlf[r], tmod.feat[r].numpy(),
                                 tmod.thresh[r].numpy(),
                                 tmod.leaf[r].numpy(), binned, train, depth)
               for r in range(jf.shape[0]))
    assert ties == 0
    got = tmod.predict_batch(torch.from_numpy(X)).prediction.numpy()
    np.testing.assert_allclose(got, np.asarray(
        jmod.predict_batch(X).prediction), rtol=1e-5)


def test_boosted_regression_refuses_what_is_not_ported(monkeypatch):
    """Nothing the JAX package's boosted regressors run is refused any
    more: count-gated growth and subsampling fit as the JAX package's
    fits do — every round's tree equal up to exact gain ties over the
    rows it grew on, up to the first tie that routes some other row
    differently (later rounds then start from other margins), and
    predictions within 1e-5 where no such tie occurs — and a label of 3
    classes boosts the softmax objective (mode ``gbdt_multi``)."""
    from test_torch_gbt_grid import _assert_same_tree

    from transmogrifai_tpu_torch.models import trees as ttrees
    from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier

    monkeypatch.setenv("TMOG_COST_HISTORY", "0")
    X, y = _gbt_problem(n=200)
    rows = []
    grow = ttrees.grow_tree

    def spy(*a, **k):
        rows.append(k["C"].numpy() > 0)
        return grow(*a, **k)

    monkeypatch.setattr(ttrees, "grow_tree", spy)
    for kw in (dict(min_instances_per_node=5), dict(min_info_gain=0.1),
               dict(subsample_rate=0.5)):
        rows.clear()
        got = OpGBTRegressor(**kw).fit_raw(X, y, device="cpu")
        want = JGBT(**kw).fit_raw(X, y)
        assert len(rows) == 20          # the count channel, every round
        binned = tk.apply_bins(torch.from_numpy(X), got.edges).numpy()
        jf, jt, jl = (np.asarray(a) for a in (want.feat, want.thresh,
                                              want.leaf))
        ties = 0
        for r in range(20):
            ties += _assert_same_tree(
                jf[r], jt[r], jl[r], got.feat[r].numpy(),
                got.thresh[r].numpy(), got.leaf[r].numpy(), binned,
                rows[r], 5)
            if ties:
                break
        if ties == 0:
            np.testing.assert_allclose(
                got.predict_batch(torch.from_numpy(X)).prediction.numpy(),
                np.asarray(want.predict_batch(X).prediction), rtol=1e-5)
    model = OpXGBoostClassifier().fit_raw(
        X, (np.arange(200) % 3).astype(np.float32), device="cpu")
    assert model.mode == "gbdt_multi" and model.leaf.shape[-1] == 3


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

N_REAL = 12


def _boston_like(n, seed):
    """12 RealNN columns, ``rad`` (Integral, 9 values, 5% missing),
    ``chas`` (PickList, 5 values and nulls), a RealNN label of Boston's
    scale (mean ~22.5, sd ~9) with linear, product and noise parts."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, N_REAL))
    rad = rng.choice([1., 2, 3, 4, 5, 6, 7, 8, 24], size=n)
    rad[rng.random(n) < 0.05] = np.nan
    chas = rng.choice(np.array(["0", "1", "2", "3", "4", None], dtype=object),
                      size=n, p=[0.5, 0.2, 0.1, 0.1, 0.05, 0.05])
    y = (22.5 + 4 * X[:, 0] - 3 * X[:, 1] + 2 * X[:, 2]
         + 3 * np.tanh(X[:, 3] * X[:, 4]) + 0.2 * np.nan_to_num(rad, nan=5)
         + 2 * (chas == "1") + 3 * rng.normal(size=n))
    return X, rad, list(chas), y


def _dataset(cls_ds, cls_col, types, X, rad, chas, y):
    cols = {f"x{j}": cls_col.from_values(types.RealNN, X[:, j])
            for j in range(N_REAL)}
    cols["rad"] = cls_col.from_values(types.Integral,
                                      [None if np.isnan(v) else v
                                       for v in rad])
    cols["chas"] = cls_col.from_values(types.PickList, chas)
    cols["label"] = cls_col.from_values(types.RealNN, y)
    return cls_ds(cols)


def _pipeline(fb, transmogrify_fn, checker_cls, selector):
    label = fb.RealNN("label").as_response()
    preds = ([fb.RealNN(f"x{j}").as_predictor() for j in range(N_REAL)]
             + [fb.Integral("rad").as_predictor(),
                fb.PickList("chas").as_predictor()])
    checked = label.transform_with(checker_cls(max_correlation=0.99),
                                   transmogrify_fn(preds))
    return label.transform_with(selector, checked), checked


def _models(lin, rf, gbt, g, families=("lin", "rf", "gbt")):
    out = []
    if "lin" in families:
        out.append((lin(), g(reg_param=[0.001, 0.1],
                             elastic_net_param=[0.1, 0.5], max_iter=[200])))
    if "rf" in families:
        out.append((rf(), g(num_trees=[5], max_depth=[3, 6],
                            min_instances_per_node=[10, 100],
                            min_info_gain=[0.001, 0.1])))
    if "gbt" in families:
        out.append((gbt(), g(max_depth=[3, 6], max_iter=[10],
                             step_size=[0.1], min_child_weight=[10.0])))
    return out


@pytest.fixture(scope="module")
def boston():
    return _boston_like(3000, 51), _boston_like(1000, 52)


def _jax_bags(seed, n_trees, n, d, msub, rate, device):
    bw, idx = jg.rf_bags_and_features(seed, n_trees, n, d, msub, rate)
    return (torch.from_numpy(np.array(bw)).to(device),
            torch.from_numpy(np.array(idx)).long().to(device))


def _train(data, factory, families=("lin", "rf", "gbt"), port=True):
    """(model, selector, prediction feature, checked feature) of one
    package's train on ``data``'s training rows."""
    train, _ = data
    if port:
        tt.set_device("cpu")
        sel = factory(RegressionModelSelector)(
            models_and_parameters=_models(OpLinearRegression,
                                          OpRandomForestRegressor,
                                          OpGBTRegressor, grid, families))
        pred, checked = _pipeline(FeatureBuilder, transmogrify,
                                  SanityChecker, sel)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tk, "rf_bags_and_features", _jax_bags)
            model = OpWorkflow().set_result_features(pred).set_input_data(
                _dataset(ColumnarDataset, FeatureColumn, ft, *train)).train()
        return model, sel, pred, checked
    sel = factory(JRMS)(models_and_parameters=_models(
        JLinReg, JRF, JGBT, jgrid, families))
    pred, checked = _pipeline(JFB, jtransmogrify, JSanityChecker, sel)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMOG_COST_HISTORY", "0")
        mp.setenv("TMOG_SYNC_SWEEP", "1")
        model = JWorkflow().set_result_features(pred).set_input_data(
            _dataset(JDataset, JColumn, jft, *train)).train()
    return model, sel, pred, checked


_VALIDATORS = {
    "cv": lambda cls: cls.with_cross_validation,
    "tvs": lambda cls: cls.with_train_validation_split,
}


@pytest.fixture(scope="module", params=list(_VALIDATORS))
def slice_runs(request, boston):
    factory = _VALIDATORS[request.param]
    hold = boston[1]
    runs = {}
    for port in (False, True):
        model, sel, pred, checked = _train(boston, factory, port=port)
        if port:
            scored, metrics = model.score_and_evaluate(
                Evaluators.Regression.rmse(),
                data=_dataset(ColumnarDataset, FeatureColumn, ft, *hold))
        else:
            scored, metrics = model.score_and_evaluate(
                JEvaluators.Regression.rmse(),
                data=_dataset(JDataset, JColumn, jft, *hold))
        runs["torch" if port else "jax"] = dict(
            model=model, selector=sel, pred=pred, checked=checked,
            scored=scored, metrics=metrics)
    runs["validator"] = request.param
    return runs


def _summary(run):
    return run["selector"].metadata["model_selector_summary"]


class TestRegressionSlice:
    def test_summary_and_splitter(self, slice_runs):
        j, t = _summary(slice_runs["jax"]), _summary(slice_runs["torch"])
        assert set(t) == set(j)
        assert t["problemType"] == j["problemType"] == "regression"
        assert t["validationType"] == j["validationType"] == {
            "cv": "OpCrossValidation",
            "tvs": "OpTrainValidationSplit"}[slice_runs["validator"]]
        assert t["dataPrepResults"] == j["dataPrepResults"]
        assert t["dataPrepResults"]["splitter"] == "DataSplitter"
        assert not any("error" in r for r in t["validationResults"])
        meta = slice_runs["torch"]["selector"].metadata
        assert meta["group_errors"] == {}
        assert {"LinRegGridGroup", "RFGridGroup", "GBTGridGroup"} <= set(
            meta["sweep_seconds"])

    def test_same_winner_and_cv_rmse(self, slice_runs):
        j, t = _summary(slice_runs["jax"]), _summary(slice_runs["torch"])
        assert (t["bestModelType"], t["bestModelParams"]) == (
            j["bestModelType"], j["bestModelParams"])
        folds = 3 if slice_runs["validator"] == "cv" else 1
        assert len(t["validationResults"]) == len(
            j["validationResults"]) == 14
        for a, b in zip(t["validationResults"], j["validationResults"]):
            assert (a["modelType"], a["params"]) == (b["modelType"],
                                                    b["params"])
            assert len(a["foldValues"]) == len(b["foldValues"]) == folds
            np.testing.assert_allclose(a["foldValues"], b["foldValues"],
                                       rtol=0, atol=1e-5)
            assert abs(a["metricValue"] - b["metricValue"]) <= 1e-5

    def test_holdout_rmse_and_predictions(self, slice_runs):
        jr, tr = slice_runs["jax"], slice_runs["torch"]
        assert set(tr["metrics"]) == set(REGRESSION_METRICS)
        for m in REGRESSION_METRICS:
            assert abs(tr["metrics"][m] - jr["metrics"][m]) <= 1e-5 * max(
                1.0, abs(jr["metrics"][m])), m
        tp = tr["scored"][tr["pred"].name].values
        jp = jr["scored"][jr["pred"].name].values
        assert tp.probability is None
        # a linear winner's coefficients agree within 1e-4 (an iterative
        # solve), over 20-odd unit-scale columns
        np.testing.assert_allclose(tp.prediction.numpy(),
                                   np.asarray(jp.prediction), rtol=0,
                                   atol=2e-3)
        # the label's scale; the tanh part is out of a linear model's reach
        assert 0.6 < tr["metrics"]["R2"] < 0.95

    def test_efb_engages_in_the_jax_package(self, slice_runs):
        """Both packages bundle this frame's one-hot columns (EFB) before
        their GBT chains grow: the port's plan on the checked matrix is the
        JAX package's, and its GBT group grew at that width."""
        run = slice_runs["torch"]
        X = run["model"].train_data[run["checked"].name].values
        edges = tk.quantile_bins(X, 32)
        tb = tk.apply_bins(X, edges)
        plan = jg.bundle_features(tb.numpy().astype(np.int8), edges, 32)
        assert plan is not None and plan.width < tb.shape[1]
        mine = tk.bundle_features(tb, edges, 32)
        assert mine.plan == plan.plan and np.array_equal(mine.end_bin,
                                                         plan.end_bin)
        meta = run["selector"].metadata
        assert meta["group_efb_width"]["GBTGridGroup"] == (tb.shape[1],
                                                           plan.width)


# ---------------------------------------------------------------------------
# saved models across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifacts(boston, tmp_path_factory):
    """For each family as the only one (so it wins): the JAX package's
    trained model saved, and the port's."""
    out = {}
    root = tmp_path_factory.mktemp("reg_artifacts")
    for fam in ("lin", "rf", "gbt"):
        factory = _VALIDATORS["cv"]
        for port in (False, True):
            model, sel, pred, _ = _train(boston, factory, families=(fam,),
                                         port=port)
            path = str(root / f"{fam}_{'torch' if port else 'jax'}")
            model.save(path)
            out[(fam, port)] = (model, pred, path)
    return out


def _hold_sets(boston):
    return (_dataset(JDataset, JColumn, jft, *boston[1]),
            _dataset(ColumnarDataset, FeatureColumn, ft, *boston[1]))


@pytest.mark.parametrize("fam", ["lin", "rf", "gbt"])
def test_artifacts_cross_both_ways(fam, boston, artifacts):
    """A regression model saved by either package loads in the other and
    scores the holdout within 1e-6 relative of its own package's scores;
    the port's load of its own save scores bitwise equal; the winner's
    class and mode survive."""
    tt.set_device("cpu")
    jhold, thold = _hold_sets(boston)
    jmodel, jpred, jpath = artifacts[(fam, False)]
    tmodel, tpred, tpath = artifacts[(fam, True)]
    want_j = np.asarray(jmodel.score(jhold)[jpred.name].values.prediction)
    got = OpWorkflowModel.load(jpath).score(thold)[jpred.name].values
    np.testing.assert_allclose(got.prediction.numpy(), want_j, rtol=1e-6)

    want_t = tmodel.score(thold)[tpred.name].values.prediction
    back = JWorkflowModel.load(tpath).score(jhold)[tpred.name].values
    np.testing.assert_allclose(np.asarray(back.prediction),
                               want_t.numpy(), rtol=1e-6)
    again = OpWorkflowModel.load(tpath).score(thold)[tpred.name].values
    assert torch.equal(again.prediction, want_t)

    sel = next(s for s in OpWorkflowModel.load(tpath).stages
               if isinstance(s, SelectedModel))
    if fam == "lin":
        assert isinstance(sel.inner, LinearRegressionModel)
    else:
        assert isinstance(sel.inner, TreeEnsembleModel)
        assert sel.inner.mode == {"rf": "rf_reg", "gbt": "gbdt_reg"}[fam]
    row = {f"x{j}": float(boston[1][0][0, j]) for j in range(N_REAL)}
    row.update(rad=None, chas="1")
    scored = score_function(OpWorkflowModel.load(tpath))(row)[tpred.name]
    assert set(scored) == {"prediction"}


# ---------------------------------------------------------------------------
# the device rule and the import rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", [
    lambda X, y: OpLinearRegression().fit_raw(X, y),
    lambda X, y: OpRandomForestRegressor(num_trees=2).fit_raw(X, y),
    lambda X, y: OpGBTRegressor(max_iter=2).fit_raw(X, y),
    lambda X, y: LinearRegressionModel(np.zeros(X.shape[1]), 0.0),
], ids=["linreg", "rf", "gbt", "model"])
def test_no_card_raises(entry, monkeypatch):
    """With no card and no request for the CPU, the regression entry
    points raise instead of running on the CPU."""
    from transmogrifai_tpu_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(device, "_default", "cuda")
    X, y = _gbt_problem(n=100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(X, y)


def test_selector_refuses_what_is_not_ported():
    """A problem type outside binary, multiclass and regression raises;
    the regression and multiclass selectors refuse a sweep mesh as the
    binary one does, and accept the other selector options."""
    from transmogrifai_tpu_torch.selector.model_selector import \
        MultiClassificationModelSelector

    with pytest.raises(NotImplementedError):
        ModelSelector([], problem_type="forecast")
    # parallel="auto" is accepted, and resolves at fit time
    # (tests/test_torch_tuning.py)
    for kw in (dict(parallel=object()),):
        with pytest.raises(NotImplementedError):
            MultiClassificationModelSelector.with_cross_validation(**kw)
        with pytest.raises(NotImplementedError):
            MultiClassificationModelSelector.with_train_validation_split(**kw)
        with pytest.raises(NotImplementedError):
            RegressionModelSelector.with_cross_validation(**kw)
        with pytest.raises(NotImplementedError):
            RegressionModelSelector.with_train_validation_split(**kw)
    for kw in (dict(parallelism=8), dict(max_wait=1.0), dict(parallel=1),
               dict(strategy="halving"), dict(watchdog=2.0),
               dict(parallel="auto")):
        for make in (RegressionModelSelector.with_cross_validation,
                     RegressionModelSelector.with_train_validation_split,
                     MultiClassificationModelSelector.with_cross_validation):
            make(**kw)
    sel = RegressionModelSelector.with_cross_validation()
    assert sel.validation_metric == "RootMeanSquaredError"
    assert not sel.larger_better and not sel.validator.stratify
    assert [type(p).__name__ for p, _ in sel.models_and_params] == [
        "OpLinearRegression", "OpRandomForestRegressor", "OpGBTRegressor"]
    assert [len(g) for _, g in sel.models_and_params] == [8, 18, 3]


_ISOLATED = r"""
import sys
for k in [k for k in sys.modules if k == "jax" or k.startswith("jax.")]:
    del sys.modules[k]
sys.modules["jax"] = None
sys.modules["transmogrifai_tpu"] = None
import numpy as np, torch
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.models.regression import OpLinearRegression
from transmogrifai_tpu_torch.models.trees import (OpGBTRegressor,
                                                  OpRandomForestRegressor)
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.selector.model_selector import (
    RegressionModelSelector, grid)
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                   FeatureColumn)
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow
rng = np.random.default_rng(0)
X = rng.normal(size=(600, 4))
k = rng.integers(0, 5, 600).astype(np.float64)
y = 20 + 3 * X[:, 0] + k + rng.normal(size=600)
data = ColumnarDataset(
    {**{f"x{j}": FeatureColumn.from_values(ft.Real, X[:, j])
        for j in range(4)},
     "k": FeatureColumn.from_values(ft.Integral, k),
     "label": FeatureColumn.from_values(ft.RealNN, y)})
label = FeatureBuilder.RealNN("label").as_response()
vec = transmogrify([FeatureBuilder.Real(f"x{j}").as_predictor()
                    for j in range(4)] + [FeatureBuilder.Integral("k")
                                          .as_predictor()])
sel = RegressionModelSelector.with_train_validation_split(
    models_and_parameters=[
        (OpLinearRegression(), grid(reg_param=[0.01])),
        (OpRandomForestRegressor(), grid(num_trees=[2], max_depth=[3])),
        (OpGBTRegressor(), grid(max_depth=[2], max_iter=[3]))])
pred = label.transform_with(sel, vec)
wf = OpWorkflow(device="cpu").set_result_features(pred).set_input_data(data)
m = wf.train()
_, metrics = m.score_and_evaluate(Evaluators.Regression.r2(), data=data)
assert metrics["R2"] > 0.5, metrics
assert len(sel.metadata["model_selector_summary"]["validationResults"]) == 3
assert not any(k == "jax" or k.startswith(("jax.", "transmogrifai_tpu."))
               for k, v in sys.modules.items() if v is not None)
if not torch.cuda.is_available():
    try:
        OpWorkflow().set_result_features(pred).set_input_data(data).train()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("the regression train ran without a card")
print("OK")
"""


def test_regression_path_runs_with_jax_blocked():
    """The regression path imports nothing of JAX, and its train raises
    without a card unless asked for the CPU."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _ISOLATED],
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")
