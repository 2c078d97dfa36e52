"""The port's binary model selector against the JAX package, end to end on
the CPU.

FeatureBuilder -> transmogrify -> SanityChecker ->
BinaryClassificationModelSelector.with_cross_validation() (3 folds, a
reduced LR + RF grid) -> OpWorkflow.train -> score_and_evaluate(AuPR), on
the same numpy-seeded data in both packages.  The port's forests draw the
JAX package's bags and feature subsets (``rf_bags_and_features`` is
patched to return them), and the weights are integers (a balanced label:
no DataBalancer up-weighting), so every histogram sum is exact and the
forests are identical.  Tolerances: the winner and the splitter's
summary equal; RF CV metrics within 1e-6 (the JAX metric sums in float32,
the port's in float64); LR CV metrics within 1e-4 (an iterative float32
solve whose products sum in another order); holdout AuPR within 1e-5.
``test_balancer_weights_regime`` holds the fractional-weight regime to
its own, stated tolerances.
"""
import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.evaluators import metrics as jm
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JEvaluators
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models import gbdt_kernels as jg
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
from transmogrifai_tpu.models.trees import OpRandomForestClassifier as JRF
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JSanityChecker
from transmogrifai_tpu.selector.model_selector import \
    BinaryClassificationModelSelector as JBCMS
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import ColumnarDataset as JDataset
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch.evaluators import metrics as tm
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.models.classification import \
    OpLogisticRegression
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, grid)
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import ColumnarDataset, FeatureColumn
from transmogrifai_tpu_torch.workflow.dag import compute_dag
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

N_REAL = 12
LR_GRID = dict(reg_param=[0.001, 0.1], elastic_net_param=[0.0, 0.5],
               max_iter=[50])
RF_GRID = dict(num_trees=[5], max_depth=[3, 6],
               min_instances_per_node=[10, 100],
               min_info_gain=[0.001, 0.01])


def _make(n, seed):
    """12 Real columns (some NaN), one PickList, a binary label with signal
    on a few reals and the category; column 7 leaks the label."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, N_REAL))
    X[rng.random((n, N_REAL)) < 0.08] = np.nan
    X[:, 9] = np.where(rng.random(n) < 0.5, np.nan, X[:, 9])
    cat = rng.choice(np.array(["red", "green", "blue", "teal", None],
                              dtype=object), size=n,
                     p=[0.4, 0.3, 0.15, 0.1, 0.05])
    z = (1.2 * np.nan_to_num(X[:, 0]) - 0.8 * np.nan_to_num(X[:, 3])
         + 0.6 * (cat == "red") + np.abs(np.nan_to_num(X[:, 5]))
         + 0.8 * rng.normal(size=n))
    y = (z > 0.8).astype(np.float64)
    X[:, 7] = y + 0.01 * rng.normal(size=n)
    return X, list(cat), y


def _dataset(cls_ds, cls_col, types, X, cat, y):
    cols = {f"x{j}": cls_col.from_values(types.Real, X[:, j])
            for j in range(N_REAL)}
    cols["color"] = cls_col.from_values(types.PickList, cat)
    cols["label"] = cls_col.from_values(types.RealNN, y)
    return cls_ds(cols)


def _pipeline(fb, transmogrify_fn, checker_cls, selector):
    label = fb.RealNN("label").as_response()
    preds = ([fb.Real(f"x{j}").as_predictor() for j in range(N_REAL)]
             + [fb.PickList("color").as_predictor()])
    checked = label.transform_with(checker_cls(max_correlation=0.99),
                                   transmogrify_fn(preds))
    return label.transform_with(selector, checked)


def _models(lr_cls, rf_cls, lr_grid=LR_GRID, rf_grid=RF_GRID, grid_fn=None):
    from transmogrifai_tpu.selector.model_selector import grid as jgrid

    g = grid_fn or jgrid
    out = []
    if lr_grid:
        out.append((lr_cls(), g(**lr_grid)))
    if rf_grid:
        out.append((rf_cls(), g(**rf_grid)))
    return out


@pytest.fixture(scope="module")
def data():
    return _make(3000, 31), _make(1000, 32)


def _jax_fit(data, lr_grid=LR_GRID, rf_grid=RF_GRID):
    train, hold = data
    sel = JBCMS.with_cross_validation(
        models_and_parameters=_models(JLR, JRF, lr_grid, rf_grid))
    pred = _pipeline(JFB, jtransmogrify, JSanityChecker, sel)
    with pytest.MonkeyPatch.context() as mp:
        # keep the JAX train from appending to benchmarks/cost_history.json
        mp.setenv("TMOG_COST_HISTORY", "0")
        mp.setenv("TMOG_SYNC_SWEEP", "1")
        model = JWorkflow().set_result_features(pred).set_input_data(
            _dataset(JDataset, JColumn, jft, *train)).train()
    scored, metrics = model.score_and_evaluate(
        JEvaluators.BinaryClassification.auPR(),
        data=_dataset(JDataset, JColumn, jft, *hold))
    return dict(model=model, pred=pred, selector=sel, scored=scored,
                metrics=metrics)


def _jax_bags(seed, n_trees, n, d, msub, subsample_rate, device):
    """The JAX package's bags and feature subsets, as the port's tensors."""
    bw, idx = jg.rf_bags_and_features(seed, n_trees, n, d, msub,
                                      subsample_rate)
    return (torch.from_numpy(np.array(bw)).to(device),
            torch.from_numpy(np.array(idx)).long().to(device))


@pytest.fixture(scope="module")
def jax_run(data):
    return _jax_fit(data)


@pytest.fixture(scope="module")
def torch_run(data):
    tt.set_device("cpu")
    train, hold = data
    sel = BinaryClassificationModelSelector.with_cross_validation(
        models_and_parameters=_models(OpLogisticRegression,
                                      OpRandomForestClassifier,
                                      grid_fn=grid))
    pred = _pipeline(FeatureBuilder, transmogrify, SanityChecker, sel)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tk, "rf_bags_and_features", _jax_bags)
        model = OpWorkflow().set_result_features(pred).set_input_data(
            _dataset(ColumnarDataset, FeatureColumn, ft, *train)).train()
    scored, metrics = model.score_and_evaluate(
        Evaluators.BinaryClassification.auPR(),
        data=_dataset(ColumnarDataset, FeatureColumn, ft, *hold))
    return dict(model=model, pred=pred, selector=sel, scored=scored,
                metrics=metrics)


def _summary(run):
    return run["selector"].metadata["model_selector_summary"]


class TestSelectorParity:
    def test_summary_keys_and_splitter(self, jax_run, torch_run):
        j, t = _summary(jax_run), _summary(torch_run)
        assert set(t) == set(j)
        assert t["validationType"] == j["validationType"]
        assert t["problemType"] == j["problemType"] == "binary"
        assert t["dataPrepResults"] == j["dataPrepResults"]
        assert len(t["validationResults"]) == len(j["validationResults"])
        assert not any("error" in r for r in t["validationResults"])

    def test_same_winner(self, jax_run, torch_run):
        j, t = _summary(jax_run), _summary(torch_run)
        assert t["bestModelType"] == j["bestModelType"]
        assert t["bestModelParams"] == j["bestModelParams"]

    def test_cv_metrics(self, jax_run, torch_run):
        jr = _summary(jax_run)["validationResults"]
        tr = _summary(torch_run)["validationResults"]
        for a, b in zip(tr, jr):
            assert (a["modelType"], a["params"]) == (b["modelType"],
                                                    b["params"])
            tol = 1e-6 if a["modelType"] == "OpRandomForestClassifier" \
                else 1e-4
            np.testing.assert_allclose(a["foldValues"], b["foldValues"],
                                       rtol=0, atol=tol)
            assert abs(a["metricValue"] - b["metricValue"]) <= tol

    def test_holdout_and_train_metrics(self, jax_run, torch_run):
        j, t = _summary(jax_run), _summary(torch_run)
        for key in ("holdoutMetrics", "trainEvaluationMetrics"):
            assert set(t[key]) == set(j[key])
            for m, v in j[key].items():
                assert t[key][m] == pytest.approx(v, rel=1e-4, abs=1e-5), \
                    (key, m)

    def test_holdout_scores_and_aupr(self, jax_run, torch_run):
        jp = jax_run["scored"][jax_run["pred"].name].values.probability
        tp = torch_run["scored"][torch_run["pred"].name].values.probability
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-5)
        assert abs(torch_run["metrics"]["AuPR"]
                   - jax_run["metrics"]["AuPR"]) <= 1e-5
        assert torch_run["metrics"]["AuPR"] > 0.6

    def test_sweep_bookkeeping(self, torch_run):
        meta = torch_run["selector"].metadata
        # 4 (min_info_gain, min_instances) bases x 3 folds x 5 trees, plus
        # the winner's refit when a forest wins
        rf_won = _summary(torch_run)["bestModelType"] == \
            "OpRandomForestClassifier"
        assert meta["rf_trees"] == 60 + (5 if rf_won else 0)
        assert meta["hist_levels"] > 0
        assert {"LogRegGridGroup", "RFGridGroup"} <= set(
            meta["sweep_seconds"])
        assert meta["group_errors"] == {}


def test_failed_group_is_recorded():
    """A group that raises leaves its members to sequential fits, and its
    exception on ``group.error``; a declining group records nothing."""
    from transmogrifai_tpu_torch.selector.grid_groups import GridGroup
    from transmogrifai_tpu_torch.selector.validators import OpCrossValidation

    class Failing(GridGroup):
        def run(self, X, y, weight_ctxs):
            raise MemoryError("out of device memory")

    class Declining(GridGroup):
        def run(self, X, y, weight_ctxs):
            return None

    def fitter(X, y, w, p):
        return lambda Xe: Xe[:, 0] * p["sign"]

    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.normal(size=(200, 2)).astype(np.float32))
    y = (X[:, 0].numpy() > 0).astype(np.float32)
    pts = [{"sign": 1.0}, {"sign": -1.0}]
    failing, declining = Failing(None, pts, "AuPR"), Declining(None, pts,
                                                               "AuPR")
    cands = ([("a", p, fitter, failing) for p in pts]
             + [("b", p, fitter, declining) for p in pts])
    with pytest.warns(RuntimeWarning, match="Failing failed"):
        best, results = OpCrossValidation(num_folds=2, stratify=True).validate(
            cands, X, y, np.ones(len(y)),
            eval_fn=lambda yy, s, w: tm.aupr_device(torch.from_numpy(yy), s,
                                                    torch.from_numpy(w)),
            metric_name="AuPR")
    assert failing.error == "MemoryError: out of device memory"
    assert declining.error is None
    assert [r.error for r in results] == [None] * 4
    assert results[0].metric_value == pytest.approx(1.0)
    assert best in (0, 2)


@pytest.mark.parametrize("ties", [7, 1000])
def test_binary_metrics_match_jax(ties):
    """The port's device metrics against the JAX package's host ones, on
    weighted scores with ties (1e-12: both sum in float64)."""
    rng = np.random.default_rng(ties)
    y = (rng.random(2000) < 0.3).astype(np.float32)
    s = (np.floor(rng.random(2000) * ties) / ties * 0.9 + 0.1 * y
         ).astype(np.float32)
    w = rng.integers(0, 3, 2000).astype(np.float32)
    ty, ts, tw = (torch.from_numpy(a) for a in (y, s, w))
    assert abs(tm.auroc(ty, ts, tw) - jm.auroc(y, s, w)) <= 1e-12
    assert abs(tm.aupr(ty, ts, tw) - jm.aupr(y, s, w)) <= 1e-12
    got = tm.binary_classification_metrics(ty, ts, tw, threshold=0.4)
    want = jm.binary_classification_metrics(y, s, w, threshold=0.4)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k


def test_metric_grid_matches_jax():
    """(F, C, N) scores and (F, N) weights -> (F, C) metrics: the JAX
    grid's float32 sums against the port's float64 ones (1e-6)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    y = (rng.random(1500) < 0.4).astype(np.float32)
    S = rng.random((3, 4, 1500)).astype(np.float32)
    W = (rng.random((3, 1500)) < 0.3).astype(np.float32)
    for metric in ("AuPR", "AuROC"):
        want = np.asarray(jm.binary_metric_grid(
            jnp.asarray(y), jnp.asarray(S), jnp.asarray(W), metric))
        got = tm.binary_metric_grid(torch.from_numpy(y), torch.from_numpy(S),
                                    torch.from_numpy(W), metric)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert tm.binary_metric_grid(torch.from_numpy(y), torch.from_numpy(S),
                                 torch.from_numpy(W), "F1") is None


@pytest.mark.parametrize("family", ["lr", "rf"])
def test_single_family_refit_and_convert(data, family):
    """A selector whose only family is ``family``, so that family wins:
    the port's train (its group's full-train refit) and the JAX selector
    carried into the port both score the holdout to the JAX package's
    probabilities (1e-5)."""
    tt.set_device("cpu")
    lr_grid = dict(reg_param=[0.01, 0.1], max_iter=[50]) \
        if family == "lr" else None
    rf_grid = dict(num_trees=[3], max_depth=[2, 4]) if family == "rf" \
        else None
    jr = _jax_fit(data, lr_grid, rf_grid)
    jm_ = jr["model"]
    want = np.asarray(jr["scored"][jr["pred"].name].values.probability)
    hold = _dataset(ColumnarDataset, FeatureColumn, ft, *data[1])

    sel = BinaryClassificationModelSelector.with_cross_validation(
        models_and_parameters=_models(OpLogisticRegression,
                                      OpRandomForestClassifier, lr_grid,
                                      rf_grid, grid_fn=grid))
    pred = _pipeline(FeatureBuilder, transmogrify, SanityChecker, sel)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tk, "rf_bags_and_features", _jax_bags)
        trained = OpWorkflow().set_result_features(pred).set_input_data(
            _dataset(ColumnarDataset, FeatureColumn, ft, *data[0])).train()
    assert (sel.metadata["model_selector_summary"]["bestModelParams"]
            == jr["selector"].metadata["model_selector_summary"][
                "bestModelParams"])
    got = trained.score(hold)[pred.name].values.probability.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    def stage(name):
        return next(s for s in jm_.stages if type(s).__name__ == name)

    sel = BinaryClassificationModelSelector.with_cross_validation(
        models_and_parameters=_models(OpLogisticRegression,
                                      OpRandomForestClassifier, lr_grid,
                                      rf_grid, grid_fn=grid))
    pred = _pipeline(FeatureBuilder, transmogrify, SanityChecker, sel)
    ests = {type(s).__name__: s for s in compute_dag([pred]).all_stages()}
    js, jsel = stage("SanityCheckerModel"), stage("SelectedModel")
    inner = jsel.inner
    if family == "lr":
        model = convert.logistic_regression_model(np.asarray(inner.coef),
                                                  inner.intercept)
    else:
        model = convert.tree_ensemble_model(
            inner.mode, np.asarray(inner.edges), np.asarray(inner.feat),
            np.asarray(inner.thresh), np.asarray(inner.leaf),
            inner.base_score, inner.n_classes)
    summary = jr["selector"].metadata["model_selector_summary"]
    fitted = [
        convert.real_vectorizer(ests["RealVectorizer"],
                                list(stage("RealVectorizerModel").fills)),
        convert.one_hot_vectorizer(
            ests["OneHotVectorizer"],
            [list(v) for v in stage("OneHotVectorizerModel").vocabs]),
        convert.sanity_checker(ests["SanityChecker"], list(js.keep_indices)),
        convert.selected_model(sel, model, jsel.best_name, jsel.best_params,
                               summary),
    ]
    scored = convert.workflow_model([pred], fitted).score(hold)
    got = scored[pred.name].values.probability.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert sel.metadata["model_selector_summary"] is summary


def test_balancer_weights_regime():
    """A rare positive class (4%): the DataBalancer up-weights it by a
    fractional factor, so fold and bag weights are no longer integers and
    float32 sums taken in another order can reorder splits whose gains
    nearly tie.  Same winner, LR CV metrics within 1e-4, RF CV metrics
    within 1e-3 (most agree to 1e-7; on these inputs a near-tie moves
    one by about 1e-4), holdout probabilities within 1e-5."""
    def make(n, seed):
        X, cat, y = _make(n, seed)
        rng = np.random.default_rng(seed + 100)
        y = np.where((y == 1) & (rng.random(n) < 0.93), 0.0, y)
        X[:, 7] = y + 0.01 * rng.normal(size=n)
        return X, cat, y

    tt.set_device("cpu")
    data = (make(3000, 41), make(1000, 42))
    jr = _jax_fit(data)
    sel = BinaryClassificationModelSelector.with_cross_validation(
        models_and_parameters=_models(OpLogisticRegression,
                                      OpRandomForestClassifier,
                                      grid_fn=grid))
    pred = _pipeline(FeatureBuilder, transmogrify, SanityChecker, sel)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tk, "rf_bags_and_features", _jax_bags)
        model = OpWorkflow().set_result_features(pred).set_input_data(
            _dataset(ColumnarDataset, FeatureColumn, ft, *data[0])).train()
    j, t = _summary(jr), sel.metadata["model_selector_summary"]
    assert "upSamplingFraction" in t["dataPrepResults"]
    assert t["dataPrepResults"] == j["dataPrepResults"]
    assert (t["bestModelType"], t["bestModelParams"]) == (
        j["bestModelType"], j["bestModelParams"])
    for a, b in zip(t["validationResults"], j["validationResults"]):
        tol = 1e-3 if a["modelType"] == "OpRandomForestClassifier" else 1e-4
        assert abs(a["metricValue"] - b["metricValue"]) <= tol, a["params"]
    got = model.score(_dataset(ColumnarDataset, FeatureColumn, ft,
                               *data[1]))[pred.name].values.probability
    want = jr["scored"][jr["pred"].name].values.probability
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_dropped_options_raise(monkeypatch):
    """What the port's selector still leaves out raises, naming its
    ROADMAP item; the selector options it has are accepted and kept."""
    from transmogrifai_tpu_torch.selector.model_selector import ModelSelector
    from transmogrifai_tpu_torch.selector.validators import OpCrossValidation

    mk = BinaryClassificationModelSelector.with_cross_validation
    for kw in (dict(max_wait=10.0), dict(strategy="halving"),
               dict(parallel=1), dict(parallel=2), dict(watchdog=3.0),
               dict(parallelism=8)):
        sel = mk(**kw)
        for k, v in kw.items():
            assert getattr(sel, k, getattr(sel.validator, k, None)) == v
    assert mk().validator.parallelism == 8
    # "auto" is resolved by the cost planner at fit time
    assert mk(parallel="auto").parallel == "auto"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 6.7"):
        mk(parallel=2)
    assert mk(parallel=1).parallel == 1
    monkeypatch.undo()
    with pytest.raises(ValueError):
        mk(strategy="fastest")
    cv = OpCrossValidation(max_wait=1.0, parallelism=4)
    assert (cv.max_wait, cv.parallelism) == (1.0, 4)
    with pytest.raises(NotImplementedError):
        ModelSelector([], problem_type="forecast")
    sel = mk()
    with pytest.raises(NotImplementedError, match="item 6.7"):
        sel.with_mesh(None)
    assert sel.with_watchdog(2.0) is sel and sel.watchdog == 2.0
    assert sel.with_sweep_checkpoint("ckpt") is sel
    assert sel.sweep_checkpoint_dir == "ckpt"


_ISOLATED = r"""
import sys
for k in [k for k in sys.modules if k == "jax" or k.startswith("jax.")]:
    del sys.modules[k]
sys.modules["jax"] = None
sys.modules["transmogrifai_tpu"] = None
import numpy as np, torch
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.models.classification import OpLogisticRegression
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, grid)
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                   FeatureColumn)
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow
rng = np.random.default_rng(0)
X = rng.normal(size=(600, 4))
y = (X[:, 0] + 0.3 * rng.normal(size=600) > 0).astype(np.float64)
data = ColumnarDataset(
    {**{f"x{j}": FeatureColumn.from_values(ft.Real, X[:, j])
        for j in range(4)},
     "label": FeatureColumn.from_values(ft.RealNN, y)})
label = FeatureBuilder.RealNN("label").as_response()
vec = transmogrify([FeatureBuilder.Real(f"x{j}").as_predictor()
                    for j in range(4)])
sel = BinaryClassificationModelSelector.with_cross_validation(
    models_and_parameters=[
        (OpLogisticRegression(), grid(reg_param=[0.01])),
        (OpRandomForestClassifier(), grid(num_trees=[2], max_depth=[3]))])
pred = label.transform_with(sel, vec)
wf = OpWorkflow(device="cpu").set_result_features(pred).set_input_data(data)
m = wf.train()
assert m.score(data)[pred.name].values.probability.shape == (600, 2)
assert len(sel.metadata["model_selector_summary"]["validationResults"]) == 2
assert not any(k == "jax" or k.startswith(("jax.", "transmogrifai_tpu."))
               for k, v in sys.modules.items() if v is not None)
if not torch.cuda.is_available():
    Xf = X.astype(np.float32)
    for call in (lambda: OpLogisticRegression().fit_raw(Xf, y),
                 lambda: OpRandomForestClassifier().fit_raw(Xf, y),
                 lambda: OpWorkflow().set_result_features(pred)
                 .set_input_data(data).train()):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("entry point ran without a card")
print("OK")
"""


def test_selector_runs_with_jax_blocked():
    """The selector path imports nothing of JAX, and its entry points
    raise without a card unless asked for the CPU."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _ISOLATED],
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")
