"""The workflow, evaluator and selector API that the reference's apps
call, in the port against the JAX package on the CPU, on numpy-seeded
data.

Held here: ``OpWorkflow.set_reader``, ``set_parameters`` (by stage uid
and by class name), ``with_model_stages`` (a warm start fits nothing it
was given), ``compute_data_up_to``, ``OpWorkflowModel.get_fitted_stage``;
every evaluator factory (the default metric, its direction and the
metric set, values within 1e-6: float64 sums in another order),
``OpBinScoreEvaluator`` (bin counts exactly), ``OpForecastEvaluator``,
the multiclass evaluator's ``top_ns`` / ``thresholds`` (counts exactly);
``ModelSelector(holdout_evaluators=)`` (each evaluator's set on the
holdout rows, equal to the evaluator run on the scored holdout);
``RandomParamBuilder`` (the JAX package's draws from one seed exactly);
``ColumnarDataset.from_pandas`` / ``to_pandas``; the testkit's builder and
generators (the JAX package's values from the same seeds).
"""
import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JEvaluators
from transmogrifai_tpu.evaluators.evaluators import \
    OpBinScoreEvaluator as JBinScore
from transmogrifai_tpu.evaluators.evaluators import \
    OpForecastEvaluator as JForecast
from transmogrifai_tpu.evaluators.evaluators import \
    OpMultiClassificationEvaluator as JMulti
from transmogrifai_tpu.models.prediction import \
    PredictionBatch as JPredictionBatch
from transmogrifai_tpu.selector.model_selector import \
    RandomParamBuilder as JRandomParamBuilder
from transmogrifai_tpu.testkit import generators as jgen
from transmogrifai_tpu.testkit import TestFeatureBuilder as JTestFeatureBuilder
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import ColumnarDataset as JDataset
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu_torch.evaluators import (Evaluators,
                                                OpBinScoreEvaluator,
                                                OpForecastEvaluator,
                                                OpMultiClassificationEvaluator)
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.models.classification import \
    OpLogisticRegression
from transmogrifai_tpu_torch.models.prediction import PredictionBatch
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.readers import RecordsReader
from transmogrifai_tpu_torch.selector import (
    BinaryClassificationModelSelector, RandomParamBuilder, grid)
from transmogrifai_tpu_torch.testkit import generators as tgen
from transmogrifai_tpu_torch.testkit import TestFeatureBuilder
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import ColumnarDataset, FeatureColumn
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

N = 600


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


def _frame(n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    y = (X[:, 0] - X[:, 1] + 0.7 * rng.normal(size=n) > 0).astype(float)
    return X, y


def _records(X, y):
    return [{"x0": float(a), "x1": float(b), "x2": float(c),
             "label": float(t)} for (a, b, c), t in zip(X, y)]


def _dag():
    label = FeatureBuilder.RealNN("label").as_response()
    vec = transmogrify([FeatureBuilder.Real(f"x{j}").as_predictor()
                        for j in range(3)])
    checked = SanityChecker(max_correlation=0.99).set_input(
        label, vec).get_output()
    lr = OpLogisticRegression(reg_param=0.5)
    pred = lr.set_input(label, checked).get_output()
    return label, vec, checked, lr, pred


# ---------------------------------------------------------------------------
# the workflow API
# ---------------------------------------------------------------------------

def test_set_reader_parameters_and_fitted_stage():
    X, y = _frame()
    label, vec, checked, lr, pred = _dag()
    wf = OpWorkflow().set_result_features(pred).set_reader(
        RecordsReader(_records(X, y)))
    assert isinstance(wf.reader, RecordsReader)
    wf.set_parameters({lr.uid: {"reg_param": 0.0},
                       "SanityChecker": {"max_correlation": 0.9}})
    model = wf.train()
    assert lr.reg_param == 0.0
    assert checked.origin_stage.max_correlation == 0.9
    fitted = model.get_fitted_stage("LogisticRegressionModel")
    assert model.get_fitted_stage(lr.uid) is fitted
    assert model.get_fitted_stage("SanityCheckerModel").uid == \
        checked.origin_stage.uid
    with pytest.raises(KeyError):
        model.get_fitted_stage("NoSuchStage")
    with pytest.raises(ValueError, match="no param 'nope'"):
        OpWorkflow().set_result_features(pred).set_reader(
            RecordsReader(_records(X, y))).set_parameters(
            {"OpLogisticRegression": {"nope": 1}}).train()
    # the unregularized fit against a fresh one at the same param
    ref = OpLogisticRegression(reg_param=0.0).fit_raw(
        model.train_data[checked.name].values, y)
    assert torch.allclose(fitted.coef, ref.coef, atol=1e-6)
    with pytest.raises(TypeError):
        OpWorkflow().set_reader(42)


def test_with_model_stages_fits_nothing_given():
    X, y = _frame()
    label, vec, checked, lr, pred = _dag()
    first = OpWorkflow().set_result_features(pred).set_input_data(
        ColumnarDataset({**{f"x{j}": FeatureColumn.from_values(
            ft.Real, X[:, j]) for j in range(3)},
            "label": FeatureColumn.from_values(ft.RealNN, y)})).train()
    calls = []
    for est in (lr, checked.origin_stage):
        orig = est.fit

        def spy(data, orig=orig, est=est):
            calls.append(type(est).__name__)
            return orig(data)
        est.fit = spy
    X2, y2 = _frame(seed=1)
    warm = OpWorkflow().set_result_features(pred).with_model_stages(
        first).set_reader(RecordsReader(_records(X2, y2))).train()
    assert calls == []
    for uid in (lr.uid, checked.origin_stage.uid):
        assert warm.get_fitted_stage(uid) is first.get_fitted_stage(uid)
    cold = OpWorkflow().set_result_features(pred).set_reader(
        RecordsReader(_records(X2, y2))).train()
    assert sorted(calls) == ["OpLogisticRegression", "SanityChecker"]
    assert not torch.equal(cold.get_fitted_stage(lr.uid).coef,
                           first.get_fitted_stage(lr.uid).coef)


def test_compute_data_up_to():
    X, y = _frame()
    label, vec, checked, lr, pred = _dag()
    wf = OpWorkflow().set_result_features(pred)
    data = wf.compute_data_up_to(checked, _records(X, y))
    assert checked.name in data and vec.name in data
    assert pred.name not in data
    model = OpWorkflow().set_result_features(pred).set_input_data(
        _records(X, y)).train()
    assert torch.equal(data[checked.name].values,
                       model.train_data[checked.name].values)


# ---------------------------------------------------------------------------
# evaluators
# ---------------------------------------------------------------------------

def _scored(port, K, n=400, seed=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, max(K, 2), n).astype(np.float64)
    if K:
        raw = rng.normal(size=(n, K)) + 1.5 * np.eye(K)[y.astype(int)]
        proba = np.exp(raw) / np.exp(raw).sum(1, keepdims=True)
        pred = proba.argmax(1).astype(np.float64)
    else:
        y = rng.normal(size=n).cumsum()
        pred, raw, proba = y + rng.normal(size=n), None, None
    if port:
        t = (lambda a: None if a is None else torch.from_numpy(a))
        col = FeatureColumn(ft.Prediction, PredictionBatch(t(pred), t(raw),
                                                           t(proba)))
        return ColumnarDataset({"y": FeatureColumn.from_values(ft.RealNN, y),
                                "p": col})
    col = JColumn(jft.Prediction, JPredictionBatch(pred, raw, proba))
    return JDataset({"y": JColumn.from_values(jft.RealNN, y), "p": col})


def _same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _same(got[k], v)
        elif isinstance(v, (list, tuple)) or np.ndim(v):
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(v, np.float64), rtol=1e-6,
                                       atol=1e-9, err_msg=k)
        else:
            assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k


FACTORIES = [("BinaryClassification", f, 2) for f in
             ("auPR", "auROC", "precision", "recall", "f1", "error",
              "brierScore")] + \
    [("MultiClassification", f, 3) for f in ("f1", "precision", "recall",
                                             "error")] + \
    [("Regression", f, 0) for f in ("rmse", "mse", "mae", "r2")]


@pytest.mark.parametrize("family,factory,K", FACTORIES)
def test_evaluator_factories_match_jax(family, factory, K):
    t = getattr(getattr(Evaluators, family), factory)()
    j = getattr(getattr(JEvaluators, family), factory)()
    assert (t.default_metric, t.larger_better) == (j.default_metric,
                                                   j.larger_better)
    for ev in (t, j):
        ev.label_col, ev.prediction_col = "y", "p"
    got, want = t.evaluate(_scored(True, K)), j.evaluate(_scored(False, K))
    _same(got, want)
    assert t.evaluate_default(_scored(True, K)) == pytest.approx(
        want[j.default_metric], rel=1e-6)


def test_custom_binary_evaluator():
    def frac_above(y, s):
        return float(np.mean((s > 0.5) == (y > 0.5)))
    t = Evaluators.BinaryClassification.custom("Hits", True, frac_above)
    j = JEvaluators.BinaryClassification.custom("Hits", True, frac_above)
    for ev in (t, j):
        ev.label_col, ev.prediction_col = "y", "p"
    assert t.evaluate(_scored(True, 2)) == j.evaluate(_scored(False, 2))
    assert (t.default_metric, t.larger_better) == ("Hits", True)


@pytest.mark.parametrize("bins", [10, 100])
def test_bin_score_evaluator(bins):
    t = OpBinScoreEvaluator("y", "p", num_bins=bins)
    j = JBinScore("y", "p", num_bins=bins)
    got, want = t.evaluate(_scored(True, 2)), j.evaluate(_scored(False, 2))
    assert got["numberOfDataPoints"] == want["numberOfDataPoints"]
    _same(got, want)
    assert t.larger_better is False and t.default_metric == "BrierScore"


@pytest.mark.parametrize("period", [1, 4, 1000])
def test_forecast_evaluator(period):
    t = OpForecastEvaluator("y", "p", seasonal_period=period)
    j = JForecast("y", "p", seasonal_period=period)
    got, want = t.evaluate(_scored(True, 0)), j.evaluate(_scored(False, 0))
    assert set(got) == {"SMAPE", "MASE"}
    if period >= 400:
        assert np.isnan(got["MASE"]) and np.isnan(want["MASE"])
        got.pop("MASE"), want.pop("MASE")
    _same(got, want)


@pytest.mark.parametrize("top_ns,thresholds", [
    ((1, 3), None), ((2,), [0.0, 0.25, 0.5, 0.9]), ((1, 2, 5), [0.3])])
def test_multiclass_top_ns_and_thresholds(top_ns, thresholds):
    t = OpMultiClassificationEvaluator("y", "p", top_ns=top_ns,
                                       thresholds=thresholds)
    j = JMulti("y", "p", top_ns=top_ns, thresholds=thresholds)
    got, want = t.evaluate(_scored(True, 5)), j.evaluate(_scored(False, 5))
    assert got["ThresholdMetrics"] == want["ThresholdMetrics"]
    assert got["ThresholdMetrics"]["topNs"] == list(dict.fromkeys(top_ns))
    _same(got, want)


# ---------------------------------------------------------------------------
# the selector API
# ---------------------------------------------------------------------------

def test_holdout_evaluators():
    X, y = _frame(n=1200)
    label = FeatureBuilder.RealNN("label").as_response()
    vec = transmogrify([FeatureBuilder.Real(f"x{j}").as_predictor()
                        for j in range(3)])
    evs = [Evaluators.BinaryClassification.auROC(), OpBinScoreEvaluator(
        num_bins=10)]
    sel = BinaryClassificationModelSelector.with_cross_validation(
        models_and_parameters=[(OpLogisticRegression(),
                                grid(reg_param=[0.01, 0.1]))])
    sel.holdout_evaluators = evs
    assert sel.copy().holdout_evaluators == evs
    pred = label.transform_with(sel, vec)
    model = OpWorkflow().set_result_features(pred).set_input_data(
        _records(X, y)).train()
    summ = sel.metadata["model_selector_summary"]
    hold = summ["holdoutEvaluation"]
    assert [h["evaluator"] for h in hold] == [
        "OpBinaryClassificationEvaluator", "OpBinScoreEvaluator"]
    assert [h["metricName"] for h in hold] == ["AuROC", "BrierScore"]
    assert hold[0]["metrics"]["AuPR"] == pytest.approx(
        summ["holdoutMetrics"]["AuPR"], rel=1e-12)
    _, hold_idx = sel.splitter.split_indices(len(y), y.astype(np.float32))
    assert sum(hold[1]["metrics"]["numberOfDataPoints"]) == len(hold_idx) > 0
    assert evs[0].label_col is None          # the user's objects untouched
    # without evaluators the summary has the JAX package's keys only
    sel2 = BinaryClassificationModelSelector.with_cross_validation(
        models_and_parameters=[(OpLogisticRegression(), grid(
            reg_param=[0.1]))])
    OpWorkflow().set_result_features(label.transform_with(sel2, vec)) \
        .set_input_data(_records(X, y)).train()
    assert "holdoutEvaluation" not in sel2.metadata["model_selector_summary"]
    assert model.get_fitted_stage(sel.uid).best_name == "OpLogisticRegression"


def test_random_param_builder_draws_the_jax_grid():
    def build(cls):
        return (cls(seed=7).uniform("step_size", 0.01, 0.3)
                .log_uniform("reg_param", 1e-4, 1.0)
                .choice("max_depth", [3, 6, 12]).build(12))
    got, want = build(RandomParamBuilder), build(JRandomParamBuilder)
    assert got == want and len(got) == 12
    assert {type(p["max_depth"]) for p in got} == {int}
    assert all(1e-4 <= p["reg_param"] <= 1.0 for p in got)


# ---------------------------------------------------------------------------
# the pandas bridge and the testkit
# ---------------------------------------------------------------------------

def test_pandas_bridge():
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"a": [1.5, None, 3.0], "b": ["x", None, "z"],
                       "c": [1, 2, 3]})
    schema = {"a": ft.Real, "b": ft.PickList, "c": ft.Integral}
    ds = ColumnarDataset.from_pandas(df, schema)
    jds = JDataset.from_pandas(df, {"a": jft.Real, "b": jft.PickList,
                                    "c": jft.Integral})
    for name in schema:
        assert ds[name].to_list() == jds[name].to_list()
    back = ds.to_pandas()
    assert back.equals(jds.to_pandas())
    assert list(back.columns) == ["a", "b", "c"]


GENERATORS = [
    ("r", "Real", lambda g: g.RandomReal.normal(probability_of_empty=0.2)),
    ("u", "RealNN", lambda g: g.RandomReal.uniform(2.0, 5.0, seed=3)),
    ("q", "Real", lambda g: g.RandomReal.poisson(4.0, seed=5)),
    ("i", "Integral", lambda g: g.RandomIntegral(0, 7, seed=6)),
    ("b", "Binary", lambda g: g.RandomBinary(0.3, seed=8)),
    ("t", "Text", lambda g: g.RandomText(probability_of_empty=0.1, seed=9)),
    ("p", "PickList", lambda g: g.RandomPickList(["a", "b", "c"], seed=10)),
    ("l", "TextList", lambda g: g.RandomList(g.RandomText(seed=1), 0, 3,
                                              seed=11)),
    ("s", "MultiPickList", lambda g: g.RandomSet(
        g.RandomPickList(["u", "v"], seed=2), 0, 3, seed=12)),
    ("m", "RealMap", lambda g: g.RandomMap(g.RandomReal(seed=4),
                                           ["k1", "k2", "k3"], seed=13)),
]


def test_testkit_matches_jax():
    def make(gen, types, builder):
        return builder.random(
            50, *[(name, getattr(types, tname), fn(gen))
                  for name, tname, fn in GENERATORS], response="u")
    ds, feats = make(tgen, ft, TestFeatureBuilder)
    jds, jfeats = make(jgen, jft, JTestFeatureBuilder)
    assert [f.name for f in feats] == [f.name for f in jfeats]
    assert [f.is_response for f in feats] == [f.is_response
                                              for f in jfeats]
    for name, _, _ in GENERATORS:
        assert ds[name].ftype.__name__ == jds[name].ftype.__name__
        assert ds[name].to_list() == jds[name].to_list(), name
    vec = tgen.RandomVector(4, seed=3).take(3)
    jvec = jgen.RandomVector(4, seed=3).take(3)
    assert all(np.array_equal(a, b) for a, b in zip(vec, jvec))
    built, (f,) = TestFeatureBuilder.build(("age", ft.Real, [1, None, 3]))
    assert built["age"].to_list() == [1.0, None, 3.0]
    assert f.name == "age" and not f.is_response
