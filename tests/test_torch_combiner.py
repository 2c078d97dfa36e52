"""The port's SelectedModelCombiner and the reference's Avro ensemble demo
against the JAX package on the CPU.

Held here:
 * the combination rules on summaries made in this file, through both
   packages' ``fit_columns``: ``best``, ``weighted`` (direction-corrected:
   for a metric to minimize the smaller value takes the larger weight; a
   negative R2 clamped at 0) and ``equal``; metrics resolved through the
   other selector's training metrics where the validation metrics differ;
   the refusals (non-overlapping metrics, different problem types,
   heads of different widths).  Weights and the ``combiner`` record are
   equal exactly (the same float arithmetic on the same inputs); the
   blend's training metrics within 1e-6 (float64 sums in another order).
 * ``examples/op_titanic_avro_combined.py``'s DAG end to end on 900
   Titanic-shaped rows written to Avro by the port's ``write_avro`` and
   read in each package by its own ``AvroReader``, the port's forests
   growing on the JAX package's bags and its MLP starting from the JAX
   package's weights: the same winners, weights within 1e-6, the three
   predictions' holdout probabilities within 1e-4 (a forest's float32
   mean over trees in another order; the MLP's Adam steps), the blend's
   training metrics within 1e-4; a save and load in either package.
"""
import itertools
import os

import numpy as np
import pytest
import torch

import jax
import chip_smoke
import transmogrifai_tpu.utils.uid as juid
import transmogrifai_tpu_torch as tt
import transmogrifai_tpu_torch.utils.uid as tuid
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JEvaluators
from transmogrifai_tpu.models import gbdt_kernels as jg
from transmogrifai_tpu.models import mlp as jmlp
from transmogrifai_tpu.models.prediction import \
    PredictionBatch as JPredictionBatch
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.workflow.workflow import \
    OpWorkflowModel as JWorkflowModel
from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch.evaluators import Evaluators
from transmogrifai_tpu_torch.local import score_function_batch
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.models import mlp as tmlp
from transmogrifai_tpu_torch.models.prediction import PredictionBatch
from transmogrifai_tpu_torch.readers.avro import AvroReader, write_avro
from transmogrifai_tpu_torch.selector.combiner import (SelectedCombinerModel,
                                                       _as_batch)
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import FeatureColumn
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflowModel

ROWS, HOLD = 900, 300


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


def _pkg(port: bool) -> dict:
    """Either package's classes of the demo."""
    if port:
        from transmogrifai_tpu_torch.features.builder import FeatureBuilder
        from transmogrifai_tpu_torch.models import (
            OpLogisticRegression, OpMultilayerPerceptronClassifier,
            OpRandomForestClassifier)
        from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
        from transmogrifai_tpu_torch.preparators.sanity_checker import \
            SanityChecker
        from transmogrifai_tpu_torch.selector import (
            BinaryClassificationModelSelector, RegressionModelSelector,
            SelectedModelCombiner, grid)
        from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow
        reader, uid = AvroReader, tuid
    else:
        from transmogrifai_tpu import FeatureBuilder, OpWorkflow, transmogrify
        from transmogrifai_tpu.models import (
            OpLogisticRegression, OpMultilayerPerceptronClassifier,
            OpRandomForestClassifier)
        from transmogrifai_tpu.preparators import SanityChecker
        from transmogrifai_tpu.readers import AvroReader as reader
        from transmogrifai_tpu.selector import (
            BinaryClassificationModelSelector, RegressionModelSelector,
            SelectedModelCombiner, grid)
        uid = juid
    return dict(fb=FeatureBuilder, wf=OpWorkflow, transmogrify=transmogrify,
                lr=OpLogisticRegression,
                mlp=OpMultilayerPerceptronClassifier,
                rf=OpRandomForestClassifier, checker=SanityChecker,
                bsel=BinaryClassificationModelSelector,
                rsel=RegressionModelSelector,
                comb=SelectedModelCombiner, grid=grid, reader=reader, uid=uid)


# ---------------------------------------------------------------------------
# the combination rules
# ---------------------------------------------------------------------------

def _summary(metric, best, others=(), problem="binary", train=None,
             best_name="OpLogisticRegression"):
    """A selector summary: its winner ``best_name`` validated at ``best``
    under ``metric``, the other candidates at ``others``."""
    rows = [{"modelType": best_name, "params": {"reg_param": 0.1},
             "metricName": metric, "metricValue": best}]
    rows += [{"modelType": "OpRandomForestClassifier",
              "params": {"max_depth": k}, "metricName": metric,
              "metricValue": v} for k, v in enumerate(others)]
    return {"validationType": "OpCrossValidation", "problemType": problem,
            "validationResults": rows, "bestModelType": best_name,
            "bestModelParams": {"reg_param": 0.1},
            "holdoutMetrics": {}, "trainEvaluationMetrics": train or {},
            "dataPrepResults": {"splitter": "DataBalancer"}}


def _batches(port: bool, K: int, seed: int):
    rng = np.random.default_rng(seed)
    n = 64
    if K:
        raw = rng.normal(size=(n, K))
        proba = np.exp(raw) / np.exp(raw).sum(1, keepdims=True)
        pred = proba.argmax(1).astype(np.float64)
    else:
        raw = proba = None
        pred = rng.normal(size=n)
    if port:
        t = (lambda a: None if a is None else torch.from_numpy(a))
        return FeatureColumn(ft.Prediction, PredictionBatch(
            t(pred), t(raw), t(proba)))
    return JColumn(jft.Prediction, JPredictionBatch(pred, raw, proba))


def _fit(port: bool, strategy: str, s1: dict, s2: dict, K: int = 2):
    """Both selectors' summaries set on unfitted selectors, then the
    combiner's ``fit_columns`` on seeded prediction columns: (combiner
    metadata, fitted model)."""
    p = _pkg(port)
    fb = p["fb"]
    label = fb.RealNN("y").as_response()
    vec = fb.OPVector("v").as_predictor()
    sels = []
    for summ in (s1, s2):
        sel = (p["bsel"] if summ["problemType"] != "regression"
               else p["rsel"]).with_cross_validation()
        sel.set_input(label, vec)
        sel.metadata["model_selector_summary"] = summ
        sels.append(sel)
    comb = p["comb"](combination_strategy=strategy).set_input(
        label, sels[0].get_output(), sels[1].get_output())
    y = np.random.default_rng(9).integers(0, max(K, 2), 64).astype(
        np.float64)
    ycol = (FeatureColumn if port else JColumn).from_values(
        (ft if port else jft).RealNN, y)
    model = comb.fit_columns(None, ycol, _batches(port, K, 1),
                             _batches(port, K, 2))
    return comb.metadata, model


CASES = {
    "maximize": (_summary("AuPR", 0.8, (0.7,)), _summary("AuPR", 0.6)),
    "minimize": (_summary("RootMeanSquaredError", 2.0, (2.5,),
                          problem="regression"),
                 _summary("RootMeanSquaredError", 1.0, problem="regression")),
    "negative_r2": (_summary("R2", -0.5, problem="regression"),
                    _summary("R2", 0.4, problem="regression")),
    "through_train_metrics": (
        _summary("AuPR", 0.81),
        _summary("AuROC", 0.9, train={"AuPR": 0.77, "AuROC": 0.91})),
    "winner_not_listed": (
        _summary("AuPR", 0.7, (0.9, 0.8), best_name="OpNaiveBayes"),
        _summary("AuPR", 0.75)),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("strategy", ["best", "weighted", "equal"])
def test_combination_rules_match_jax(case, strategy):
    s1, s2 = CASES[case]
    K = 0 if s1["problemType"] == "regression" else 2
    jmeta, jmodel = _fit(False, strategy, s1, s2, K)
    tmeta, tmodel = _fit(True, strategy, s1, s2, K)
    assert tmeta["combiner"] == jmeta["combiner"]
    assert (tmodel.weight1, tmodel.weight2) == (jmodel.weight1,
                                                jmodel.weight2)
    assert tmodel.get_params() == {**jmodel.get_params()}
    ts, js = (m["model_selector_summary"] for m in (tmeta, jmeta))
    assert set(ts) == set(js)
    for k in ts:
        if k != "trainEvaluationMetrics":
            assert ts[k] == js[k], k
    tm, jm = ts["trainEvaluationMetrics"], js["trainEvaluationMetrics"]
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-6, atol=1e-9)
    if case == "minimize" and strategy == "weighted":
        assert tmodel.weight2 > tmodel.weight1      # RMSE 1.0 beats 2.0
    if case == "negative_r2" and strategy == "weighted":
        assert (tmodel.weight1, tmodel.weight2) == (0.0, 1.0)


@pytest.mark.parametrize("port", [False, True])
def test_combiner_refusals(port):
    with pytest.raises(RuntimeError, match="non-overlapping"):
        _fit(port, "weighted", _summary("AuPR", 0.8),
             _summary("AuROC", 0.9, train={"Error": 0.1}))
    with pytest.raises(RuntimeError, match="different problem types"):
        _fit(port, "best", _summary("AuPR", 0.8),
             _summary("AuPR", 0.8, problem="multiclass"))
    with pytest.raises(ValueError, match="combination_strategy"):
        _pkg(port)["comb"](combination_strategy="stacked")
    model = (SelectedCombinerModel if port else
             __import__("transmogrifai_tpu.selector.combiner", fromlist=[
                 "SelectedCombinerModel"]).SelectedCombinerModel)(0.5, 0.5)
    with pytest.raises(ValueError, match="different shapes"):
        model.transform_columns(None, _batches(port, 2, 1),
                                _batches(port, 3, 2))


def test_row_map_columns_blend_as_batches():
    """A prediction column of reserved-key row maps blends as its batch."""
    b1, b2 = _batches(True, 2, 1), _batches(True, 2, 2)
    rows = FeatureColumn(ft.Prediction, np.array(b1.values.rows(),
                                                 dtype=object))
    got = _as_batch(rows)
    for a, b in ((got.prediction, b1.values.prediction),
                 (got.probability, b1.values.probability),
                 (got.raw_prediction, b1.values.raw_prediction)):
        assert torch.equal(a, b.to(torch.float64))
    model = SelectedCombinerModel(0.3, 0.7, "weighted", "AuPR")
    x = model.transform_columns(None, rows, b2).values
    y = model.transform_columns(None, b1, b2).values
    assert torch.equal(x.probability, y.probability)
    assert torch.equal(x.prediction, y.prediction)


# ---------------------------------------------------------------------------
# the Avro ensemble demo end to end
# ---------------------------------------------------------------------------

def build_demo(pkg, path):
    """examples/op_titanic_avro_combined.py's ``build`` in ``pkg``, uids
    numbered from 1 (so both packages name every feature alike)."""
    pkg["uid"]._counter = itertools.count(1)
    fb, g = pkg["fb"], pkg["grid"]
    survived = fb.RealNN("Survived").as_response()
    predictors = [
        fb.PickList("Pclass").as_predictor(),
        fb.PickList("Sex").as_predictor(),
        fb.Real("Age").as_predictor(),
        fb.Integral("SibSp").as_predictor(),
        fb.Integral("Parch").as_predictor(),
        fb.Real("Fare").as_predictor(),
        fb.PickList("Embarked").as_predictor(),
    ]
    features = pkg["transmogrify"](predictors)
    checked = pkg["checker"](remove_bad_features=True).set_input(
        survived, features).get_output()
    linear = pkg["bsel"].with_cross_validation(
        num_folds=3, models_and_parameters=[
            (pkg["lr"](), g(reg_param=[0.01, 0.1])),
            (pkg["mlp"](max_iter=200, step_size=0.1),
             g(hidden_layers=[[8]]))]).set_input(survived, checked)
    trees = pkg["bsel"].with_cross_validation(
        num_folds=3, models_and_parameters=[
            (pkg["rf"](), g(num_trees=[50], max_depth=[6, 12],
                            min_info_gain=[0.001]))]).set_input(
        survived, checked)
    combined = pkg["comb"](combination_strategy="weighted").set_input(
        survived, linear.get_output(), trees.get_output()).get_output()
    wf = (pkg["wf"]()
          .set_result_features(combined, linear.get_output(),
                               trees.get_output())
          .set_reader(pkg["reader"](path)))
    return wf, combined, linear, trees


def _jax_bags(seed, n_trees, n, d, msub, subsample_rate, device):
    bw, idx = jg.rf_bags_and_features(seed, n_trees, n, d, msub,
                                      subsample_rate)
    return (torch.from_numpy(np.array(bw)).to(device),
            torch.from_numpy(np.array(idx)).long().to(device))


def _jax_init(sizes, seed, device):
    return [(torch.from_numpy(np.array(W)).to(device),
             torch.from_numpy(np.array(b)).to(device))
            for W, b in jmlp._init_params(jax.random.PRNGKey(seed), sizes)]


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("avro_demo")
    cols, _ = chip_smoke.titanic_columns(ROWS + HOLD)
    train = str(tmp / "train.avro")
    hold = str(tmp / "holdout.avro")
    write_avro(train, chip_smoke.AVRO_SCHEMA,
               chip_smoke.avro_records(cols, 0, ROWS))
    write_avro(hold, chip_smoke.AVRO_SCHEMA,
               chip_smoke.avro_records(cols, ROWS, ROWS + HOLD))
    out = {}
    for port in (False, True):
        pkg = _pkg(port)
        wf, combined, linear, trees = build_demo(pkg, train)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TMOG_COST_HISTORY", "0")
            mp.setenv("TMOG_SYNC_SWEEP", "1")
            mp.setattr(tk, "rf_bags_and_features", _jax_bags)
            mp.setattr(tmlp, "init_params", _jax_init)
            model = wf.train()
        ev = (Evaluators if port else JEvaluators).BinaryClassification
        scored, metrics = model.score_and_evaluate(
            ev.auPR(), data=pkg["reader"](hold))
        out[port] = dict(model=model, combined=combined, linear=linear,
                         trees=trees, scored=scored, metrics=metrics,
                         pkg=pkg, hold=hold, tmp=tmp)
    return out


def _combiner_meta(run):
    return run["combined"].origin_stage.metadata


def _probas(run, key):
    feat = (run["combined"] if key == "combined"
            else run[key].get_output())
    return np.asarray(run["scored"][feat.name].values.probability,
                      np.float64)


def test_demo_same_winners_and_weights(demo):
    j, t = demo[False], demo[True]
    for key in ("linear", "trees"):
        js = j[key].metadata["model_selector_summary"]
        ts = t[key].metadata["model_selector_summary"]
        assert (ts["bestModelType"], ts["bestModelParams"]) == (
            js["bestModelType"], js["bestModelParams"])
        for a, b in zip(ts["validationResults"], js["validationResults"]):
            assert (a["modelType"], a["params"]) == (b["modelType"],
                                                     b["params"])
            assert abs(a["metricValue"] - b["metricValue"]) <= 1e-5
    jc, tc = _combiner_meta(j)["combiner"], _combiner_meta(t)["combiner"]
    assert tc["strategy"] == jc["strategy"] == "weighted"
    assert tc["metricName"] == jc["metricName"] == "AuPR"
    for k in ("weight1", "weight2", "metricValue1", "metricValue2"):
        assert abs(tc[k] - jc[k]) <= 1e-6, k
    assert abs(tc["weight1"] + tc["weight2"] - 1.0) <= 1e-12
    assert set(_combiner_meta(t)["model_selector_summary"]) == set(
        _combiner_meta(j)["model_selector_summary"])


def test_demo_holdout_probabilities(demo):
    for key in ("linear", "trees", "combined"):
        got, want = _probas(demo[True], key), _probas(demo[False], key)
        assert got.shape == want.shape == (HOLD, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    blend = _combiner_meta(demo[True])["combiner"]
    np.testing.assert_allclose(
        _probas(demo[True], "combined"),
        blend["weight1"] * _probas(demo[True], "linear")
        + blend["weight2"] * _probas(demo[True], "trees"), rtol=0, atol=1e-12)
    jm, tm = demo[False]["metrics"], demo[True]["metrics"]
    assert set(tm) == set(jm)
    assert abs(tm["AuPR"] - jm["AuPR"]) <= 1e-4
    tsum = _combiner_meta(demo[True])["model_selector_summary"]
    jsum = _combiner_meta(demo[False])["model_selector_summary"]
    for k, v in jsum["trainEvaluationMetrics"].items():
        assert abs(tsum["trainEvaluationMetrics"][k] - v) <= max(
            1e-4, 1e-4 * abs(v)), k


def test_demo_save_load_both_ways(demo):
    t, j = demo[True], demo[False]
    tpath, jpath = str(t["tmp"] / "port_model"), str(t["tmp"] / "jax_model")
    t["model"].save(tpath)
    j["model"].save(jpath)
    name = t["combined"].name
    data = AvroReader(t["hold"]).generate_dataset(
        t["model"].raw_features())
    loaded = OpWorkflowModel.load(tpath)
    assert torch.equal(loaded.score(data)[name].values.probability,
                       t["model"].score(data)[name].values.probability)
    comb = loaded.get_fitted_stage("SelectedCombinerModel")
    assert [f.name for f in comb.input_features] == [
        f.name for f in t["combined"].origin_stage.input_features]
    from transmogrifai_tpu.readers import AvroReader as JAvroReader
    in_jax = JWorkflowModel.load(tpath).score(JAvroReader(t["hold"]))
    np.testing.assert_allclose(np.asarray(in_jax[name].values.probability),
                               _probas(t, "combined"), rtol=0, atol=1e-5)
    in_port = OpWorkflowModel.load(jpath).score(data)
    np.testing.assert_allclose(
        in_port[name].values.probability.numpy(), _probas(j, "combined"),
        rtol=0, atol=1e-5)
    rows = [{k: v for k, v in r.items() if k != "Survived"}
            for r in AvroReader(t["hold"]).records[:16]]
    local = [r[name]["probability_1"]
             for r in score_function_batch(loaded)(rows)]
    batch = loaded.score(data.slice(0, 16))[name].values.probability[:, 1]
    assert local == batch.tolist()


def test_convert_carries_the_jax_combiner(demo):
    j = demo[False]
    jstage = next(s for s in j["model"].stages
                  if type(s).__name__ == "SelectedCombinerModel")
    est = _pkg(True)["comb"](combination_strategy="weighted")
    model = convert.selected_combiner(
        est, jstage.weight1, jstage.weight2, jstage.strategy, jstage.metric,
        combiner=_combiner_meta(j)["combiner"])
    assert isinstance(model, SelectedCombinerModel)
    assert (model.weight1, model.weight2, model.strategy, model.metric) == (
        jstage.weight1, jstage.weight2, "weighted", "AuPR")
    assert est.metadata["combiner"] == _combiner_meta(j)["combiner"]
    assert model.uid == est.uid
    assert os.path.exists(j["hold"])
