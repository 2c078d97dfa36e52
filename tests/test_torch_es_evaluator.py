"""Two faults of the port against the JAX package, repaired, on the CPU.

1. Boosted early stopping keeps the JAX package's number of rounds.  The
   JAX package scores each round with a float32 AuPR of the validation
   sigmoids (``_aupr_dev``), and its patience rule counts an improvement
   only past 1e-9.  The port takes the same float32 sums
   (``metrics.aupr_es``); a tie of validation margins stays one tie
   group.  On ``test_torch_insights.py``'s 600-row frame the selector
   over ``OpXGBoostClassifier(num_round=8, max_depth=3)`` with early
   stopping kept 1 round in the JAX package and 4 in the port: a
   vectorized sigmoid split one tie of margins by an ulp in round 4.
   Now the refit keeps the same rounds and every chain of the CV group
   (``GBTGridGroup``) stops at the same round.
2. ``OpBinaryClassificationEvaluator.evaluate`` returns the JAX package's
   metric set (AuROC, AuPR, BrierScore, LogLoss, the counts and rates at
   ``threshold``), its threshold curves when ``n_thresholds`` > 0, and
   takes ``sample_weight``; without probabilities it scores the raw
   prediction, else the predicted label.  Keys equal, values within
   1e-6 (the two packages' probabilities are float32 values of identical
   trees, an ulp apart at most; the JAX package's own tests hold these
   metrics to 1e-6)."""
import itertools

import numpy as np
import pytest
import torch

import transmogrifai_tpu.native
import transmogrifai_tpu_torch as tt
import test_torch_insights as ti
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JEvaluators
from transmogrifai_tpu.evaluators.evaluators import \
    OpBinaryClassificationEvaluator as JBinEval
from transmogrifai_tpu.evaluators.metrics import _aupr_dev
from transmogrifai_tpu.models.prediction import PredictionBatch as JBatch
from transmogrifai_tpu.selector import grid_groups as jgg
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import ColumnarDataset as JDataset
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu_torch.evaluators.evaluators import (
    Evaluators, OpBinaryClassificationEvaluator)
from transmogrifai_tpu_torch.evaluators.metrics import aupr_es
from transmogrifai_tpu_torch.models.prediction import PredictionBatch
from transmogrifai_tpu_torch.selector import grid_groups as tgg
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                   FeatureColumn)

METRIC_TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _train_xgb(pkg, df):
    pkg["uid"]._counter = itertools.count(1)
    fb = pkg["fb"]
    label = fb.RealNN("label").as_response()
    preds = [fb.Real("strong").as_predictor(), fb.Real("weak").as_predictor(),
             fb.PickList("color").as_predictor(),
             fb.Integral("count").as_predictor()]
    checked = pkg["checker"]().set_input(
        label, pkg["tm"](preds)).get_output()
    models = [(pkg["xgb"](), pkg["grid"](num_round=[8], max_depth=[3]))]
    sel = pkg["sel"].with_cross_validation(num_folds=3,
                                           models_and_parameters=models)
    pred = sel.set_input(label, checked).get_output()
    model = pkg["wf"]().set_result_features(pred).set_input_data(df).train()
    inner = next(s for s in model.stages
                 if type(s).__name__ == "SelectedModel").inner
    return model, int(inner.feat.shape[0])


@pytest.fixture(scope="module")
def trained():
    """Both packages' selectors with early stopping on; the stop rounds
    of each package's CV group recorded."""
    tt.set_device("cpu")
    df = ti._frame()
    groups = {}
    replay = jgg._replay_es
    run = tgg.GBTGridGroup.run

    def rec_replay(rows, stopped, best_metric, best_len, *a, **k):
        groups["jax"] = best_len
        return replay(rows, stopped, best_metric, best_len, *a, **k)

    def rec_run(self, *a, **k):
        out = run(self, *a, **k)
        groups["port"] = self.best_len
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transmogrifai_tpu.native, "AVAILABLE", False)
        mp.setenv("TMOG_COST_HISTORY", "0")
        mp.setattr(jgg, "_replay_es", rec_replay)
        mp.setattr(tgg.GBTGridGroup, "run", rec_run)
        jax = _train_xgb(ti.JAX, df)
        port = _train_xgb(ti.PORT, df)
    return jax, port, groups, df


def test_refit_keeps_the_jax_rounds(trained):
    (_, jrounds), (_, trounds), _, _ = trained
    assert jrounds == 1
    assert trounds == jrounds


def test_group_chains_stop_at_the_jax_rounds(trained):
    _, _, groups, _ = trained
    assert set(groups) == {"jax", "port"}
    np.testing.assert_array_equal(np.asarray(groups["port"]),
                                  np.asarray(groups["jax"]))


@pytest.mark.parametrize("seed,levels", [(0, 6), (1, 40), (2, None)])
def test_aupr_es_matches_jax_float32(seed, levels):
    """Margins with many ties (``levels`` distinct values) and without:
    the float32 value equals the JAX package's on the same sigmoids
    within 4 float32 ulps (the group sums and running sums are exact
    integers; only the final float32 total of one term per group is
    summed in another order: bit-equal at a few groups, 2 ulps apart
    at 777 distinct margins)."""
    rng = np.random.default_rng(seed)
    n = 777
    m = (rng.integers(0, levels, n) * 0.37 - 1.0 if levels
         else rng.normal(0, 2, n)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    got = aupr_es(torch.from_numpy(y), torch.from_numpy(m))
    assert got.dtype == torch.float32
    import jax
    import jax.numpy as jnp
    want = np.float32(_aupr_dev(jnp.asarray(y),
                                jax.nn.sigmoid(jnp.asarray(m))))
    assert abs(float(got) - float(want)) <= 4 * float(np.spacing(want))
    if levels:
        assert float(got) == float(want)


def _compare(t, j):
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_allclose(np.asarray(t[k], np.float64),
                                   np.asarray(j[k], np.float64),
                                   rtol=METRIC_TOL, atol=METRIC_TOL,
                                   err_msg=k)


def test_evaluate_on_a_trained_model(trained):
    (jmodel, _), (tmodel, _), _, df = trained
    j = jmodel.evaluate(JEvaluators.BinaryClassification.auPR(), data=df)
    t = tmodel.evaluate(Evaluators.BinaryClassification.auPR(), data=df)
    assert {"AuROC", "AuPR", "BrierScore", "LogLoss", "Precision", "Recall",
            "F1", "Error", "TP", "TN", "FP", "FN"} == set(j)
    _compare(t, j)


@pytest.mark.parametrize("threshold,n_thresholds", [(0.5, 0), (0.35, 11),
                                                    (0.6, 100)])
def test_evaluate_threshold_curves_and_weights(trained, threshold,
                                               n_thresholds):
    (jmodel, _), (tmodel, _), _, df = trained
    w = np.random.default_rng(3).uniform(0.2, 2.0, len(df))
    outs = []
    for model, ev_cls in ((jmodel, JBinEval),
                          (tmodel, OpBinaryClassificationEvaluator)):
        scored = model.score(df)
        pred = next(f.name for f in model.result_features)
        ev = ev_cls(label_col="label", prediction_col=pred,
                    threshold=threshold, n_thresholds=n_thresholds)
        outs.append(ev.evaluate(scored, sample_weight=w))
    j, t = outs
    if n_thresholds:
        assert len(j["f1ByThreshold"]) == n_thresholds
    _compare(t, j)


@pytest.mark.parametrize("which", ["raw", "label"])
def test_evaluate_without_probability(which):
    """Scores of the raw prediction's second column, or of the label."""
    rng = np.random.default_rng(4)
    n = 300
    y = (rng.random(n) < 0.4).astype(float)
    raw = rng.normal(size=(n, 2)).astype(np.float32)
    raw[:, 1] += y
    pred = (raw[:, 1] > raw[:, 0]).astype(np.float32)
    outs = []
    for batch_cls, ds_cls, col_cls, types, ev_cls, wrap in (
            (JBatch, JDataset, JColumn, jft, JBinEval, np.asarray),
            (PredictionBatch, ColumnarDataset, FeatureColumn, ft,
             OpBinaryClassificationEvaluator, torch.from_numpy)):
        batch = batch_cls(wrap(pred),
                          wrap(raw) if which == "raw" else None, None)
        ds = ds_cls({"y": col_cls.from_values(types.RealNN, y),
                     "p": col_cls(types.Prediction, batch)})
        outs.append(ev_cls(label_col="y", prediction_col="p",
                           n_thresholds=5).evaluate(ds))
    _compare(outs[1], outs[0])
