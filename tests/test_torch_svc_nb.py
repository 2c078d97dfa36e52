"""The port's linear SVC and naive Bayes, the logistic regression's
``sample_weight_col`` and the MLP's options, against the JAX package on
the CPU, on the same numpy-seeded inputs.

Tolerances, and why:
 * ``fit_linear_svc``: damped Newton steps of float32 solves whose
   products sum in another order: coefficients and intercept within 1e-4,
   and the same number of steps (the test stops at the same step).
 * ``fit_naive_bayes``: one float32 product and logs: log priors and log
   likelihoods within 1e-5; log posteriors within 32 float32 ulps of the
   joint log likelihood's summed magnitude (float32 sums in another
   order).
 * Estimators: the JAX package standardizes on the host in float32, the
   port in float64 on its device, so the fitted SVC's raw-space
   coefficients hold within 1e-4 (margins within 1e-4, labels equal where
   the margin is farther than that from 0).  The JAX SVC model scores
   small batches natively; its native backend is patched off.
 * The weighted logistic regression and the MLP: a converged float32
   solve (coefficients 1e-3, probabilities 1e-4), as
   ``tests/test_torch_linear.py`` and ``tests/test_torch_iris.py`` hold
   them.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import transmogrifai_tpu.native
import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models import linear as jl
from transmogrifai_tpu.models import mlp as jmlp
from transmogrifai_tpu.models.classification import OpLinearSVC as JSVC
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
from transmogrifai_tpu.models.classification import OpNaiveBayes as JNB
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import ColumnarDataset as JDataset
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu.workflow.workflow import \
    OpWorkflowModel as JWorkflowModel
from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.models import linear as tl
from transmogrifai_tpu_torch.models import mlp as tmlp
from transmogrifai_tpu_torch.models.classification import (
    LinearSVCModel, NaiveBayesModel, OpLinearSVC, OpLogisticRegression,
    OpNaiveBayes)
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import ColumnarDataset, FeatureColumn
from transmogrifai_tpu_torch.workflow.workflow import (OpWorkflow,
                                                       OpWorkflowModel)

N, D = 1500, 12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(transmogrifai_tpu.native, "AVAILABLE", False)


def _problem(seed=3, n_classes=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(np.float32)
    X[:, 2] = X[:, 2] * 30 + 4                      # a badly scaled column
    X[:, 7] = (rng.random(N) < 0.2).astype(np.float32)  # an indicator
    beta = rng.normal(size=(D, n_classes))
    z = ((X - X.mean(0)) / X.std(0)) @ beta + rng.gumbel(size=(N, n_classes))
    y = z.argmax(1).astype(np.float32)
    w = rng.uniform(0.2, 2.0, N).astype(np.float32)
    return X, y, w


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reg,intercept", [(1e-4, True), (0.1, True),
                                           (0.01, False)])
def test_fit_linear_svc_matches_jax(weighted, reg, intercept):
    X, y, w = _problem()
    Xs = (X - X.mean(0)) / X.std(0)
    sw = w if weighted else None
    kw = dict(reg_param=reg, max_iter=50, tol=1e-6, fit_intercept=intercept)
    j = jl.fit_linear_svc(jnp.asarray(Xs), jnp.asarray(y),
                          None if sw is None else jnp.asarray(sw), **kw)
    Xt, yt = _t(Xs, y)
    t = tl.fit_linear_svc(Xt, yt, None if sw is None else _t(sw)[0], **kw)
    assert t.n_iter == int(j.n_iter)
    assert t.converged == bool(j.converged)
    np.testing.assert_allclose(t.coef.numpy(), np.asarray(j.coef), rtol=0,
                               atol=1e-4)
    assert abs(float(t.intercept) - float(j.intercept)) <= 1e-4
    np.testing.assert_allclose(
        tl.svc_decision(t.coef, t.intercept, Xt).numpy(),
        np.asarray(jl.svc_decision(j.coef, j.intercept, Xs)), rtol=0,
        atol=1e-4)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("K", [2, 3])
def test_fit_naive_bayes_matches_jax(weighted, K):
    X, y, w = _problem(seed=5, n_classes=K)
    sw = w if weighted else None
    jp, jll = jl.fit_naive_bayes(jnp.asarray(X), jnp.asarray(y.astype(
        np.int32)), n_classes=K, sample_weight=sw, smoothing=1.0)
    Xt, yt = _t(X, y.astype(np.int64))
    tp, tll = tl.fit_naive_bayes(Xt, yt, K,
                                 None if sw is None else _t(sw)[0], 1.0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=0,
                               atol=1e-5)
    # the joint log likelihoods are float32 sums of D terms in another
    # order: the posteriors agree within 32 float32 ulps (4e-6) of the
    # terms' summed magnitude (a D-term sum's bound is D ulps of it)
    mag = float((np.abs(X) @ np.abs(np.asarray(jll)).T).max())
    np.testing.assert_allclose(
        tl.naive_bayes_predict_log_proba(tp, tll, Xt).numpy(),
        np.asarray(jl.naive_bayes_predict_log_proba(jp, jll, X)), rtol=0,
        atol=4e-6 * mag)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("standardization", [True, False])
def test_linear_svc_estimator_matches_jax(weighted, standardization):
    X, y, w = _problem(seed=7)
    sw = w if weighted else None
    est = OpLinearSVC(reg_param=0.01, standardization=standardization)
    jm = JSVC(reg_param=0.01, standardization=standardization).fit_raw(
        X, y, sw)
    tm = est.fit_raw(X, y, sw)
    assert est.metadata["n_iter"] > 0
    np.testing.assert_allclose(tm.coef.numpy(), np.asarray(jm.coef),
                               rtol=0, atol=1e-4)
    assert abs(tm.intercept - jm.intercept) <= 1e-4
    tb = tm.predict_batch(torch.from_numpy(X))
    jb = jm.predict_batch(X)
    assert tb.probability is None and jb.probability is None
    np.testing.assert_allclose(tb.raw_prediction.numpy(),
                               np.asarray(jb.raw_prediction), rtol=0,
                               atol=1e-4)
    clear = np.abs(np.asarray(jb.raw_prediction)[:, 1]) > 1e-4
    np.testing.assert_array_equal(tb.prediction.numpy()[clear],
                                  np.asarray(jb.prediction)[clear])


@pytest.mark.parametrize("K", [2, 3])
def test_naive_bayes_estimator_matches_jax(K):
    X, y, w = _problem(seed=9, n_classes=K)
    jm = JNB(smoothing=0.5).fit_raw(X, y, w)
    tm = OpNaiveBayes(smoothing=0.5).fit_raw(X, y, w)
    np.testing.assert_allclose(tm.log_prior.numpy(),
                               np.asarray(jm.log_prior), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.log_lik.numpy(), np.asarray(jm.log_lik),
                               rtol=0, atol=1e-5)
    tb, jb = tm.predict_batch(torch.from_numpy(X)), jm.predict_batch(X)
    for a, b in ((tb.raw_prediction, jb.raw_prediction),
                 (tb.probability, jb.probability)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    p = np.sort(np.asarray(jb.probability), 1)
    clear = p[:, -1] - p[:, -2] > 1e-5
    np.testing.assert_array_equal(tb.prediction.numpy()[clear],
                                  np.asarray(jb.prediction)[clear])


def _dataset(ds_cls, col_cls, types, X, y, w=None):
    cols = {f"x{j}": col_cls.from_values(types.Real, X[:, j])
            for j in range(X.shape[1])}
    cols["label"] = col_cls.from_values(types.RealNN, y)
    if w is not None:
        cols["weight"] = col_cls.from_values(types.Real, w)
    return ds_cls(cols)


def _train(port, est, X, y, w=None):
    """A workflow of Reals -> vectorize -> ``est``, in either package."""
    fb, ds_cls, col_cls, types, wf = (
        (FeatureBuilder, ColumnarDataset, FeatureColumn, ft, OpWorkflow)
        if port else (JFB, JDataset, JColumn, jft, JWorkflow))
    from transmogrifai_tpu.ops.vectorizers import VectorsCombiner as JVC
    from transmogrifai_tpu_torch.ops.vectorizers import VectorsCombiner
    label = fb.RealNN("label").as_response()
    feats = [fb.Real(f"x{j}").as_predictor().vectorize()
             for j in range(X.shape[1])]
    vec = (VectorsCombiner if port else JVC)().set_input(
        *feats).get_output()
    pred = est.set_input(label, vec).get_output()
    data = _dataset(ds_cls, col_cls, types, X, y, w)
    # a weight column reaches the fit as a raw feature of the workflow
    extra = [] if w is None else [fb.Real("weight").as_predictor()]
    model = wf().set_result_features(pred, *extra).set_input_data(
        data).train()
    return model, pred, data


def test_logistic_regression_sample_weight_col():
    X, y, w = _problem(seed=11)
    jm, jp, jd = _train(False, JLR(reg_param=0.01, sample_weight_col="weight"),
                        X, y, w)
    tm, tp, td = _train(True, OpLogisticRegression(
        reg_param=0.01, sample_weight_col="weight"), X, y, w)
    um, up, ud = _train(True, OpLogisticRegression(reg_param=0.01), X, y, w)
    jcoef = np.asarray(next(s for s in jm.stages
                            if type(s).__name__ == "LogisticRegressionModel")
                       .coef)
    tcoef = tm.get_fitted_stage("LogisticRegressionModel").coef
    ucoef = um.get_fitted_stage("LogisticRegressionModel").coef
    np.testing.assert_allclose(tcoef.numpy(), jcoef, rtol=0, atol=1e-3)
    assert float((ucoef - tcoef).abs().max()) > 1e-2   # the weights matter
    assert tp.origin_stage.get_params()["sample_weight_col"] == "weight"
    tproba = tm.score(td)[tp.name].values.probability.numpy()
    jproba = np.asarray(jm.score(jd)[jp.name].values.probability)
    np.testing.assert_allclose(tproba, jproba, rtol=0, atol=1e-4)


def _jax_init(sizes, seed, device):
    return [(torch.from_numpy(np.array(W)).to(device),
             torch.from_numpy(np.array(b)).to(device))
            for W, b in jmlp._init_params(jax.random.PRNGKey(seed), sizes)]


@pytest.mark.parametrize("standardization", [True, False])
def test_mlp_options_match_jax(monkeypatch, standardization):
    X, y, _ = _problem(seed=13, n_classes=3)
    kw = dict(hidden_layers=[6], max_iter=120, step_size=0.05,
              block_size=64, solver="l-bfgs", standardization=standardization)
    jest = jmlp.OpMultilayerPerceptronClassifier(**kw)
    test = tmlp.OpMultilayerPerceptronClassifier(**kw)
    assert {k: test.get_params()[k] for k in kw} == \
        {k: jest.get_params()[k] for k in kw}
    monkeypatch.setattr(tmlp, "init_params", _jax_init)
    jm, tm = jest.fit_raw(X, y), test.fit_raw(X, y)
    if not standardization:
        assert float(tm.mu.abs().max()) == 0.0
        assert float((tm.sigma - 1).abs().max()) == 0.0
    np.testing.assert_allclose(tm.mu.numpy(), np.asarray(jm.mu), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        tm.predict_batch(torch.from_numpy(X)).probability.numpy(),
        np.asarray(jm.predict_batch(X).probability), rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["svc", "nb"])
def test_models_cross_both_packages(tmp_path, kind):
    """A workflow of the family trained in each package, saved, loads in
    the other and scores within 1e-5; ``convert`` carries the JAX model's
    state into the port's class."""
    X, y, _ = _problem(seed=15)
    Xn = np.abs(X) if kind == "nb" else X
    jest, test = ((JSVC(), OpLinearSVC()) if kind == "svc"
                  else (JNB(), OpNaiveBayes()))
    jm, jp, jd = _train(False, jest, Xn, y)
    tm, tp, td = _train(True, test, Xn, y)
    field = "raw_prediction" if kind == "svc" else "probability"
    tpath, jpath = str(tmp_path / "t"), str(tmp_path / "j")
    tm.save(tpath)
    jm.save(jpath)
    in_jax = JWorkflowModel.load(tpath).score(jd)[tp.name].values
    in_port = OpWorkflowModel.load(jpath).score(td)[jp.name].values
    np.testing.assert_allclose(np.asarray(getattr(in_jax, field)),
                               getattr(tm.score(td)[tp.name].values,
                                       field).numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(getattr(in_port, field).numpy(),
                               np.asarray(getattr(jm.score(jd)[jp.name]
                                                  .values, field)),
                               rtol=0, atol=1e-5)
    jstage = next(s for s in jm.stages
                  if type(s).__name__ in ("LinearSVCModel",
                                          "NaiveBayesModel"))
    if kind == "svc":
        conv = convert.linear_svc_model(np.asarray(jstage.coef),
                                        jstage.intercept)
        assert isinstance(conv, LinearSVCModel)
    else:
        conv = convert.naive_bayes_model(np.asarray(jstage.log_prior),
                                         np.asarray(jstage.log_lik))
        assert isinstance(conv, NaiveBayesModel)
    vec = jstage.input_features[1].name
    Xv = np.asarray(jm.score(jd, keep_raw_features=True,
                             keep_intermediate_features=True)[vec].values,
                    np.float32)
    got = getattr(conv.predict_batch(torch.from_numpy(Xv)), field).numpy()
    want = np.asarray(getattr(jstage.predict_batch(Xv), field))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
