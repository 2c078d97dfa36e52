"""``OpGeneralizedLinearRegression`` and ``IsotonicRegressionCalibrator`` in
the port against the JAX package, on the CPU.

* GLM, all four families with their canonical links (gaussian through the
  ridge solve, poisson, gamma and binomial through IRLS), with and
  without the intercept and with a ridge term: coefficients, intercept
  and predictions within 1e-5 (float32 normal equations summed in
  another order).
* Isotonic and antitonic calibration on scores with ties: boundaries and
  predictions equal to the JAX package's bitwise (its sort order and its
  pooling arithmetic), interpolation equal to ``np.interp`` bitwise, on
  boundaries, between them and past both ends.
* Saved and loaded both ways (each package's stage record through JSON
  text and an npz file): the loaded model scores within 1e-6.
"""
import io
import json

import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.models import regression as jr
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.workflow import persistence as jp
from transmogrifai_tpu_torch.models import regression as tr
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import FeatureColumn
from transmogrifai_tpu_torch.workflow import persistence as tp

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


def roundtrip(stage, to_jax: bool):
    """One fitted stage saved by one package's record writer and loaded
    by the other's: the record through JSON text, its arrays through an
    npz file."""
    src = tp if to_jax else jp
    store = src._ArrayStore()
    rec = json.loads(json.dumps(src._stage_record(stage, store)))
    buf = io.BytesIO()
    np.savez(buf, **store.arrays)
    buf.seek(0)
    arrays = dict(np.load(buf))
    if to_jax:
        return jp._load_stage(rec, arrays)
    return tp._load_stage(rec, arrays, torch.device("cpu"))


def _glm_data(family: str, n=2000, d=6, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    eta = X @ (rng.normal(size=d) * 0.3) + 0.2
    y = {"gaussian": lambda: eta + rng.normal(size=n) * 0.5,
         "poisson": lambda: rng.poisson(np.exp(eta)),
         "gamma": lambda: rng.gamma(2.0, np.exp(eta) / 2.0),
         "binomial": lambda: rng.random(n) < 1 / (1 + np.exp(-eta))}[family]
    return X, np.asarray(y(), np.float32)


@pytest.mark.parametrize("family,kw", [
    ("gaussian", {}), ("gaussian", dict(reg_param=0.1)),
    ("poisson", {}), ("poisson", dict(fit_intercept=False)),
    ("gamma", {}), ("gamma", dict(reg_param=0.05)),
    ("binomial", {}), ("binomial", dict(max_iter=2)),
])
def test_glm_matches_jax(family, kw):
    """Coefficients, intercept and predictions within 1e-5 (the IRLS
    steps' count may differ by one where the last move sits at the
    tolerance in float32)."""
    X, y = _glm_data(family)
    jm = jr.OpGeneralizedLinearRegression(family=family, **kw).fit_raw(X, y)
    est = tr.OpGeneralizedLinearRegression(family=family, **kw)
    tm = est.fit_raw(X, y, device="cpu")
    assert tm.link == jm.link == tr.GLM_LINKS[family]
    np.testing.assert_allclose(tm.coef.numpy(), np.asarray(jm.coef),
                               rtol=0, atol=TOL)
    assert abs(tm.intercept - jm.intercept) <= TOL
    pj = np.asarray(jm.predict_batch(X).prediction)
    pt = tm.predict_batch(torch.from_numpy(X)).prediction.numpy()
    np.testing.assert_allclose(pt, pj, rtol=TOL, atol=TOL)
    assert 1 <= est.metadata["n_iter"] <= kw.get("max_iter", 50)


def test_glm_gaussian_is_the_ridge_solve():
    """Gaussian with the identity link fits no IRLS: one ridge solve."""
    X, y = _glm_data("gaussian")
    est = tr.OpGeneralizedLinearRegression()
    est.fit_raw(X, y, device="cpu")
    assert est.metadata["n_iter"] == 1


def _scores(n=3000, seed=8):
    """Scores rounded to two decimals (many ties) and labels drawn with
    those probabilities."""
    rng = np.random.default_rng(seed)
    s = np.round(rng.random(n), 2)
    return s, (rng.random(n) < s).astype(np.float64)


@pytest.mark.parametrize("isotonic", [True, False])
def test_isotonic_matches_jax(isotonic):
    """Boundaries and predictions bitwise; interpolation bitwise with
    ``np.interp`` on the boundaries, between them and past both ends; the
    calibrator's column path (a prediction's class-1 probability, or a
    number) gives the same model."""
    s, lab = _scores()
    jm = jr.IsotonicRegressionCalibrator(isotonic=isotonic).fit_columns(
        None, JColumn.from_values(jft.RealNN, lab),
        JColumn.from_values(jft.Real, s))
    cal = tr.IsotonicRegressionCalibrator(isotonic=isotonic)
    tm = cal.fit_raw(s, lab, device="cpu")
    assert cal.metadata["blocks"] == len(jm.boundaries)
    assert np.array_equal(tm.boundaries.numpy(), np.asarray(jm.boundaries))
    assert np.array_equal(tm.predictions.numpy(), np.asarray(jm.predictions))
    q = np.concatenate([np.random.default_rng(1).random(500) * 1.4 - 0.2,
                        np.asarray(jm.boundaries), [np.nan]])
    got = tm.predict_batch(torch.from_numpy(q[:, None])).prediction.numpy()
    want = np.asarray(jm.predict_batch(q[:, None]).prediction)
    assert np.array_equal(got, want, equal_nan=True)
    col = tr.IsotonicRegressionCalibrator(isotonic=isotonic).fit_columns(
        None, FeatureColumn.from_values(ft.RealNN, lab),
        FeatureColumn.from_values(ft.Real, s))
    assert torch.equal(col.boundaries, tm.boundaries)


def test_isotonic_monotone_on_model_scores():
    """Calibrating continuous scores: the calibrated values never fall as
    the score rises, and the model's column transform reads a
    prediction's class-1 probability."""
    from transmogrifai_tpu_torch.models.prediction import PredictionBatch

    rng = np.random.default_rng(4)
    s = rng.random(5000)
    lab = (rng.random(5000) < s ** 2).astype(np.float64)
    m = tr.IsotonicRegressionCalibrator().fit_raw(s, lab, device="cpu")
    grid = torch.linspace(-0.1, 1.1, 2001, dtype=torch.float64)
    out = m.interpolate(grid)
    assert bool((out[1:] >= out[:-1]).all())
    proba = torch.from_numpy(np.stack([1 - s, s], 1))
    batch = PredictionBatch(prediction=torch.zeros(5000),
                            probability=proba)
    col = m.transform_columns(None, FeatureColumn(ft.Prediction, batch))
    assert torch.equal(col.values.prediction,
                       m.interpolate(torch.from_numpy(s)))


@pytest.mark.parametrize("kind", ["poisson", "isotonic"])
def test_saved_both_ways(kind):
    """The port's fitted model loads in the JAX package and the JAX
    package's in the port; each scores within 1e-6 of the model saved."""
    if kind == "poisson":
        X, y = _glm_data("poisson")
        port = tr.OpGeneralizedLinearRegression(family="poisson").fit_raw(
            X, y, device="cpu")
        jax_m = jr.OpGeneralizedLinearRegression(family="poisson").fit_raw(
            X, y)
        q = X[:50]
    else:
        s, lab = _scores()
        port = tr.IsotonicRegressionCalibrator().fit_raw(s, lab,
                                                         device="cpu")
        jax_m = jr.IsotonicRegressionCalibrator().fit_columns(
            None, JColumn.from_values(jft.RealNN, lab),
            JColumn.from_values(jft.Real, s))
        q = np.linspace(-0.1, 1.1, 50)[:, None]
    in_jax = roundtrip(port, to_jax=True)
    assert type(in_jax).__name__ == type(port).__name__
    np.testing.assert_allclose(
        np.asarray(in_jax.predict_batch(q).prediction),
        port.predict_batch(torch.from_numpy(q)).prediction.numpy(),
        rtol=1e-6, atol=1e-6)
    in_port = roundtrip(jax_m, to_jax=False)
    assert isinstance(in_port, type(port))
    np.testing.assert_allclose(
        in_port.predict_batch(torch.from_numpy(q)).prediction.numpy(),
        np.asarray(jax_m.predict_batch(q).prediction), rtol=1e-6,
        atol=1e-6)
