"""The port's logistic-regression trainers against the JAX package on the
CPU, on the same numpy-seeded inputs.

Both compute in float32; the port's products sum in another order, and the
solvers iterate, so the tolerances are those of a converged float32 solve:
scores within atol 1e-4, coefficients and intercepts within 1e-3, the
grid's fold statistics within rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from transmogrifai_tpu.models import linear as jl
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
from transmogrifai_tpu_torch.models import linear as tl
from transmogrifai_tpu_torch.models.classification import \
    OpLogisticRegression

N, D, F = 2000, 20, 4
REGS = np.array([0.001, 0.01, 0.1, 0.2] * 2, np.float32)
ALPHAS = np.array([0.0] * 4 + [0.1, 0.5, 0.1, 0.5], np.float32)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(N, D)).astype(np.float32)
    X[:, 3] = X[:, 3] * 40 + 5             # a badly scaled column
    X[:, 11] = (rng.random(N) < 0.1)       # a sparse indicator
    beta = rng.normal(size=D) * (rng.random(D) < 0.5)
    z = (X - X.mean(0)) / X.std(0) @ beta + 0.5 * rng.normal(size=N)
    y = (z > 0).astype(np.float32)
    folds = rng.integers(0, F - 1, N)
    W = np.stack([(folds != k).astype(np.float32) for k in range(F - 1)]
                 + [np.ones(N, np.float32)])
    W[:, :50] = 0.0                        # rows of no fold (a holdout)
    return X, y, W


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_grid_fold_statistics(problem):
    X, y, W = problem
    wsum = np.maximum(W.sum(1), 1.0)
    jc, js = jl._grid_fold_stats(jnp.asarray(X), jnp.asarray(W),
                                 jnp.asarray(wsum), True, True)
    Xt, Wt, wt = _t(X, W, wsum.astype(np.float32))
    tc, ts = tl._grid_fold_stats(Xt, Wt, wt, True, True)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    jq = jl._grid_fold_grams(jnp.asarray(X), jnp.asarray(W),
                             jnp.asarray(wsum), jc, js)
    tq = tl._grid_fold_grams(Xt, Wt, wt, tc, ts)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tl._grid_lmax(tq).numpy(),
                               np.asarray(jl._grid_lmax(jq)), rtol=1e-4)


@pytest.mark.parametrize("standardization", [True, False])
def test_fit_logreg_grid_matches_jax(problem, standardization):
    """Every (fold, candidate) fit, pure-L2 and elastic-net candidates."""
    X, y, W = problem
    kw = dict(max_iter=200, tol=1e-5, fit_intercept=True,
              standardization=standardization)
    js, jit, jc, ji = jl.fit_logreg_grid(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(W), jnp.asarray(REGS),
        jnp.asarray(ALPHAS), **kw)
    ts, tit, tc, ti = tl.fit_logreg_grid(*_t(X, y, W, REGS, ALPHAS), **kw)
    assert ts.shape == (F, len(REGS), N) and tc.shape == (F, len(REGS), D)
    assert abs(tit - int(jit)) <= 2
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-3)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=1e-3)


@pytest.mark.parametrize("reg,alpha", [(0.0, 0.0), (0.01, 0.0),
                                       (0.01, 0.5)])
def test_fit_logistic_regression_matches_jax(problem, reg, alpha):
    """One weighted fit: Newton-IRLS (alpha 0) and FISTA (alpha > 0), on a
    standardized matrix as the estimator fits it."""
    X, y, W = problem
    Xs = ((X - X.mean(0)) / X.std(0)).astype(np.float32)
    w = W[0] * 1.5
    j = jl.fit_logistic_regression(jnp.asarray(Xs), jnp.asarray(y),
                                   sample_weight=jnp.asarray(w),
                                   reg_param=reg, elastic_net_param=alpha,
                                   max_iter=50, tol=1e-6)
    t = tl.fit_logistic_regression(*_t(Xs, y), torch.from_numpy(w),
                                   reg_param=reg, elastic_net_param=alpha,
                                   max_iter=50, tol=1e-6)
    np.testing.assert_allclose(t.coef.numpy(), np.asarray(j.coef), rtol=0,
                               atol=1e-3)
    assert abs(float(t.intercept) - float(j.intercept)) <= 1e-3
    assert t.converged == bool(j.converged)


def test_estimator_fit_raw_and_predict(problem):
    """``OpLogisticRegression.fit_raw``: the same raw-space model and the
    same probabilities as the JAX estimator's host fit."""
    X, y, W = problem
    jm = JLR(reg_param=0.01, elastic_net_param=0.1).fit_raw(X, y, W[1])
    tm = OpLogisticRegression(reg_param=0.01, elastic_net_param=0.1
                              ).fit_raw(X, y, W[1], device="cpu")
    np.testing.assert_allclose(tm.coef.numpy(), np.asarray(jm.coef),
                               rtol=0, atol=1e-3)
    assert abs(tm.intercept - jm.intercept) <= 1e-3
    jb, tb = jm.predict_batch(X), tm.predict_batch(torch.from_numpy(X))
    np.testing.assert_allclose(tb.probability.numpy(),
                               np.asarray(jb.probability), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(
        tb.prediction.numpy(),
        (tb.probability[:, 1] >= 0.5).numpy().astype(np.float64))


def test_fit_raw_rejects_multiclass():
    X = np.zeros((4, 2), np.float32)
    with pytest.raises(NotImplementedError):
        OpLogisticRegression().fit_raw(X, np.array([0, 1, 2, 1.0]),
                                       device="cpu")
