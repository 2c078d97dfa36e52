"""The port's multiclass AutoML path against the JAX package on the CPU.

K-class forests, the softmax solvers, the multiclass metrics and
evaluator, ``DataCutter``, the stratified folds and split, the default
``MultiClassificationModelSelector`` end to end, persistence both ways
and ``convert.py``, each on the same numpy-seeded inputs (K = 3 and 5
classes of unequal priors).  The port's forests draw the JAX package's
bags and feature subsets (``rf_bags_and_features`` is patched to return
them).

Tolerances, and why:
 * K-class trees: integer weights (0/1 fold masks times Poisson bag
   counts), so every histogram and leaf sum is an exact integer; the
   last class's gradient is rebuilt as the count minus the others' in
   the JAX package's order and the gain summed in class order, so
   ``feat``/``thresh`` are equal exactly and leaves within 1e-6.
 * Forest scores: a K-class probability is a float32 sum over the trees
   taken in another order than the JAX package's (an ulp apart), so an
   exact tie of the top two classes can break the other way and move a
   fold's F1 by that row's share.  Predicted classes are held equal on
   every row whose JAX top-two probabilities differ by more than 1e-6
   (``test_forest_predictions_agree_outside_ties``); forest CV F1 within
   1e-4 on the selector's inputs, where no such tie flips.
 * Softmax LR: iterative float32 solves whose products sum in another
   order (as ``tests/test_torch_linear.py`` holds the binary grid):
   probabilities within 1e-4, coefficients and intercepts within 1e-3,
   predicted labels equal outside near-ties (top-two probabilities within
   1e-4); LR CV F1 within 1e-4.
 * Metrics: the port sums in float64, the JAX grid in float32: 1e-6;
   threshold counts exactly.
 * Splits, folds and cut labels are numpy-seeded in both packages: equal
   row for row.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.evaluators import metrics as jm
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JEvaluators
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models import gbdt_kernels as jg
from transmogrifai_tpu.models import linear as jl
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
from transmogrifai_tpu.models.trees import OpRandomForestClassifier as JRF
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JSanityChecker
from transmogrifai_tpu.selector import splitters as jsp
from transmogrifai_tpu.selector import validators as jv
from transmogrifai_tpu.selector.model_selector import \
    MultiClassificationModelSelector as JMCMS
from transmogrifai_tpu.selector.model_selector import grid as jgrid
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import ColumnarDataset as JDataset
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu.workflow.workflow import \
    OpWorkflowModel as JWorkflowModel
from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch.evaluators import metrics as tm
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.local import score_function
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.models import linear as tl
from transmogrifai_tpu_torch.models.classification import (
    LogisticRegressionModel, OpLogisticRegression)
from transmogrifai_tpu_torch.models.trees import (OpRandomForestClassifier,
                                                  TreeEnsembleModel)
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.selector import splitters as tsp
from transmogrifai_tpu_torch.selector import validators as tv
from transmogrifai_tpu_torch.selector.model_selector import (
    MultiClassificationModelSelector, SelectedModel, grid)
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import ColumnarDataset, FeatureColumn
from transmogrifai_tpu_torch.workflow.dag import compute_dag
from transmogrifai_tpu_torch.workflow.workflow import (OpWorkflow,
                                                       OpWorkflowModel)

N_REAL = 10
B = 32
PRIORS = {3: [0.5, 0.3, 0.2], 5: [0.40, 0.25, 0.15, 0.12, 0.08]}


def _mc(n, K, seed, nan_frac=0.05):
    """10 Real columns (some NaN) and a K-class label: class k's score is
    the log of its prior plus a linear part in columns 2k, 2k+1 (mod 10),
    one tanh interaction and Gumbel noise; the label is the argmax."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, N_REAL))
    S = np.log(np.asarray(PRIORS[K]))[None, :] + rng.gumbel(size=(n, K))
    for k in range(K):
        a, b = (2 * k) % N_REAL, (2 * k + 1) % N_REAL
        S[:, k] += 1.2 * X[:, a] - 0.8 * X[:, b]
    S[:, 0] += np.tanh(X[:, 1] * X[:, 2])
    y = S.argmax(1).astype(np.float64)
    X[rng.random((n, N_REAL)) < nan_frac] = np.nan
    return X, y


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_bags(seed, n_trees, n, d, msub, subsample_rate, device):
    """The JAX package's bags and feature subsets, as the port's tensors."""
    bw, idx = jg.rf_bags_and_features(seed, n_trees, n, d, msub,
                                      subsample_rate)
    return (torch.from_numpy(np.array(bw)).to(device),
            torch.from_numpy(np.array(idx)).long().to(device))


def _binned(n, K, seed):
    X, y = _mc(n, K, seed, nan_frac=0.0)
    X = X.astype(np.float32)
    X[:, 3] = np.round(X[:, 3])             # few distinct values
    edges = tk.quantile_bins(torch.from_numpy(X), B)
    return X, y.astype(np.float32), tk.apply_bins(torch.from_numpy(X), edges)


# ---------------------------------------------------------------------------
# K-class forests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[3, 5])
def rf_grid_case(request):
    """Pairs over three folds at K classes: gates by min_instances and
    min_info_gain, a stump, depth 6 with snapshots at 2 and 3."""
    K = request.param
    n = 2500
    X, y, binned = _binned(n, K, 10 + K)
    rng = np.random.default_rng(K)
    folds = rng.integers(0, 3, n)
    W = np.stack([(folds != k).astype(np.float32) for k in range(3)])
    W[:, -40:] = 0.0
    pairs = dict(
        pair_fold=np.array([0, 1, 2, 0, 1], np.int32),
        pair_min_ig=np.array([0.001, 0.01, 0.0, 0.1, 0.0], np.float32),
        pair_min_inst=np.array([10, 100, 1, 10, 1], np.float32),
        pair_depth=np.array([6, 6, 6, 3, 1], np.int32))
    kw = dict(seed=11, n_trees=4, msub=3, subsample_rate=1.0, n_bins=B,
              leaf_levels=(2, 3), **pairs)
    Y = np.eye(K, dtype=np.float32)[y.astype(int)]
    jr = jg.grow_rf_grid(jnp.asarray(binned.numpy().astype(np.int8)),
                         jnp.asarray(Y), jnp.asarray(W), onehot_targets=True,
                         **kw)
    widths = []

    def hist_fn(*args):
        widths.append(args[2].shape[1])
        return tk.seg_level_hists(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tk, "rf_bags_and_features", _jax_bags)
        tr = tk.grow_rf_grid(binned, torch.from_numpy(y),
                             torch.from_numpy(W), hist_fn=hist_fn,
                             n_classes=K, **kw)
    return K, jr, tr, widths


class TestKClassForests:
    def test_trees_equal(self, rf_grid_case):
        K, jr, tr, widths = rf_grid_case
        assert tr.leaf.shape == np.asarray(jr[2]).shape == (5, 4, 64, K)
        np.testing.assert_array_equal(tr.feat.numpy(), np.asarray(jr[0]))
        np.testing.assert_array_equal(tr.thresh.numpy(), np.asarray(jr[1]))
        np.testing.assert_allclose(tr.leaf.numpy(), np.asarray(jr[2]),
                                   rtol=0, atol=1e-6)
        assert (tr.thresh.numpy() < B).sum() > 20
        # K channels a level: K-1 class indicators and the count
        assert widths and set(widths) == {K}

    def test_truncation_snapshots(self, rf_grid_case):
        K, jr, tr, _ = rf_grid_case
        assert sorted(tr.snaps) == sorted(jr[3]) == [2, 3]
        for lv in (2, 3):
            assert tr.snaps[lv].shape == (5, 4, 2 ** lv, K)
            np.testing.assert_allclose(tr.snaps[lv].numpy(),
                                       np.asarray(jr[3][lv]), rtol=0,
                                       atol=1e-6)
            s = tr.snaps[lv].numpy().sum(-1)
            assert np.all((np.abs(s - 1) < 1e-5) | (s == 0))

    def test_forest_predictions_agree_outside_ties(self, rf_grid_case):
        """Both packages' ensembles scored by their own predict paths:
        probabilities within 1e-6, and the same argmax class on every row
        whose top two JAX probabilities differ by more than 1e-6."""
        K, jr, tr, _ = rf_grid_case
        X, y, binned = _binned(2500, K, 10 + K)
        bj = jnp.asarray(binned.numpy().astype(np.int8))
        for p in range(5):
            raw_j = np.asarray(jg.predict_ensemble(
                bj, jr[0][p], jr[1][p], jr[2][p], 6))
            raw_t = tk.predict_ensemble(binned, tr.feat[p], tr.thresh[p],
                                        tr.leaf[p], 6)
            pj = np.clip(raw_j / 4, 1e-9, 1.0)
            pj = pj / pj.sum(1, keepdims=True)
            from transmogrifai_tpu_torch.models.trees import rf_probability
            pt = rf_probability(raw_t, 4).numpy()
            np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
            top2 = np.sort(pj, 1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > 1e-6
            np.testing.assert_array_equal(pt.argmax(1)[clear],
                                          pj.argmax(1)[clear])


@pytest.mark.parametrize("K", [3, 5])
def test_grow_forest_rf_matches_jax(K, monkeypatch):
    """The single K-class forest on row weights, with node compaction
    (N = 200 at depth 10)."""
    X, y, binned = _binned(200, K, 20 + K)
    base_w = (np.arange(200) % 5 != 0).astype(np.float32) * 2
    kw = dict(seed=3, n_trees=3, msub=3, subsample_rate=0.8, max_depth=10,
              n_bins=B, min_info_gain=0.0, min_instances=1.0)
    Y = np.eye(K, dtype=np.float32)[y.astype(int)]
    jf, jt, jlf = jg.grow_forest_rf(
        jnp.asarray(binned.numpy().astype(np.int8)), jnp.asarray(Y),
        jnp.asarray(base_w), onehot_targets=True, **kw)
    monkeypatch.setattr(tk, "rf_bags_and_features", _jax_bags)
    tr = tk.grow_forest_rf(binned, torch.from_numpy(y),
                           torch.from_numpy(base_w), n_classes=K, **kw)
    np.testing.assert_array_equal(tr.feat.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tr.thresh.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tr.leaf.numpy(), np.asarray(jlf), rtol=0,
                               atol=1e-6)
    assert (tr.thresh.numpy()[:, 511:] < B).any()   # the compacted level


@pytest.mark.parametrize("K", [3, 5])
def test_random_forest_estimator_matches_jax(K, monkeypatch):
    """``OpRandomForestClassifier.fit_raw`` at K classes: an ``rf_cls``
    model of K classes whose probabilities equal the JAX estimator's
    within 1e-6."""
    X, y = _mc(1500, K, 30 + K, nan_frac=0.0)
    X = X.astype(np.float32)
    kw = dict(num_trees=4, max_depth=5, min_instances_per_node=5,
              min_info_gain=0.001)
    jmod = JRF(**kw).fit_raw(X, y.astype(np.float32))
    monkeypatch.setattr(tk, "rf_bags_and_features", _jax_bags)
    tmod = OpRandomForestClassifier(**kw).fit_raw(X, y, device="cpu")
    assert tmod.mode == "rf_cls" and tmod.n_classes == jmod.n_classes == K
    np.testing.assert_array_equal(tmod.feat.numpy(), np.asarray(jmod.feat))
    jb = jmod.predict_batch(X)
    tb = tmod.predict_batch(torch.from_numpy(X))
    np.testing.assert_allclose(tb.probability.numpy(),
                               np.asarray(jb.probability), rtol=0, atol=1e-6)
    assert tb.probability.shape == (1500, K)


# ---------------------------------------------------------------------------
# softmax logistic regression
# ---------------------------------------------------------------------------

REGS = np.array([0.001, 0.01, 0.1, 0.2] * 2, np.float32)
ALPHAS = np.array([0.0] * 4 + [0.1, 0.5, 0.1, 0.5], np.float32)


def _lr_problem(K, n=1500):
    X, y = _mc(n, K, 40 + K, nan_frac=0.0)
    X = X.astype(np.float32)
    X[:, 4] = X[:, 4] * 30 + 5              # a badly scaled column
    rng = np.random.default_rng(K)
    folds = rng.integers(0, 3, n)
    W = np.stack([(folds != k).astype(np.float32) for k in range(3)])
    W[:, :40] = 0.0
    return X, y.astype(np.int64), W


def _near_ties(P, tol):
    top2 = np.sort(P, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] <= tol


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("standardization", [True, False])
def test_fit_softmax_grid_matches_jax(K, standardization):
    """Every (fold, candidate) softmax fit: class probabilities within
    1e-4, the argmax label equal outside near-ties, iterations within
    one."""
    X, y, W = _lr_problem(K)
    kw = dict(max_iter=150, tol=1e-5, fit_intercept=True,
              standardization=standardization)
    jz, jit_ = jl.fit_softmax_grid(jnp.asarray(X), jnp.asarray(y), K,
                                   jnp.asarray(W), jnp.asarray(REGS),
                                   jnp.asarray(ALPHAS), **kw)
    tz, tit = tl.fit_softmax_grid(*_t(X, y), K, *_t(W, REGS, ALPHAS), **kw)
    assert tz.shape == (3, 8, K, len(y))
    jp = np.asarray(jnp.exp(jz - jz.max(2, keepdims=True)))
    jp = jp / jp.sum(2, keepdims=True)
    tp = torch.softmax(tz, dim=2).numpy()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    clear = ~_near_ties(np.moveaxis(jp, 2, -1), 1e-4)
    np.testing.assert_array_equal(tp.argmax(2)[clear], jp.argmax(2)[clear])
    assert abs(int(tit) - int(jit_)) <= 1


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("reg,alpha", [(0.001, 0.0), (0.1, 0.0),
                                       (0.01, 0.5)])
def test_fit_multinomial_logreg_matches_jax(K, reg, alpha):
    """The sequential multinomial fit (blockwise Newton for pure L2,
    FISTA with an L1 part): coefficients and intercepts within 1e-3,
    scores of ``softmax_predict_proba`` within 1e-4."""
    X, y, W = _lr_problem(K)
    Xs = (X - X.mean(0)) / X.std(0)
    kw = dict(reg_param=reg, elastic_net_param=alpha, max_iter=50, tol=1e-6)
    j = jl.fit_multinomial_logreg(jnp.asarray(Xs), jnp.asarray(y), K,
                                  sample_weight=jnp.asarray(W[1]), **kw)
    t = tl.fit_multinomial_logreg(*_t(Xs, y), K,
                                  sample_weight=torch.from_numpy(W[1]), **kw)
    assert t.coef.shape == (K, N_REAL) and t.intercept.shape == (K,)
    np.testing.assert_allclose(t.coef.numpy(), np.asarray(j.coef), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(t.intercept.numpy(), np.asarray(j.intercept),
                               rtol=0, atol=1e-3)
    jp, jz = jl.softmax_predict_proba(j.coef, j.intercept, jnp.asarray(Xs))
    tp, tz = tl.softmax_predict_proba(t.coef, t.intercept,
                                      torch.from_numpy(Xs))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-4)
    # the same model in both packages scores alike (1e-6)
    tp2, _ = tl.softmax_predict_proba(*_t(np.asarray(j.coef),
                                          np.asarray(j.intercept)),
                                      torch.from_numpy(Xs))
    np.testing.assert_allclose(tp2.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("K", [3, 5])
def test_logistic_regression_estimator_multinomial(K):
    """``OpLogisticRegression.fit_raw`` at K classes: a (K, D) raw-space
    model (unstandardized class by class) within 1e-3 of the JAX
    estimator's, probabilities within 1e-4, argmax predictions."""
    X, y, W = _lr_problem(K)
    jmod = JLR(reg_param=0.01).fit_raw(X, y.astype(np.float32), W[0])
    tmod = OpLogisticRegression(reg_param=0.01).fit_raw(
        X, y.astype(np.float32), W[0], device="cpu")
    assert tmod.coef.shape == (K, N_REAL) and len(tmod.intercept) == K
    np.testing.assert_allclose(tmod.coef.numpy(), np.asarray(jmod.coef),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(tmod.intercept, jmod.intercept, rtol=0,
                               atol=1e-3)
    jb, tb = jmod.predict_batch(X), tmod.predict_batch(torch.from_numpy(X))
    np.testing.assert_allclose(tb.probability.numpy(),
                               np.asarray(jb.probability), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(
        tb.prediction.numpy(), tb.probability.argmax(1).numpy())


# ---------------------------------------------------------------------------
# metrics and the evaluator
# ---------------------------------------------------------------------------

def _labels(K, n=1800, seed=5):
    rng = np.random.default_rng(seed + K)
    y = rng.choice(K, n, p=PRIORS[K]).astype(np.int64)
    P = rng.dirichlet(np.ones(K), n).astype(np.float32)
    P[::7] = np.round(P[::7], 1)              # ties of scores
    pred = np.where(rng.random(n) < 0.6, y, rng.integers(0, K, n))
    return y, pred, P


@pytest.mark.parametrize("K", [3, 5])
def test_multiclass_metric_grid_matches_jax(K):
    """(F, C, N) predicted labels and (F, N) weights -> (F, C) metrics,
    every device metric (1e-6: float32 sums in the JAX grid)."""
    rng = np.random.default_rng(K)
    y = rng.choice(K, 1500, p=PRIORS[K]).astype(np.int64)
    preds = np.where(rng.random((3, 4, 1500)) < 0.5, y,
                     rng.integers(0, K, (3, 4, 1500)))
    W = (rng.random((3, 1500)) < 0.4).astype(np.float32) * \
        rng.integers(1, 3, (3, 1500))
    for metric in tm.MULTICLASS_METRICS:
        want = np.asarray(jm.multiclass_metric_grid(
            jnp.asarray(y), jnp.asarray(preds), jnp.asarray(W), K, metric))
        got = tm.multiclass_metric_grid(*_t(y, preds, W), K, metric)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert tm.multiclass_metric_grid(*_t(y, preds, W), K, "AuPR") is None


@pytest.mark.parametrize("K", [3, 5])
def test_multiclass_metrics_match_jax(K):
    """The full set and the confusion matrix (float64 both: 1e-12), with
    fractional weights and a label outside the class space (dropped)."""
    y, pred, _ = _labels(K)
    y[3] = -1
    w = np.random.default_rng(K).random(len(y))
    want = jm.multiclass_metrics(y, pred, K, w)
    got = tm.multiclass_metrics(*_t(y, pred), K, torch.from_numpy(w))
    assert set(got) == set(want)
    for k in ("Accuracy", "Error", "Precision", "Recall", "F1"):
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k
    np.testing.assert_allclose(got["confusion"], want["confusion"],
                               rtol=1e-12)


@pytest.mark.parametrize("K", [3, 5])
def test_threshold_metrics_match_jax(K):
    """Top-N / threshold counts, with tied scores and an unseen label:
    equal counts at every threshold."""
    y, _, P = _labels(K)
    y[5] = K + 2
    want = jm.multiclass_threshold_metrics(y, P, top_ns=(1, 2, 3))
    got = tm.multiclass_threshold_metrics(*_t(y, P), top_ns=(1, 2, 3))
    assert got == want


def test_evaluator_class_count_ignores_a_missing_top_class():
    """The class count comes from ``num_classes``, else from the labels,
    predictions and probability width together: a slice whose labels
    never reach the top class still scores K classes."""
    from transmogrifai_tpu_torch.models.prediction import PredictionBatch

    y = np.array([0, 1, 0, 1, 1], np.float64)
    P = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.3, 0.3, 0.4],
                      [0.2, 0.7, 0.1], [0.1, 0.2, 0.7]])
    batch = PredictionBatch(prediction=P.argmax(1).to(torch.float64),
                            probability=P, raw_prediction=P)
    data = ColumnarDataset({
        "label": FeatureColumn.from_values(ft.RealNN, y),
        "pred": FeatureColumn(ft.Prediction, batch)})
    ev = Evaluators.MultiClassification.f1()
    ev.label_col, ev.prediction_col = "label", "pred"
    out = ev.evaluate(data)
    assert np.asarray(out["confusionMatrix"]).shape == (3, 3)
    assert out["Accuracy"] == pytest.approx(3 / 5)
    assert out["LogLoss"] == pytest.approx(
        -np.mean(np.log([0.7, 0.8, 0.3, 0.7, 0.2])), rel=1e-6)
    assert Evaluators.MultiClassification.error().larger_better is False


# ---------------------------------------------------------------------------
# DataCutter, stratified folds and split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(max_label_categories=3),
                                dict(min_label_fraction=0.2)])
def test_data_cutter_matches_jax(kw):
    """Kept labels, zeroed weights and the summary, bit for bit."""
    _, y = _mc(3000, 5, 7)
    j, t = jsp.DataCutter(**kw), tsp.DataCutter(**kw)
    jtr, jho = j.split_indices(len(y), y)
    ttr, tho = t.split_indices(len(y), y)
    np.testing.assert_array_equal(ttr, jtr)
    mask = np.zeros(len(y), bool)
    mask[ttr] = True
    np.testing.assert_array_equal(t.train_weights(y, mask),
                                  j.train_weights(y, mask))
    assert t.summary.to_json() == j.summary.to_json()
    if kw:
        assert t.summary.details["labelsDropped"]


@pytest.mark.parametrize("K", [3, 5])
def test_stratified_folds_and_split_match_jax(K):
    """K-class stratified fold ids and the stratified train/validation
    split: the same rows in both packages, every label on both sides."""
    _, y = _mc(2000, K, 8)
    np.testing.assert_array_equal(
        tv.make_folds(len(y), 3, y=y, stratify=True, seed=5),
        jv.make_folds(len(y), 3, y=y, stratify=True, seed=5))
    j = jv.OpTrainValidationSplit(train_ratio=0.75, stratify=True, seed=9)
    t = tv.OpTrainValidationSplit(train_ratio=0.75, stratify=True, seed=9)
    mask = t.split_mask(len(y), y)
    np.testing.assert_array_equal(mask, j._split_mask(len(y), y))
    for k in range(K):
        share = mask[y == k].mean()
        assert abs(share - 0.75) < 0.01
    plain = tv.OpTrainValidationSplit(train_ratio=0.75, seed=9)
    np.testing.assert_array_equal(
        plain.split_mask(len(y), y),
        jv.OpTrainValidationSplit(train_ratio=0.75, seed=9)._split_mask(
            len(y), y))


# ---------------------------------------------------------------------------
# the default multiclass selector, end to end
# ---------------------------------------------------------------------------

def _dataset(cls_ds, cls_col, types, X, y):
    cols = {f"x{j}": cls_col.from_values(types.Real, X[:, j])
            for j in range(N_REAL)}
    cols["label"] = cls_col.from_values(types.RealNN, y)
    return cls_ds(cols)


def _pipeline(fb, transmogrify_fn, checker_cls, selector):
    label = fb.RealNN("label").as_response()
    preds = [fb.Real(f"x{j}").as_predictor() for j in range(N_REAL)]
    checked = label.transform_with(checker_cls(max_correlation=0.99),
                                   transmogrify_fn(preds))
    return label.transform_with(selector, checked)


#: per K: the grid (None: the selector's default grid) and the row count
SELECTOR_CASES = {
    3: (None, 1500),
    5: (dict(lr=dict(reg_param=[0.01, 0.1], elastic_net_param=[0.0, 0.5]),
             rf=dict(num_trees=[6], max_depth=[3, 6],
                     min_instances_per_node=[10],
                     min_info_gain=[0.001, 0.01])), 2000),
}


def _models(K, lr_cls, rf_cls, grid_fn, families=("lr", "rf")):
    grids, _ = SELECTOR_CASES[K]
    if grids is None and families == ("lr", "rf"):
        return None
    grids = grids or dict(lr=dict(reg_param=[0.01, 0.1]),
                          rf=dict(num_trees=[6], max_depth=[4]))
    out = []
    if "lr" in families:
        out.append((lr_cls(), grid_fn(**grids["lr"])))
    if "rf" in families:
        out.append((rf_cls(), grid_fn(**grids["rf"])))
    return out


def _train(K, port, families=("lr", "rf")):
    _, n = SELECTOR_CASES[K]
    train = _mc(n, K, 50 + K)
    if port:
        tt.set_device("cpu")
        sel = MultiClassificationModelSelector.with_cross_validation(
            models_and_parameters=_models(K, OpLogisticRegression,
                                          OpRandomForestClassifier, grid,
                                          families))
        pred = _pipeline(FeatureBuilder, transmogrify, SanityChecker, sel)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tk, "rf_bags_and_features", _jax_bags)
            model = OpWorkflow().set_result_features(pred).set_input_data(
                _dataset(ColumnarDataset, FeatureColumn, ft, *train)).train()
        return model, sel, pred
    sel = JMCMS.with_cross_validation(
        models_and_parameters=_models(K, JLR, JRF, jgrid, families))
    pred = _pipeline(JFB, jtransmogrify, JSanityChecker, sel)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMOG_COST_HISTORY", "0")
        mp.setenv("TMOG_SYNC_SWEEP", "1")
        model = JWorkflow().set_result_features(pred).set_input_data(
            _dataset(JDataset, JColumn, jft, *train)).train()
    return model, sel, pred


def _hold(K):
    _, n = SELECTOR_CASES[K]
    X, y = _mc(n // 2, K, 60 + K)
    return (_dataset(JDataset, JColumn, jft, X, y),
            _dataset(ColumnarDataset, FeatureColumn, ft, X, y))


@pytest.fixture(scope="module", params=[3, 5])
def selector_runs(request):
    K = request.param
    jhold, thold = _hold(K)
    out = {}
    for port in (False, True):
        model, sel, pred = _train(K, port)
        ev = (Evaluators.MultiClassification.f1() if port
              else JEvaluators.MultiClassification.f1())
        scored, metrics = model.score_and_evaluate(
            ev, data=thold if port else jhold)
        out[port] = dict(model=model, sel=sel, pred=pred, scored=scored,
                         metrics=metrics)
    return K, out


def _summary(run):
    return run["sel"].metadata["model_selector_summary"]


class TestMultiClassSelector:
    def test_summary_and_cutter(self, selector_runs):
        K, r = selector_runs
        j, t = _summary(r[False]), _summary(r[True])
        assert set(t) == set(j)
        assert t["problemType"] == j["problemType"] == "multiclass"
        assert t["validationType"] == j["validationType"]
        assert t["dataPrepResults"] == j["dataPrepResults"]
        assert t["dataPrepResults"]["splitter"] == "DataCutter"
        assert len(t["dataPrepResults"]["labelsKept"]) == K
        assert not any("error" in v for v in t["validationResults"])
        if SELECTOR_CASES[K][0] is None:      # the default grid
            assert len(t["validationResults"]) == 26

    def test_same_winner_and_cv_f1(self, selector_runs):
        _, r = selector_runs
        j, t = _summary(r[False]), _summary(r[True])
        assert (t["bestModelType"], t["bestModelParams"]) == (
            j["bestModelType"], j["bestModelParams"])
        for a, b in zip(t["validationResults"], j["validationResults"]):
            assert (a["modelType"], a["params"], a["metricName"]) == (
                b["modelType"], b["params"], b["metricName"])
            np.testing.assert_allclose(a["foldValues"], b["foldValues"],
                                       rtol=0, atol=1e-4)
            assert abs(a["metricValue"] - b["metricValue"]) <= 1e-4

    def test_groups_ran(self, selector_runs):
        K, r = selector_runs
        meta = r[True]["sel"].metadata
        assert {"SoftmaxGridGroup", "RFGridGroup"} <= set(
            meta["sweep_seconds"])
        assert meta["group_errors"] == {}
        assert meta["hist_levels"] > 0 and meta["rf_trees"] > 0

    def test_holdout_scores_and_metrics(self, selector_runs):
        """Holdout probabilities within 1e-4 (the refit winner: an
        iterative multinomial fit or an identical forest), the same
        metric keys, F1 within 1e-3 (a near-tie row's share)."""
        K, r = selector_runs
        jp = np.asarray(r[False]["scored"][r[False]["pred"].name]
                        .values.probability)
        tp = r[True]["scored"][r[True]["pred"].name].values.probability
        assert tp.shape == (len(jp), K)
        np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1e-4)
        jmx, tmx = r[False]["metrics"], r[True]["metrics"]
        assert set(tmx) == set(jmx)
        for k in ("F1", "Accuracy", "Error", "Precision", "Recall",
                  "LogLoss"):
            assert tmx[k] == pytest.approx(jmx[k], abs=1e-3), k
        assert tmx["F1"] > 0.5
        assert (np.asarray(tmx["confusionMatrix"]).shape == (K, K))
        assert tmx["ThresholdMetrics"]["topNs"] == [1, 3]

    def test_train_and_holdout_summary_metrics(self, selector_runs):
        _, r = selector_runs
        j, t = _summary(r[False]), _summary(r[True])
        for key in ("holdoutMetrics", "trainEvaluationMetrics"):
            assert set(t[key]) == set(j[key])
            for m, v in j[key].items():
                assert t[key][m] == pytest.approx(v, abs=1e-3), (key, m)

    def test_local_scorer_rows(self, selector_runs):
        """The local scorer's rows carry K probabilities and raw scores."""
        K, r = selector_runs
        X, _ = _mc(4, K, 70)
        fn = score_function(r[True]["model"])
        row = {f"x{j}": (None if np.isnan(X[0, j]) else float(X[0, j]))
               for j in range(N_REAL)}
        (out,) = fn(row).values()
        assert {f"probability_{k}" for k in range(K)} <= set(out)
        assert {f"rawPrediction_{k}" for k in range(K)} <= set(out)
        assert out["prediction"] in range(K)
        assert sum(out[f"probability_{k}"] for k in range(K)) == \
            pytest.approx(1.0, abs=1e-6)


def test_sweep_declines_softmax_group_past_its_budget(monkeypatch):
    """Past ``MAX_LOGIT_ELEMS`` the softmax group declines and the
    selector fits its candidates one by one (no group error)."""
    from transmogrifai_tpu_torch.selector import grid_groups as tgg

    monkeypatch.setattr(tgg.SoftmaxGridGroup, "MAX_LOGIT_ELEMS", 10)
    tt.set_device("cpu")
    X, y = _mc(600, 3, 80)
    sel = MultiClassificationModelSelector.with_cross_validation(
        models_and_parameters=[(OpLogisticRegression(),
                                grid(reg_param=[0.01, 0.1]))])
    pred = _pipeline(FeatureBuilder, transmogrify, SanityChecker, sel)
    OpWorkflow().set_result_features(pred).set_input_data(
        _dataset(ColumnarDataset, FeatureColumn, ft, X, y)).train()
    meta = sel.metadata
    assert "SoftmaxGridGroup" not in meta["sweep_seconds"]
    assert meta["group_errors"] == {}
    res = meta["model_selector_summary"]["validationResults"]
    assert len(res) == 2 and all(0 < r["metricValue"] <= 1 for r in res)


# ---------------------------------------------------------------------------
# saved models across the packages, and convert.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """For each family as the only one (so it wins), at K = 5: the JAX
    package's trained model saved, and the port's."""
    out = {}
    root = tmp_path_factory.mktemp("mc_artifacts")
    for fam in ("lr", "rf"):
        for port in (False, True):
            model, sel, pred = _train(5, port, families=(fam,))
            path = str(root / f"{fam}_{'torch' if port else 'jax'}")
            model.save(path)
            out[(fam, port)] = (model, sel, pred, path)
    return out


@pytest.mark.parametrize("fam", ["lr", "rf"])
def test_artifacts_cross_both_ways(fam, artifacts):
    """A multiclass model saved by either package loads in the other and
    scores the holdout within 1e-6 of its own package's probabilities;
    the port's load of its own save scores bitwise equal."""
    tt.set_device("cpu")
    jhold, thold = _hold(5)
    jmodel, _, jpred, jpath = artifacts[(fam, False)]
    tmodel, _, tpred, tpath = artifacts[(fam, True)]
    want_j = np.asarray(jmodel.score(jhold)[jpred.name].values.probability)
    got = OpWorkflowModel.load(jpath).score(thold)[jpred.name].values
    np.testing.assert_allclose(got.probability.numpy(), want_j, rtol=0,
                               atol=1e-6)
    want_t = tmodel.score(thold)[tpred.name].values
    back = JWorkflowModel.load(tpath).score(jhold)[tpred.name].values
    np.testing.assert_allclose(np.asarray(back.probability),
                               want_t.probability.numpy(), rtol=0, atol=1e-6)
    again = OpWorkflowModel.load(tpath).score(thold)[tpred.name].values
    assert torch.equal(again.probability, want_t.probability)
    sel = next(s for s in OpWorkflowModel.load(tpath).stages
               if isinstance(s, SelectedModel))
    if fam == "lr":
        assert isinstance(sel.inner, LogisticRegressionModel)
        assert tuple(sel.inner.coef.shape)[0] == 5
    else:
        assert isinstance(sel.inner, TreeEnsembleModel)
        assert sel.inner.mode == "rf_cls" and sel.inner.n_classes == 5
        assert sel.inner.leaf.shape[-1] == 5


@pytest.mark.parametrize("fam", ["lr", "rf"])
def test_convert_multiclass_models(fam, artifacts):
    """The JAX package's fitted stages carried into the port through
    ``convert.py`` score the holdout to the JAX package's probabilities
    (1e-6)."""
    tt.set_device("cpu")
    jhold, thold = _hold(5)
    jmodel, jsel, jpred, _ = artifacts[(fam, False)]
    want = np.asarray(jmodel.score(jhold)[jpred.name].values.probability)

    def stage(name):
        return next(s for s in jmodel.stages if type(s).__name__ == name)

    sel = MultiClassificationModelSelector.with_cross_validation(
        models_and_parameters=_models(5, OpLogisticRegression,
                                      OpRandomForestClassifier, grid,
                                      (fam,)))
    pred = _pipeline(FeatureBuilder, transmogrify, SanityChecker, sel)
    ests = {type(s).__name__: s for s in compute_dag([pred]).all_stages()}
    js, jsm = stage("SanityCheckerModel"), stage("SelectedModel")
    inner = jsm.inner
    if fam == "lr":
        model = convert.logistic_regression_model(
            np.asarray(inner.coef), np.asarray(inner.intercept))
    else:
        model = convert.tree_ensemble_model(
            inner.mode, np.asarray(inner.edges), np.asarray(inner.feat),
            np.asarray(inner.thresh), np.asarray(inner.leaf),
            inner.base_score, inner.n_classes)
    fitted = [
        convert.real_vectorizer(ests["RealVectorizer"],
                                list(stage("RealVectorizerModel").fills)),
        convert.sanity_checker(ests["SanityChecker"], list(js.keep_indices)),
        convert.selected_model(sel, model, jsm.best_name, jsm.best_params,
                               jsel.metadata["model_selector_summary"]),
    ]
    scored = convert.workflow_model([pred], fitted).score(thold)
    got = scored[pred.name].values.probability.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
