"""The port's decision trees (``OpDecisionTreeClassifier``,
``OpDecisionTreeRegressor``) against the JAX package's on the CPU, at a
few thousand rows x at most 16 columns and depth <= 4.

Both grow one unbagged tree on the general grower (bag mode ``"none"``):
G = the one-hot classes (or the label) times the row weights, H = the
weights in every column, the count C = the weights, gain regulariser
1e-3, mean leaves G / C.  Tolerances, and why:

 * Classification on integer weights: every histogram sum and leaf sum is
   an exact integer, and the gain is the same float32 arithmetic in the
   same order, so ``feat``/``thresh`` are equal exactly and leaves within
   1e-6 (one float32 division each); probabilities within 1e-6.
 * Regression: the label sums are float32 sums taken in another order, so
   trees are held equal up to exact gain ties
   (``test_torch_gbt_grid._assert_same_tree``), leaves and predictions
   within 1e-5.
 * Binning: a decision tree takes the dense sketch, as the JAX package's
   ``_prep_tree_inputs`` does, even where the boosted fits' and forests'
   ``prep_tree_inputs`` takes the nonzero-aware one (a wide mostly zero
   matrix, with ``_SPARSE_MIN_ELEMS`` patched down in both packages):
   edges equal bitwise.

torch runs on one intra-op thread (a module fixture).
"""
import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from test_torch_gbt_grid import _assert_same_tree
from transmogrifai_tpu.models import gbdt_kernels as jg
from transmogrifai_tpu.models import trees as jtr
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.models import trees as ttr

B = 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


def _classes(n, K, seed, d=12):
    """Normal columns (one rounded to few values) and a K-class label:
    the argmax of linear class scores plus Gumbel noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 3] = np.round(X[:, 3])
    S = rng.gumbel(size=(n, K))
    for k in range(K):
        S[:, k] += 1.5 * X[:, k] - 0.7 * X[:, (k + 4) % d]
    return X, S.argmax(1).astype(np.float32)


def _fit_both(est_kw, X, y, w=None, classification=True):
    jcls = (jtr.OpDecisionTreeClassifier if classification
            else jtr.OpDecisionTreeRegressor)
    tcls = (ttr.OpDecisionTreeClassifier if classification
            else ttr.OpDecisionTreeRegressor)
    jm = jcls(**est_kw).fit_raw(X, y, w)
    est = tcls(**est_kw)
    tm = est.fit_raw(X, y, w, device="cpu")
    return jm, tm, est


@pytest.mark.parametrize("K,weights", [(2, False), (3, False), (3, True)])
def test_classifier_matches_jax(K, weights):
    """K = 2 and 3 classes (and fold-like 0/1 row weights at K = 3):
    mode ``rf_cls`` of one tree, the JAX package's edges bitwise, equal
    splits, leaves the K class shares within 1e-6, probabilities within
    1e-6 and the same predicted classes."""
    X, y = _classes(2500, K, 10 + K)
    w = None
    if weights:
        w = (np.random.default_rng(K).random(len(y)) < 0.67).astype(
            np.float32)
    kw = dict(max_depth=4, min_instances_per_node=10, min_info_gain=0.001)
    jm, tm, est = _fit_both(kw, X, y, w)
    assert tm.mode == jm.mode == "rf_cls" and tm.n_classes == K
    assert tuple(tm.feat.shape) == (1, 15)
    assert tuple(tm.leaf.shape) == (1, 16, K)
    assert est.metadata["hist_levels"] == 4
    np.testing.assert_array_equal(tm.edges, np.asarray(jm.edges))
    np.testing.assert_array_equal(tm.feat.numpy(), np.asarray(jm.feat))
    np.testing.assert_array_equal(tm.thresh.numpy(), np.asarray(jm.thresh))
    np.testing.assert_allclose(tm.leaf.numpy(), np.asarray(jm.leaf),
                               rtol=0, atol=1e-6)
    assert (tm.thresh.numpy() < B).sum() >= 7
    jp, tp = jm.predict_batch(X), tm.predict_batch(torch.from_numpy(X))
    np.testing.assert_allclose(tp.probability.numpy(),
                               np.asarray(jp.probability), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tp.prediction.numpy(),
                                  np.asarray(jp.prediction))


def test_gates_bite():
    """min_instances_per_node and min_info_gain each close nodes that the
    ungated tree splits, in both packages alike."""
    X, y = _classes(2500, 3, 21)
    counts = {}
    for kw in (dict(), dict(min_instances_per_node=150),
               dict(min_info_gain=0.02)):
        jm, tm, _ = _fit_both(dict(max_depth=4, **kw), X, y)
        np.testing.assert_array_equal(tm.thresh.numpy(),
                                      np.asarray(jm.thresh))
        counts[tuple(kw)] = int((tm.thresh < B).sum())
    assert counts[()] > counts[("min_instances_per_node",)]
    assert counts[()] > counts[("min_info_gain",)]


def test_regressor_matches_jax():
    """A real label: mode ``rf_reg`` of one tree, equal splits up to ties,
    leaves (the weighted mean label) and predictions within 1e-5."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(3000, 10)).astype(np.float32)
    y = (20 + 4 * X[:, 0] - 3 * X[:, 1] * (X[:, 2] > 0)
         + rng.normal(size=3000)).astype(np.float32)
    jm, tm, _ = _fit_both(dict(max_depth=4, min_instances_per_node=20), X,
                          y, classification=False)
    assert tm.mode == jm.mode == "rf_reg"
    binned = tk.apply_bins(torch.from_numpy(X), tm.edges).numpy()
    ties = _assert_same_tree(
        np.asarray(jm.feat)[0], np.asarray(jm.thresh)[0],
        np.asarray(jm.leaf)[0], tm.feat[0].numpy(), tm.thresh[0].numpy(),
        tm.leaf[0].numpy(), binned, np.ones(len(y), bool), 4)
    assert ties == 0
    np.testing.assert_allclose(
        tm.predict_batch(torch.from_numpy(X)).prediction.numpy(),
        np.asarray(jm.predict_batch(X).prediction), rtol=1e-5)


def test_dense_sketch_edges(monkeypatch):
    """On a wide mostly zero matrix that the sparse rule sends to the
    nonzero-aware sketch (``_SPARSE_MIN_ELEMS`` patched down in both
    packages), a decision tree bins through the dense sketch, as the JAX
    package's does: its edges equal ``quantile_bins``' and the JAX tree's
    bitwise and differ from the nonzero-aware edges ``prep_tree_inputs``
    takes; the trees are equal and ``SKETCH_KINDS`` does not move."""
    monkeypatch.setattr(jtr, "_SPARSE_MIN_ELEMS", 1000)
    monkeypatch.setattr(ttr, "_SPARSE_MIN_ELEMS", 1000)
    rng = np.random.default_rng(7)
    X = np.where(rng.random((3000, 16)) < 0.12,
                 rng.lognormal(0, 1, (3000, 16)), 0.0).astype(np.float32)
    X[:, 3] = -X[:, 3]
    X[rng.random(3000) < 0.05, 5] = np.nan
    y = (X[:, 0] + 0.7 * X[:, 1] - np.nan_to_num(X[:, 5])
         + 0.3 * rng.normal(size=3000) > 0.2).astype(np.float32)
    Xt = torch.from_numpy(X)
    assert ttr.sketch_kind(Xt) == "sparse_aware"
    kinds = dict(ttr.SKETCH_KINDS)
    jm, tm, _ = _fit_both(dict(max_depth=4), X, y)
    assert ttr.SKETCH_KINDS == kinds
    dense = tk.quantile_bins(Xt, B)
    np.testing.assert_array_equal(tm.edges, dense)
    np.testing.assert_array_equal(tm.edges, np.asarray(jm.edges))
    np.testing.assert_array_equal(dense, jg.quantile_bins(X, B))
    sparse_edges, _ = ttr.prep_tree_inputs(Xt, B)
    assert not np.array_equal(sparse_edges, dense)
    np.testing.assert_array_equal(tm.feat.numpy(), np.asarray(jm.feat))
    np.testing.assert_array_equal(tm.thresh.numpy(), np.asarray(jm.thresh))
    np.testing.assert_allclose(tm.leaf.numpy(), np.asarray(jm.leaf),
                               rtol=0, atol=1e-6)


def test_copy_keeps_the_single_tree():
    """The selector's ``copy`` of a decision tree is a decision tree (one
    tree, every feature, no bootstrap) with the grid point's params."""
    est = ttr.OpDecisionTreeClassifier(max_depth=3).copy(
        max_depth=6, min_instances_per_node=10)
    assert type(est) is ttr.OpDecisionTreeClassifier
    assert (est.max_depth, est.min_instances_per_node) == (6, 10)
    assert est.num_trees == 1 and est.subsample_rate == 0.0
    assert est.feature_subset_strategy == "all"
