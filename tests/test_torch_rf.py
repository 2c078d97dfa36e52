"""The port's random-forest growth and the selector's splits and folds
against the JAX package on the CPU.

Regime: integer weights (0/1 fold masks times Poisson bag counts), so
every histogram and leaf sum is an exact integer in float32, gains are
computed by the same float32 operations in the same order, and ties of
equal gain break to the same (first) candidate: ``feat``/``thresh`` must
be equal exactly and leaves within 1e-6.  (Fractional weights — a
DataBalancer up-weighting a minority class — would hold trees only up to
ties of equal gain.)  The port draws its bags from torch generators, so
the tests hand it the JAX package's bags and feature subsets.  Fold ids,
holdout masks and balancer weights are numpy-seeded in both packages and
must be bit-identical.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from transmogrifai_tpu.models import gbdt_kernels as jg
from transmogrifai_tpu.selector import splitters as jsp
from transmogrifai_tpu.selector import validators as jv
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.selector import splitters as tsp
from transmogrifai_tpu_torch.selector import validators as tv

B = 32


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 1] = np.round(X[:, 1])            # few distinct values: empty bins
    y = ((X[:, 0] + 0.7 * X[:, 2] - 0.5 * X[:, 1] + rng.normal(size=n))
         > 0.3).astype(np.float32)
    edges = tk.quantile_bins(torch.from_numpy(X), B)
    return X, y, edges, tk.apply_bins(torch.from_numpy(X), edges)


def _jax_bags_fn(monkeypatch):
    def bags(seed, n_trees, n, d, msub, rate, device):
        bw, idx = jg.rf_bags_and_features(seed, n_trees, n, d, msub, rate)
        return (torch.from_numpy(np.array(bw)),
                torch.from_numpy(np.array(idx)).long())
    monkeypatch.setattr(tk, "rf_bags_and_features", bags)


@pytest.fixture(scope="module")
def grid_case():
    """Pairs over three folds: stumps (depth 0 and 1), gating by
    min_instances and min_info_gain, depth 6 with snapshots at 2 and 3."""
    n, d = 2500, 30
    X, y, edges, binned = _data(n, d, 3)
    rng = np.random.default_rng(4)
    folds = rng.integers(0, 3, n)
    W = np.stack([(folds != k).astype(np.float32) for k in range(3)])
    W[:, -40:] = 0.0
    pairs = dict(
        pair_fold=np.array([0, 1, 2, 0, 1, 2, 0], np.int32),
        pair_min_ig=np.array([0.001, 0.01, 0.0, 0.1, 0.001, 0.0, 0.0],
                             np.float32),
        pair_min_inst=np.array([10, 100, 1, 10, 5, 1, 1], np.float32),
        pair_depth=np.array([6, 6, 6, 3, 1, 0, 4], np.int32))
    kw = dict(seed=11, n_trees=4, msub=5, subsample_rate=1.0, n_bins=B,
              leaf_levels=(2, 3), **pairs)
    Y = np.eye(2, dtype=np.float32)[y.astype(int)]
    jr = jg.grow_rf_grid(jnp.asarray(binned.numpy().astype(np.int8)),
                         jnp.asarray(Y), jnp.asarray(W), onehot_targets=True,
                         **kw)
    calls = []

    def hist_fn(*args):
        calls.append(args[3])
        return tk.seg_level_hists(*args)

    with pytest.MonkeyPatch.context() as mp:
        _jax_bags_fn(mp)
        tr = tk.grow_rf_grid(binned, torch.from_numpy(y),
                             torch.from_numpy(W), hist_fn=hist_fn, **kw)
    return jr, tr, pairs, calls


class TestGrowRFGrid:
    def test_trees_equal(self, grid_case):
        jr, tr, *_ = grid_case
        assert tr.feat.shape == np.asarray(jr[0]).shape == (7, 4, 63)
        np.testing.assert_array_equal(tr.feat.numpy(), np.asarray(jr[0]))
        np.testing.assert_array_equal(tr.thresh.numpy(), np.asarray(jr[1]))
        np.testing.assert_allclose(tr.leaf.numpy(), np.asarray(jr[2]),
                                   rtol=0, atol=1e-6)

    def test_truncation_snapshots(self, grid_case):
        jr, tr, *_ = grid_case
        assert sorted(tr.snaps) == sorted(jr[3]) == [2, 3]
        for lv in (2, 3):
            assert tr.snaps[lv].shape == (7, 4, 2 ** lv, 2)
            np.testing.assert_allclose(tr.snaps[lv].numpy(),
                                       np.asarray(jr[3][lv]), rtol=0,
                                       atol=1e-6)

    def test_gating_and_depth_limits(self, grid_case):
        """Stumps split nothing or once; no pair splits past its depth;
        min_instances 100 and min_info_gain 0.1 grow fewer splits than
        the looser gates; levels past a pair's depth, or below a level
        whose nodes all closed, build no histogram."""
        _, tr, pairs, calls = grid_case
        splits = (tr.thresh < B).numpy()
        for p, depth in enumerate(pairs["pair_depth"]):
            assert not splits[p][:, 2 ** depth - 1:].any(), p
        assert not splits[5].any() and splits[4][:, 0].all()
        assert splits[1].sum() < splits[0].sum()
        assert splits[3].sum() < splits[6][:, :7].sum()
        # one histogram per level built: at most 4 trees x (6+6+6+3+1+0+4)
        # levels, fewer where every node of a tree closed early
        assert tr.levels == len(calls) < 4 * 26
        assert max(calls) == 32

    def test_feature_subsets(self, grid_case):
        """Split features lie in each tree's subset, mapped to full ids."""
        _, tr, *_ = grid_case
        _, idx = jg.rf_bags_and_features(11, 4, 2500, 30, 5, 1.0)
        idx = np.asarray(idx)
        for t in range(4):
            used = tr.feat.numpy()[:, t][tr.thresh.numpy()[:, t] < B]
            assert set(used.tolist()) <= set(idx[t].tolist())


def test_grow_forest_rf_matches_jax(monkeypatch):
    """The single forest on row weights, with node compaction: N=200 rows
    at depth 10 compact levels 9 (512 nodes into 256 slots)."""
    X, y, _, binned = _data(200, 12, 8)
    base_w = (np.arange(200) % 5 != 0).astype(np.float32) * 2
    kw = dict(seed=3, n_trees=3, msub=3, subsample_rate=0.8, max_depth=10,
              n_bins=B, min_info_gain=0.0, min_instances=1.0)
    Y = np.eye(2, dtype=np.float32)[y.astype(int)]
    jf, jt, jlf = jg.grow_forest_rf(
        jnp.asarray(binned.numpy().astype(np.int8)), jnp.asarray(Y),
        jnp.asarray(base_w), onehot_targets=True, **kw)
    _jax_bags_fn(monkeypatch)
    tr = tk.grow_forest_rf(binned, torch.from_numpy(y),
                           torch.from_numpy(base_w), **kw)
    assert tr.feat.shape == (3, 1023)
    np.testing.assert_array_equal(tr.feat.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tr.thresh.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tr.leaf.numpy(), np.asarray(jlf), rtol=0,
                               atol=1e-6)
    assert (tr.thresh.numpy()[:, 511:] < B).any()   # the compacted level


def test_estimator_fit_raw_matches_jax(monkeypatch):
    """``OpRandomForestClassifier.fit_raw``: same edges, trees and
    probabilities as the JAX estimator (probabilities within 1e-6)."""
    from transmogrifai_tpu.models.trees import OpRandomForestClassifier as J

    X, y, _, _ = _data(1500, 16, 9)
    kw = dict(num_trees=4, max_depth=5, min_instances_per_node=5,
              min_info_gain=0.001)
    jm = J(**kw).fit_raw(X, y)
    _jax_bags_fn(monkeypatch)
    est = OpRandomForestClassifier(**kw)
    tm = est.fit_raw(X, y, device="cpu")
    np.testing.assert_array_equal(tm.edges, np.asarray(jm.edges))
    np.testing.assert_array_equal(tm.feat.numpy(), np.asarray(jm.feat))
    np.testing.assert_array_equal(tm.thresh.numpy(), np.asarray(jm.thresh))
    jb, tb = jm.predict_batch(X), tm.predict_batch(torch.from_numpy(X))
    np.testing.assert_allclose(tb.probability.numpy(),
                               np.asarray(jb.probability), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tb.prediction.numpy(),
                                  np.asarray(jb.prediction))
    assert 0 < est.metadata["hist_levels"] <= 4 * 5


def test_rf_bags_and_features():
    """Tree t's draws depend on (seed, t) only: the same whatever the
    forest's size; Poisson counts of the requested mean; subsets of
    distinct features."""
    a = tk.rf_bags_and_features(5, 3, 20000, 40, 6, 0.7, "cpu")
    b = tk.rf_bags_and_features(5, 5, 20000, 40, 6, 0.7, "cpu")
    assert torch.equal(a[0], b[0][:3]) and torch.equal(a[1], b[1][:3])
    assert not torch.equal(a[0][0], a[0][1])
    c = tk.rf_bags_and_features(6, 3, 20000, 40, 6, 0.7, "cpu")
    assert not torch.equal(a[0], c[0])
    bags, feats = b
    assert bags.dtype == torch.float32 and feats.shape == (5, 6)
    assert torch.equal(bags, bags.round()) and (bags >= 0).all()
    assert abs(float(bags.mean()) - 0.7) < 0.02
    assert all(len(set(f.tolist())) == 6 and max(f.tolist()) < 40
               for f in feats)


@pytest.mark.parametrize("stratify", [False, True])
def test_make_folds_bit_identical(stratify):
    y = (np.random.default_rng(1).random(5003) < 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        tv.make_folds(5003, 3, y=y, stratify=stratify, seed=42),
        jv.make_folds(5003, 3, y=y, stratify=stratify, seed=42))


@pytest.mark.parametrize("pos_rate", [0.5, 0.04, 0.97])
def test_splitter_and_balancer_bit_identical(pos_rate):
    """Holdout indices, training weights (balanced, minority positive,
    minority negative) and summaries."""
    y = (np.random.default_rng(2).random(4000) < pos_rate).astype(
        np.float32)
    j, t = jsp.DataBalancer(seed=7), tsp.DataBalancer(seed=7)
    jtr, jho = j.split_indices(len(y), y)
    ttr, tho = t.split_indices(len(y), y)
    np.testing.assert_array_equal(ttr, jtr)
    np.testing.assert_array_equal(tho, jho)
    assert t.summary.to_json() == j.summary.to_json()
    mask = np.zeros(len(y), bool)
    mask[ttr] = True
    jw, tw = j.train_weights(y, mask), t.train_weights(y, mask)
    assert tw.dtype == jw.dtype and np.array_equal(tw, jw)
    assert t.summary.to_json() == j.summary.to_json()
    assert ("upSamplingFraction" in t.summary.details) == (pos_rate != 0.5)
    ds_j, ds_t = jsp.DataSplitter(0.2, 3), tsp.DataSplitter(0.2, 3)
    np.testing.assert_array_equal(ds_t.split_indices(999)[1],
                                  ds_j.split_indices(999)[1])
    np.testing.assert_array_equal(ds_t.train_weights(y, mask),
                                  ds_j.train_weights(y, mask))
