"""The CSR histogram path of the port against the JAX package, on the CPU.

* ``build_feature_csr``'s rows, bins and zero bins equal the JAX
  package's (NaN entries pinned to bin 0), and its declines too.
* ``sparse_level_hists`` against ``seg_level_hists_plain`` within 1e-5
  (float channels, empty slots, levels of up to 2048 slots).
* ``tests/test_sparse_path.py::TestSparseKernelParity``'s trees (depths 3
  and 6) grown through the CSR histogram equal the JAX grower's, leaves
  within 1e-5.
* An end-to-end ``TMOG_SPARSE_HIST=1`` XGBoost fit, ``_SPARSE_MIN_ELEMS``
  patched down in both packages: the CSR engages (and every level takes
  it), trees equal the port's dense fit up to exact ties, scores within
  1e-5 of the JAX package's sparse fit; ``TMOG_SPARSE_HIST`` unset builds
  none; GOSS turns the CSR off.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import transmogrifai_tpu_torch as tt
from test_torch_gbt_grid import _assert_same_tree
from transmogrifai_tpu.models import gbdt_kernels as jg
from transmogrifai_tpu.models import trees as jtr
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.models import trees as ttr

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("TMOG_COST_HISTORY", "0")
    for var in ("TMOG_EFB", "TMOG_GOSS", "TMOG_SPARSE_HIST"):
        monkeypatch.delenv(var, raising=False)
    jtr.clear_sweep_caches()
    ttr.clear_sweep_caches()
    yield
    jtr.clear_sweep_caches()
    ttr.clear_sweep_caches()


def _sparse_data(n=4000, d=40, density=0.05, seed=5):
    """``tests/test_sparse_path.py``'s recipe: a few exponential nonzeros
    a row, a label on the first 8 columns."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, d), np.float32)
    nnz = max(1, int(d * density))
    cols = rng.integers(0, d, size=(n, nnz))
    vals = rng.exponential(1.0, size=(n, nnz)).astype(np.float32)
    X[np.repeat(np.arange(n), nnz), cols.ravel()] = vals.ravel()
    z = X[:, :8] @ rng.normal(size=8).astype(np.float32)
    y = (z > np.median(z)).astype(np.float32)
    return X, y


def _csr_both(X, mb):
    edges = jg.quantile_bins_sparse_aware(X, mb)
    Xt = torch.from_numpy(X)
    binned = tk.apply_bins(Xt, edges)
    return edges, binned, jg.build_feature_csr(X, edges), \
        tk.build_feature_csr(Xt, edges, binned)


@pytest.mark.parametrize("mb,nan", [(16, False), (32, True)])
def test_csr_build_matches_jax(mb, nan):
    X, _ = _sparse_data(3000, 24)
    if nan:
        X[5, 3] = np.nan
        X[17, 0] = np.nan
    _, _, want, got = _csr_both(X, mb)
    rows, bins, zero_bin = want
    assert got.nz_max == rows.shape[1]
    assert np.array_equal(got.rows.numpy(), rows)
    assert np.array_equal(got.bins.numpy().astype(np.int64),
                          bins.astype(np.int64))
    assert np.array_equal(got.zero_bin.numpy().astype(np.int64),
                          zero_bin.astype(np.int64))


@pytest.mark.parametrize("case", ["dense", "outlier", "empty", "bins_128"])
def test_csr_declines_with_jax(case):
    X, _ = _sparse_data(2000, 20)
    mb = 32
    if case == "dense":
        X = np.random.default_rng(1).normal(size=(2000, 20)).astype(
            np.float32)
    elif case == "outlier":
        X[:, 7] = 1.0 + np.arange(2000, dtype=np.float32)
    elif case == "empty":
        X[:] = 0.0
    else:
        mb = 128
    _, _, want, got = _csr_both(X, mb)
    assert want is None and got is None


@pytest.mark.parametrize("M", [1, 7, 64, 2048])
def test_sparse_hists_match_plain(M):
    """Every channel of every (slot, bin, column) within 1e-5 of the plain
    version's exact sums, empty slots exactly 0."""
    X, _ = _sparse_data(4000, 30)
    X[11, 2] = np.nan
    _, binned, _, csr = _csr_both(X, 32)
    rng = np.random.default_rng(M)
    n = X.shape[0]
    slot = torch.from_numpy(rng.integers(0, M // 2 + 1, n).astype(np.int32))
    ch = torch.from_numpy(np.concatenate(
        [rng.normal(size=(n, 2)), rng.random((n, 1))], 1).astype(np.float32))
    before = tk.sparse_level_hists.levels
    got = tk.sparse_level_hists(csr, slot, ch, M, 32)
    assert tk.sparse_level_hists.levels == before + 1
    want = tk.seg_level_hists_plain(binned, slot, ch, M, 32)
    assert got.shape == want.shape == (3, M, 32, 30)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
    assert not got[:, M // 2 + 1:].any()


@pytest.mark.parametrize("depth", [3, 6])
def test_sparse_tree_matches_jax(depth):
    """``TestSparseKernelParity``'s tree: the CSR histogram's tree equals
    the JAX grower's (dense and CSR), leaves within 1e-5."""
    X, y = _sparse_data(3000, 24)
    edges, binned, (r, b, z), csr = _csr_both(X, 16)
    jcsr = (jnp.asarray(r), jnp.asarray(b),
            jnp.asarray(np.eye(16, dtype=np.float32)[z]))
    G = (0.5 - y)[:, None].astype(np.float32)
    H = np.full((len(y), 1), 0.25, np.float32)
    C = np.ones(len(y), np.float32)
    kw = dict(max_depth=depth, n_bins=16, lam=1.0, min_instances=5.0,
              newton_leaf=True)
    jbin = jg.apply_bins(jnp.asarray(X), jnp.asarray(edges))
    f_j, t_j, l_j = jg.grow_tree(jbin, jnp.asarray(G), jnp.asarray(H),
                                 jnp.asarray(C), csr=jcsr, **kw)
    tree = tk.grow_tree(binned, torch.from_numpy(G), torch.from_numpy(H),
                        depth, 16, C=torch.from_numpy(C), lam=1.0,
                        min_instances=5.0, hist_fn=tk.csr_hist_fn(csr))
    assert np.array_equal(tree.feat.numpy(), np.asarray(f_j))
    assert np.array_equal(tree.thresh.numpy(), np.asarray(t_j))
    np.testing.assert_allclose(tree.leaf.numpy(), np.asarray(l_j), rtol=0,
                               atol=TOL)


def test_wide_levels_take_the_dense_histogram():
    """Levels past ``SPARSE_MAX_SLOTS`` slots go to the dense function."""
    X, _ = _sparse_data(500, 10)
    _, binned, _, csr = _csr_both(X, 32)
    seen = []

    def dense(b, slot, ch, M, B):
        seen.append(M)
        return tk.seg_level_hists_plain(b, slot, ch, M, B)

    fn = tk.csr_hist_fn(csr, dense)
    slot = torch.zeros(500, dtype=torch.int32)
    ch = torch.ones((500, 2))
    fn(binned, slot, ch, tk.SPARSE_MAX_SLOTS, 32)
    fn(binned, slot, ch, tk.SPARSE_MAX_SLOTS + 1, 32)
    assert seen == [tk.SPARSE_MAX_SLOTS + 1]


def test_xgb_sparse_fit_matches_jax(monkeypatch):
    """``OpXGBoostClassifier`` with ``TMOG_SPARSE_HIST=1`` on a 92%-zero
    matrix (``_SPARSE_MIN_ELEMS`` patched down in both packages): the CSR
    is built and every level takes it; its trees equal the port's dense
    fit's up to exact ties (both sum each histogram exactly, so the leaves
    agree within 1e-6), its scores are within 1e-5 of the JAX package's
    sparse fit, and it learns (train AuPR > 0.8, the JAX test's bar)."""
    from transmogrifai_tpu_torch.evaluators.metrics import aupr

    monkeypatch.setattr(jtr, "_SPARSE_MIN_ELEMS", 1)
    monkeypatch.setattr(ttr, "_SPARSE_MIN_ELEMS", 1)
    X, y = _sparse_data(6000, 50, density=0.08, seed=9)
    Xt = torch.from_numpy(X)
    kw = dict(num_round=15, eta=0.3, max_depth=4, gamma=0.0,
              early_stopping_rounds=0)
    dense = ttr.OpXGBoostClassifier(**kw).fit_raw(X, y, device="cpu")
    monkeypatch.setenv("TMOG_SPARSE_HIST", "1")
    ttr.clear_sweep_caches()
    est = ttr.OpXGBoostClassifier(**kw)
    levels = tk.sparse_level_hists.levels
    tm = est.fit_raw(X, y, device="cpu")
    assert est.metadata["csr"] and est.metadata["efb_width"] is None
    assert tk.sparse_level_hists.levels - levels == est.metadata[
        "hist_levels"] == 15 * 4
    binned = tk.apply_bins(Xt, tm.edges).numpy()
    for r in range(15):
        _assert_same_tree(dense.feat[r].numpy(), dense.thresh[r].numpy(),
                          dense.leaf[r].numpy(), tm.feat[r].numpy(),
                          tm.thresh[r].numpy(), tm.leaf[r].numpy(), binned,
                          np.ones(len(y), bool), 4)
    p = tm.predict_batch(Xt).probability[:, 1]
    np.testing.assert_allclose(
        p.numpy(), dense.predict_batch(Xt).probability[:, 1].numpy(),
        rtol=0, atol=1e-6)
    jm = jtr.OpXGBoostClassifier(**kw).fit_raw(X, y)
    assert np.asarray(jm.feat).shape == tuple(tm.feat.shape)
    np.testing.assert_allclose(
        p.numpy(), np.asarray(jm.predict_batch(X).probability)[:, 1],
        rtol=0, atol=TOL)
    assert aupr(torch.from_numpy(y), p) > 0.80


def test_csr_gates(monkeypatch):
    """No CSR without ``TMOG_SPARSE_HIST=1``, on a matrix the sparse rule
    keeps dense, or where a trailing block of zero-weight rows trims the
    sketch; GOSS (depth >= 8) grows without it."""
    monkeypatch.setattr(ttr, "_SPARSE_MIN_ELEMS", 1)
    X, y = _sparse_data(3000, 30)
    Xt = torch.from_numpy(X)
    edges, binned = ttr.prep_tree_inputs(Xt, 32)
    assert ttr.prep_tree_csr(Xt, edges, binned) is None
    monkeypatch.setenv("TMOG_SPARSE_HIST", "1")
    assert ttr.prep_tree_csr(Xt, edges, binned) is not None
    w = np.ones(3000, np.float32)
    w[-10:] = 0
    assert ttr.prep_tree_csr(Xt, edges, binned, row_weight=w) is None
    Xd = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3000, 30)).astype(np.float32))
    ed, bd = ttr.prep_tree_inputs(Xd, 32)
    assert ttr.prep_tree_csr(Xd, ed, bd) is None
    monkeypatch.setenv("TMOG_GOSS", "1")
    levels = tk.sparse_level_hists.levels
    est = ttr.OpGBTClassifier(max_iter=2, max_depth=8)
    est.fit_raw(X, y, device="cpu")
    assert est.metadata["csr"] and est.metadata["goss"] is not None
    assert tk.sparse_level_hists.levels == levels
