"""Exclusive feature bundling (EFB) in the port against the JAX package,
on the CPU.

* The plan (``bundle_features``: plan, ``col_feat``, ``col_thresh``,
  ``end_bin``, ``bundled_dd_mask``, declines, a 5% conflict budget) and
  the encoded matrix (``bundle_matrix``) equal the JAX package's exactly,
  on ``tests/test_tree_grid.py``'s one-hot shapes.
* ``grow_tree(bundle_end=)`` against the JAX ``grow_tree(bundle_end=)``:
  splits equal, leaves within 1e-6; the port's bundled tree, unbundled,
  equals its unbundled tree.
* ``OpGBTClassifier`` with ``TMOG_EFB`` 0 and 1 grows the same trees (leaves
  within 1e-6), and equals the JAX package's bundled fit; an XGBoost fit
  (default-direction splits mapped through ``bundled_dd_mask``) and a GOSS
  fit on the bundled matrix (the JAX package's selections injected) equal
  the JAX package's up to exact ties; ``GBTGridGroup`` on a regression
  frame equals the JAX package's bundled chains (``_assert_same_tree``)
  and its CV matrix within 1e-5.
* An EFB-grown model saved by the port loads in the JAX package and
  scores within 1e-6 (``test_torch_glm.roundtrip``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transmogrifai_tpu_torch as tt
from test_torch_gbt_grid import (_assert_same_tree, _compare_chains, _folds,
                                 _make, _run_both)
from transmogrifai_tpu.models import gbdt_kernels as jg
from transmogrifai_tpu.models import trees as jtr
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.models import trees as ttr

LEAF_ATOL = 1e-6


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


def _onehot_data(n=320, groups=4, card=8, dense=3, seed=9):
    """``tests/test_tree_grid.py``'s matrix: dense normals and mutually
    exclusive one-hot blocks, with a learnable label."""
    rng = np.random.default_rng(seed)
    cats = rng.integers(0, card, size=(n, groups))
    oh = np.zeros((n, groups * card), np.float32)
    for i in range(groups):
        oh[np.arange(n), i * card + cats[:, i]] = 1.0
    dn = rng.normal(size=(n, dense)).astype(np.float32)
    X = np.concatenate([dn, oh], axis=1)
    y = ((dn[:, 0] + (cats[:, 0] == 3) - (cats[:, min(1, groups - 1)] == 5)
          + rng.normal(size=n) * 0.3) > 0).astype(np.float32)
    return X, y


def _conflicted():
    """The one-hot matrix with 8 rows that set two members of a block."""
    X, y = _onehot_data(n=400, seed=2)
    rows = np.random.default_rng(0).choice(len(y), size=8, replace=False)
    X = X.copy()
    X[rows, 3] = 1.0
    X[rows, 4] = 1.0
    return X, y


def _single_group(seed=21):
    """One one-hot group of 8 beside 3 dense normals (no tie between
    indicator columns can occur)."""
    rng = np.random.default_rng(seed)
    n, card = 400, 8
    cats = rng.integers(0, card, size=n)
    oh = np.zeros((n, card), np.float32)
    oh[np.arange(n), cats] = 1.0
    dn = rng.normal(size=(n, 3)).astype(np.float32)
    return np.concatenate([dn, oh], axis=1), rng


def _binned_both(X, mb=32):
    edges = jg.quantile_bins_sparse_aware(X, mb)
    jb = np.asarray(jg.apply_bins(jnp.asarray(X), jnp.asarray(edges)),
                    np.int8)
    tb = tk.apply_bins(torch.from_numpy(X), edges)
    assert np.array_equal(tb.numpy().astype(np.int8), jb)
    return edges, jb, tb


def _assert_same_plan(pj, pt):
    assert pj.plan == pt.plan
    for a in ("col_feat", "col_thresh", "end_bin"):
        assert np.array_equal(getattr(pj, a), getattr(pt, a)), a
    assert (pj.n_orig, pj.n_bins, pj.width) == (pt.n_orig, pt.n_bins,
                                                pt.width)
    for dd in (None, np.ones(pj.n_orig, bool),
               np.arange(pj.n_orig) % 2 == 0):
        assert np.array_equal(pj.bundled_dd_mask(dd), pt.bundled_dd_mask(dd))


@pytest.mark.parametrize("case", ["onehot", "seed23", "single", "conflicts",
                                  "conflicts_no_budget", "dense", "narrow",
                                  "bins_128", "forced"])
def test_plan_matches_jax(case):
    """The plan, its encode and its declines equal the JAX package's
    exactly."""
    kw = {}
    if case in ("onehot", "seed23"):
        X, _ = _onehot_data(seed=9 if case == "onehot" else 23)
    elif case == "single":
        X, _ = _single_group()
    elif case.startswith("conflicts"):
        X, _ = _conflicted()
        if case == "conflicts":
            kw = dict(max_conflict_rate=0.05)
    elif case == "dense":
        X = np.random.default_rng(5).normal(size=(200, 8)).astype(np.float32)
    elif case == "narrow":
        X, _ = _onehot_data()
        X = X[:, 3:5]
    elif case == "forced":
        X, _ = _onehot_data(groups=1, card=3, dense=6)
        kw = dict(min_width_ratio=1.0)
    else:
        X, _ = _onehot_data()
    mb = 128 if case == "bins_128" else 32
    edges, jb, tb = _binned_both(X, min(mb, 32))
    pj = jg.bundle_features(jb, edges, mb, **kw)
    pt = tk.bundle_features(tb, edges, mb, **kw)
    if case in ("dense", "narrow", "bins_128"):
        assert pj is None and pt is None
        return
    assert pj is not None and pt is not None
    _assert_same_plan(pj, pt)
    mj = jg.bundle_matrix(pj, jb)
    mt = tk.bundle_matrix(pt, tb)
    assert mt.dtype == torch.uint8 and mt.stride(0) % 16 == 0
    assert np.array_equal(mt.numpy().astype(np.int64), mj.astype(np.int64))


@pytest.mark.parametrize("depth", [3, 6])
def test_bundled_grower_matches_jax(depth):
    """``grow_tree`` on the bundled matrix with ``bundle_end`` against the
    JAX package's: splits (in bundled space, and unbundled) equal, leaves
    within 1e-6; at depth 3 on one one-hot group the unbundled splits also
    equal the port's own unbundled tree."""
    if depth == 3:
        X, rng = _single_group()
        n = X.shape[0]
        G = rng.normal(size=n).astype(np.float32)[:, None]
    else:
        X, y = _onehot_data(seed=23)
        n = X.shape[0]
        rng = np.random.default_rng(24)
        G = ((0.5 - y) + 0.01 * rng.normal(size=n)).astype(np.float32)[:, None]
    H = np.full((n, 1), 0.25, np.float32)
    C = np.ones(n, np.float32)
    edges, jb, tb = _binned_both(X)
    pj = jg.bundle_features(jb, edges, 32)
    pt = tk.bundle_features(tb, edges, 32)
    mj, mt = jg.bundle_matrix(pj, jb), tk.bundle_matrix(pt, tb)
    fj, tj, lj = jg.grow_tree(
        jnp.asarray(mj.astype(np.int32)), jnp.asarray(G), jnp.asarray(H),
        jnp.asarray(C), max_depth=depth, n_bins=32, lam=1.0,
        bundle_end=jnp.asarray(pj.end_bin))
    tr = tk.grow_tree(mt, torch.from_numpy(G), torch.from_numpy(H), depth,
                      32, C=torch.from_numpy(C), lam=1.0,
                      bundle_end=torch.from_numpy(pt.end_bin))
    assert np.array_equal(tr.feat.numpy(), np.asarray(fj))
    assert np.array_equal(tr.thresh.numpy(), np.asarray(tj))
    np.testing.assert_allclose(tr.leaf.numpy(), np.asarray(lj), rtol=0,
                               atol=LEAF_ATOL)
    fu, tu = tk.unbundle_ensemble(pt, tr.feat, tr.thresh)
    fju, tju = jg.unbundle_ensemble(pj, np.asarray(fj), np.asarray(tj))
    assert np.array_equal(fu.numpy(), fju) and np.array_equal(tu.numpy(),
                                                              tju)
    # the margin update routes the bundled matrix as the unbundled tree
    # routes the original one
    p_b = tk.predict_tree_bundled(mt, tr.feat, tr.thresh, tr.leaf, depth,
                                  torch.from_numpy(pt.end_bin))
    p_u = tk.predict_tree(tb, fu, tu, tr.leaf, depth)
    assert torch.equal(p_b, p_u)
    if depth == 3:
        plain = tk.grow_tree(tb, torch.from_numpy(G), torch.from_numpy(H),
                             depth, 32, C=torch.from_numpy(C), lam=1.0)
        assert torch.equal(fu, plain.feat) and torch.equal(tu, plain.thresh)
        np.testing.assert_allclose(tr.leaf.numpy(), plain.leaf.numpy(),
                                   rtol=0, atol=LEAF_ATOL)


def test_gbt_fit_efb_on_off_and_jax(monkeypatch):
    """``OpGBTClassifier(max_iter=8, max_depth=4)``: ``TMOG_EFB`` 1 and 0
    grow the same trees in the port (and the bundled fit records its
    width), and the port's bundled fit equals the JAX package's."""
    X, y = _onehot_data(seed=1)
    models, widths = {}, {}
    for efb in ("0", "1"):
        monkeypatch.setenv("TMOG_EFB", efb)
        ttr.clear_sweep_caches()
        est = ttr.OpGBTClassifier(max_iter=8, max_depth=4, seed=3)
        models[efb] = est.fit_raw(X, y, device="cpu")
        widths[efb] = est.metadata["efb_width"]
    assert widths["0"] is None and widths["1"][0] == X.shape[1]
    assert widths["1"][1] < X.shape[1]
    a, b = models["0"], models["1"]
    assert torch.equal(a.feat, b.feat) and torch.equal(a.thresh, b.thresh)
    np.testing.assert_allclose(a.leaf.numpy(), b.leaf.numpy(), rtol=0,
                               atol=LEAF_ATOL)
    jm = jtr.OpGBTClassifier(max_iter=8, max_depth=4, seed=3).fit_raw(X, y)
    assert np.array_equal(b.feat.numpy(), np.asarray(jm.feat))
    assert np.array_equal(b.thresh.numpy(), np.asarray(jm.thresh))
    np.testing.assert_allclose(b.leaf.numpy(), np.asarray(jm.leaf), rtol=0,
                               atol=LEAF_ATOL)


def test_auto_width_gate(monkeypatch):
    """``auto`` bundles only below ``EFB_MIN_WIDTH_RATIO``; ``1`` bundles
    past it; ``0`` never (the JAX package's ``TMOG_EFB``)."""
    X, y = _onehot_data(groups=1, card=3, dense=12, seed=4)   # 15 -> 13
    got = {}
    for efb in ("auto", "1", "0"):
        monkeypatch.setenv("TMOG_EFB", efb)
        ttr.clear_sweep_caches()
        est = ttr.OpGBTClassifier(max_iter=2, max_depth=3)
        est.fit_raw(X, y, device="cpu")
        got[efb] = est.metadata["efb_width"]
    assert got == {"auto": None, "1": [15, 13], "0": None}


def test_xgb_default_direction_matches_jax():
    """``OpXGBoostClassifier`` (default-direction splits on the singleton
    columns only, ``bundled_dd_mask``) on the one-hot matrix, bundled in
    both packages: trees equal up to exact ties, scores within 1e-5."""
    X, y = _onehot_data(n=600, seed=7)
    kw = dict(num_round=6, eta=0.3, max_depth=4, gamma=0.0,
              early_stopping_rounds=0)
    est = ttr.OpXGBoostClassifier(**kw)
    tm = est.fit_raw(X, y, device="cpu")
    jm = jtr.OpXGBoostClassifier(**kw).fit_raw(X, y)
    assert est.metadata["efb_width"] is not None
    binned = tk.apply_bins(torch.from_numpy(X), tm.edges).numpy()
    train = np.ones(len(y), bool)
    ties = 0
    for r in range(6):
        ties += _assert_same_tree(
            np.asarray(jm.feat)[r], np.asarray(jm.thresh)[r],
            np.asarray(jm.leaf)[r], tm.feat[r].numpy(),
            tm.thresh[r].numpy(), tm.leaf[r].numpy(), binned, train, 4)
        if ties:
            break
    if not ties:
        np.testing.assert_allclose(
            tm.predict_batch(torch.from_numpy(X)).probability.numpy(),
            np.asarray(jm.predict_batch(X).probability), rtol=0, atol=1e-5)


def test_goss_on_bundled_matrix_matches_jax(monkeypatch):
    """A depth-8 ``OpGBTRegressor`` with GOSS forced on grows every round
    on a GOSS sample of the bundled matrix; with the JAX package's
    selections injected its trees equal the JAX fit's up to exact ties."""
    monkeypatch.setenv("TMOG_GOSS", "1")
    X, _ = _onehot_data(n=600, seed=5)
    y = (X[:, 0] * 2 + X[:, 5] - X[:, 12] + 0.1 * np.random.default_rng(
        1).normal(size=600)).astype(np.float32)
    picked = []

    def jax_select(ga, seed, rid, chain, k_top, k_rest):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), rid), chain)
        idx, mult = jg._goss_select(jnp.asarray(ga.numpy()), key, k_top,
                                    k_rest)
        picked.append(np.asarray(idx))
        return (torch.from_numpy(np.asarray(idx).astype(np.int64)),
                torch.from_numpy(np.array(mult)))

    monkeypatch.setattr(tk, "goss_select", jax_select)
    kw = dict(max_iter=4, max_depth=8, step_size=0.3, seed=2)
    est = ttr.OpGBTRegressor(**kw)
    tm = est.fit_raw(X, y, device="cpu")
    jm = jtr.OpGBTRegressor(**kw).fit_raw(X, y)
    assert est.metadata["goss"] is not None
    assert est.metadata["efb_width"] is not None
    binned = tk.apply_bins(torch.from_numpy(X), tm.edges).numpy()
    for r in range(4):
        rows = np.zeros(len(y), bool)
        rows[picked[r]] = True
        if _assert_same_tree(
                np.asarray(jm.feat)[r], np.asarray(jm.thresh)[r],
                np.asarray(jm.leaf)[r], tm.feat[r].numpy(),
                tm.thresh[r].numpy(), tm.leaf[r].numpy(), binned, rows, 8):
            break


def test_gbt_group_matches_jax_bundled_chains(monkeypatch):
    """``GBTGridGroup`` on a regression frame whose one-hot block bundles
    in both packages (15 -> 12 columns): every chain's trees equal the
    JAX package's bundled chains up to ties, the CV matrix within 1e-5
    where no tie routes a row differently."""
    X, y = _make(2000, 11)
    ctxs = _folds(y)
    edges, jb, _ = _binned_both(X)
    assert jg.bundle_features(jb, edges, 32).width == 12
    pts = [dict(max_depth=d, max_iter=6, step_size=0.1,
                min_child_weight=10.0) for d in (3, 5)]
    jm, tm, jtrees, jleaves, _, tg = _run_both(
        jtr.OpGBTRegressor(), ttr.OpGBTRegressor(), pts,
        "RootMeanSquaredError", X, y, ctxs, monkeypatch)
    assert tg.efb_width == (15, 12)
    ties = _compare_chains(jtrees, jleaves, tg, X, ctxs, [3, 5])
    if ties == 0:
        np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-5)


def test_efb_model_loads_in_jax():
    """An EFB-grown boosted model saved by the port (its splits on the
    original columns) loads in the JAX package and scores within 1e-6."""
    from test_torch_glm import roundtrip

    X, y = _onehot_data(seed=1)
    est = ttr.OpGBTClassifier(max_iter=8, max_depth=4, seed=3)
    model = est.fit_raw(X, y, device="cpu")
    assert est.metadata["efb_width"] is not None
    loaded = roundtrip(model, to_jax=True)
    np.testing.assert_allclose(
        np.asarray(loaded.predict_batch(X).probability),
        model.predict_batch(torch.from_numpy(X)).probability.numpy(),
        rtol=0, atol=1e-6)
