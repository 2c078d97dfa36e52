"""The port's lockstep boosting group (``GBTGridGroup``) and its GOSS row
sampling against the JAX package, on the CPU.

Every (candidate x fold) chain of the port's group is held to the JAX
group's chain of the same index on the same numpy-seeded inputs:

* trees equal up to ties (``_assert_same_tree``): where the two packages
  pick different (feature, threshold) pairs at a node, both must cut the
  node's training rows into the same two sets (sides possibly swapped).
  Such splits have equal gain in exact arithmetic, and float32 sums taken
  in another order break the tie either way; with ``min_child_weight`` 1
  a split that isolates one row ties with every other feature isolating
  that row.  Leaves of the leaves that training rows reach agree within
  1e-5 relative (the slice test's leaf tolerance);
* stop rounds equal (early stopping);
* the CV metric matrix within 1e-5 — asserted only where the trees have no
  tie, since a tie routes the held-out rows of the fold differently.

The JAX runs set ``TMOG_COST_HISTORY=0``.  GOSS: a sequential fit and
a group with the JAX package's ``_goss_select`` indices injected into the
port (its draw uses ``jax.random``), and the port's own draw held to its
contract.
"""
import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.models import gbdt_kernels as jg
from transmogrifai_tpu.models.trees import OpGBTRegressor as JGBT
from transmogrifai_tpu.models.trees import OpXGBoostClassifier as JXGB
from transmogrifai_tpu.selector import grid_groups as jgg
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.models.trees import OpGBTRegressor, \
    OpXGBoostClassifier, prep_tree_inputs
from transmogrifai_tpu_torch.selector import grid_groups as tgg
from transmogrifai_tpu_torch.selector.validators import make_folds

LEAF_RTOL = 1e-5


def _goes_right(xcol, t: int):
    te = -t - 1 if t < 0 else t
    return (xcol > te) | ((t < 0) & (xcol == 0))


def _assert_same_tree(fa, ta, la, fb, tb, lb, binned, train, depth):
    """Tree a (heap arrays feat/thresh (2^depth-1,), leaf (2^depth, K))
    against tree b over the rows ``train`` (weight > 0): equal splits, or
    splits that cut the node's rows into the same two sets; the subtrees
    follow the rows (swapped where the sides are).  Leaves reached by rows
    agree within LEAF_RTOL.  Returns the number of ties that route some
    row of the whole matrix differently (a tie within one feature, such as
    the default-direction mirror ``thresh 0`` / ``-(t+1)`` with no rows
    above t, routes every row alike and is not counted)."""
    ties = 0
    binned = np.asarray(binned).astype(np.int64)
    everyone = np.ones(binned.shape[0], bool)
    # (node of a, node of b, training rows there, all rows there while the
    # trees route every row alike, else None)
    stack = [(0, 0, np.asarray(train, bool), everyone)]
    while stack:
        ha, hb, rows, alls = stack.pop()
        if not rows.any():
            continue
        level = int(np.log2(ha + 1))
        if level == depth:
            off = 2 ** depth - 1
            np.testing.assert_allclose(lb[hb - off], la[ha - off],
                                       rtol=LEAF_RTOL, atol=1e-6)
            continue
        ga = _goes_right(binned[:, fa[ha]], int(ta[ha]))
        gb = _goes_right(binned[:, fb[hb]], int(tb[hb]))
        ra, rb = rows & ga, rows & gb
        same = (fa[ha], ta[ha]) == (fb[hb], tb[hb])
        swap = not (same or np.array_equal(ra, rb))
        if swap:
            assert np.array_equal(ra, rows & ~rb), (
                f"node {ha}: ({fa[ha]}, {ta[ha]}) vs ({fb[hb]}, {tb[hb]}) "
                f"cut {int(rows.sum())} rows differently")
        if alls is not None and not same:
            hidden = np.array_equal(alls & ga, alls & (~gb if swap else gb))
            if not hidden:
                ties += 1
                alls = None
        right = [(2 * ha + 2, 2 * hb + (1 if swap else 2), ra,
                  None if alls is None else alls & ga)]
        left = [(2 * ha + 1, 2 * hb + (2 if swap else 1), rows & ~ra,
                 None if alls is None else alls & ~ga)]
        stack += left + right
    return ties


def _make(n, seed, binary=False):
    """Ten normal reals, a one-hot block of four levels and a small
    integer column; a label with linear, product and noise parts."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 10))
    cat = rng.choice(4, size=n, p=[0.4, 0.3, 0.2, 0.1])
    onehot = np.eye(4)[cat]
    small = rng.integers(0, 6, size=n).astype(np.float64)
    z = (4 * X[:, 0] - 3 * X[:, 1] + 3 * np.tanh(X[:, 2] * X[:, 3])
         + 2 * (cat == 1) + 0.5 * small + 3 * rng.normal(size=n))
    y = (z > 1.0).astype(np.float32) if binary else (22.5 + z)
    return (np.concatenate([X, onehot, small[:, None]], 1).astype(np.float32),
            y.astype(np.float32))


def _folds(y, k=3):
    f = make_folds(len(y), k, seed=42)
    return [((f != i).astype(np.float32), (f == i).astype(np.float32))
            for i in range(k)]


def _run_both(jproto, tproto, points, metric, X, y, ctxs, monkeypatch):
    """Both groups on the same inputs; the JAX chains' trees (unmasked,
    through its final per-chain predict) and stop rounds recorded."""
    monkeypatch.setenv("TMOG_COST_HISTORY", "0")
    tt.set_device("cpu")
    jtrees, jstate = [], {}
    predict = jg.predict_ensemble
    replay = jgg._replay_es

    def rec_predict(binned, feat, thresh, leaf, depth):
        jtrees.append((np.asarray(feat), np.asarray(thresh)))
        return predict(binned, feat, thresh, leaf, depth)

    def rec_replay(rows, stopped, best_metric, best_len, *a, **k):
        jstate["best_len"] = best_len
        return replay(rows, stopped, best_metric, best_len, *a, **k)

    def rec_rounds(*a, **k):
        out = rounds(*a, **k)
        jleaves.append(np.asarray(out[3]))
        return out

    jleaves = []
    rounds = jg._gbt_chain_rounds_jit
    with monkeypatch.context() as mp:
        mp.setattr(jg, "predict_ensemble", rec_predict)
        mp.setattr(jgg, "_replay_es", rec_replay)
        mp.setattr(jg, "_gbt_chain_rounds_jit", rec_rounds)
        jm = np.asarray(jgg.GBTGridGroup(jproto, points, metric).run(
            X, y, ctxs))
    tg = tgg.GBTGridGroup(tproto, points, metric)
    tm = tg.run(torch.from_numpy(X), y, ctxs).numpy()
    leaves = np.concatenate(jleaves)        # (rounds, chains, L, 1)
    return jm, tm, jtrees, leaves, jstate.get("best_len"), tg


def _compare_chains(jtrees, jleaves, tg, X, ctxs, depths, rows_of=None):
    """Every chain's kept trees against the JAX chain's, over each tree's
    training rows (the fold's, and of those the ones ``rows_of(chain,
    round)`` selects); returns the ties."""
    edges, binned = prep_tree_inputs(
        torch.from_numpy(X), 32, row_weight=ctxs[0][0] + ctxs[0][1])
    binned = binned.numpy()
    F = len(ctxs)
    ties = 0
    for s, (jf, jt) in enumerate(jtrees):
        depth = depths[s // F]
        heap = int(np.log2(jf.shape[1] + 1))
        nd = 2 ** depth - 1
        # the JAX heap is the group's deepest: a shallower chain's levels
        # past its depth split nothing
        assert (jt[:, nd:] == 32).all()
        kept = tg.chain_trees[s][:int(tg.best_len[s])]
        for r, tree in enumerate(kept):
            jl = jleaves[r, s][::2 ** (heap - depth)]
            rows = ctxs[s % F][0] > 0
            if rows_of is not None:
                rows = rows & rows_of(s, r)
            ties += _assert_same_tree(
                jf[r, :nd], jt[r, :nd], jl, tree.feat.numpy(),
                tree.thresh.numpy(), tree.leaf.numpy(), binned, rows, depth)
    return ties


@pytest.mark.parametrize("mcw,depths,metric", [
    (1.0, [3, 6], "RootMeanSquaredError"),
    (10.0, [3, 12], "RootMeanSquaredError"),
    (10.0, [4, 8], "MeanAbsoluteError"),
])
def test_regression_group_matches_jax(mcw, depths, metric, monkeypatch):
    """Squared-error chains (OpGBTRegressor, 8 rounds of step 0.1) at
    min_child_weight 1 (the default: ties that route held-out rows
    differently may occur, trees compared up to them) and 10 (no such
    tie); the CV metric matrix within 1e-5 wherever no tie routes a row
    differently.  The depth-12 case runs on 1 000 rows, where its last
    level (2 048 nodes) compacts its node ids into next_pow2(N) = 1 024
    slots, as the JAX growth does (at 3 000 rows no level of depth 12
    passes next_pow2(N) = 4 096 nodes)."""
    n = 1000 if max(depths) > 10 else 3000
    X, y = _make(n, 11)
    ctxs = _folds(y)
    pts = [dict(max_depth=d, max_iter=8, step_size=0.1,
                min_child_weight=mcw) for d in depths]
    compact = tk._compact_slots
    compacted = []

    def spy(node, n_cap):
        compacted.append(n_cap)
        return compact(node, n_cap)

    monkeypatch.setattr(tk, "_compact_slots", spy)
    jm, tm, jtrees, jleaves, _, tg = _run_both(
        JGBT(), OpGBTRegressor(), pts, metric, X, y, ctxs, monkeypatch)
    assert set(compacted) == ({1024} if n == 1000 else set())
    assert tm.shape == jm.shape == (len(depths), 3)
    assert (tg.best_len == 8).all()
    assert tg.trees_grown == 8 * 3 * len(depths)
    assert tg.hist_levels == 8 * 3 * sum(depths)
    ties = _compare_chains(jtrees, jleaves, tg, X, ctxs, depths)
    assert ties == 0 or mcw == 1.0
    if ties == 0:
        np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-5)


def test_xgb_early_stopping_group_matches_jax(monkeypatch):
    """Binary XGBoost chains with early stopping (patience 3, validation
    AuPR, default-direction splits), chains stopping at different rounds:
    the same stop rounds, trees equal up to ties, CV AuPR within 1e-5."""
    X, y = _make(3000, 12, binary=True)
    ctxs = _folds(y)
    pts = [dict(max_depth=d, min_child_weight=4.0) for d in (2, 4)]
    proto_kw = dict(num_round=40, eta=0.3, gamma=0.0,
                    early_stopping_rounds=3)
    jm, tm, jtrees, jleaves, jbest, tg = _run_both(
        JXGB(**proto_kw), OpXGBoostClassifier(**proto_kw), pts, "AuPR", X,
        y, ctxs, monkeypatch)
    np.testing.assert_array_equal(tg.best_len, np.asarray(jbest))
    assert (tg.best_len < 40).all() and len(set(tg.best_len)) > 1
    ties = _compare_chains(jtrees, jleaves, tg, X, ctxs, [2, 4])
    assert ties == 0
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-5)


def test_group_declines_and_raises():
    """The JAX group's decline rules (None: multiclass labels, mixed
    static attributes, subsampling); count-gated chains are not declined
    (they grow with the count channel and score every fold)."""
    tt.set_device("cpu")
    X, y = _make(400, 13)
    ctxs = _folds(y)
    Xt = torch.from_numpy(X)
    cases = [
        (OpXGBoostClassifier(), [dict(max_depth=3)], "AuPR",
         np.where(y > 25, 2, 0).astype(np.float32)),
        (OpGBTRegressor(), [dict(max_iter=3), dict(max_iter=4)],
         "RootMeanSquaredError", y),
        (OpGBTRegressor(subsample_rate=0.5), [dict(max_depth=3)],
         "RootMeanSquaredError", y),
    ]
    for proto, pts, metric, yy in cases:
        assert tgg.GBTGridGroup(proto, pts, metric).run(Xt, yy, ctxs) is None
    g = tgg.GBTGridGroup(OpGBTRegressor(), [dict(min_instances_per_node=10)],
                         "RootMeanSquaredError")
    m = g.run(Xt, y, ctxs)
    assert m is not None and tuple(m.shape) == (1, 3)
    assert g.hist_levels == 20 * 3 * 5


def _jax_goss(seed, rid, chain, ga, k_top, k_rest):
    import jax
    import jax.numpy as jnp

    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                rid), chain)
    idx, mult = jg._goss_select(jnp.asarray(ga), key, k_top, k_rest)
    return np.asarray(idx), np.asarray(mult)


def _inject_jax_goss(monkeypatch):
    """Replace the port's GOSS draw by the JAX package's ``_goss_select``
    (same (seed, round, chain) keys); returns the list of (round, chain,
    row ids) it was called with."""
    calls = []

    def injected(ga, seed, rid, chain, k_top, k_rest):
        idx, mult = _jax_goss(seed, rid, chain, ga.numpy(), k_top, k_rest)
        calls.append((rid, chain, idx))
        return (torch.from_numpy(idx.astype(np.int64)),
                torch.from_numpy(mult.copy()))

    monkeypatch.setattr(tk, "goss_select", injected)
    return calls


def test_goss_group_matches_jax_with_its_selection(monkeypatch):
    """The lockstep group's GOSS branch (both candidates deep, GOSS forced
    on by TMOG_GOSS=1), the JAX package's selection injected: each chain's
    trees equal up to ties over the rows they grew on (the selected
    training rows), here with no tie (min_child_weight 30: with 10, ties
    on a node's few selected rows route other training rows differently,
    and the chain's later rounds grow from other margins), the CV RMSE
    matrix within 1e-5; each chain's round r drew with key (seed, r,
    chain)."""
    monkeypatch.setenv("TMOG_GOSS", "1")
    X, y = _make(3000, 14)
    ctxs = _folds(y)
    assert tk.goss_plan(3000, 8) == (600, 600)
    calls = _inject_jax_goss(monkeypatch)
    pts = [dict(max_depth=d, max_iter=4, min_child_weight=30.0)
           for d in (8, 9)]
    jm, tm, jtrees, jleaves, _, tg = _run_both(
        JGBT(), OpGBTRegressor(), pts, "RootMeanSquaredError", X, y, ctxs,
        monkeypatch)
    assert tm.shape == jm.shape == (2, 3)
    assert (tg.best_len == 4).all() and tg.trees_grown == 4 * 6
    picked = {(rid, chain): idx for rid, chain, idx in calls}
    assert sorted(picked) == [(r, s) for r in range(4) for s in range(6)]

    def rows_of(s, r):
        rows = np.zeros(len(y), bool)
        rows[picked[(r, s)]] = True
        return rows

    assert _compare_chains(jtrees, jleaves, tg, X, ctxs, [8, 9],
                           rows_of) == 0
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-5)


def test_goss_round_matches_jax_with_its_selection(monkeypatch):
    """A depth-8 sequential GBT fit with GOSS forced on (TMOG_GOSS=1), the
    JAX package's ``_goss_select`` rows fed to the port: every round's
    tree equal up to ties (here none) and the margins' predictions within
    1e-5 relative; the fit grows max_iter rounds, none past it."""
    import jax.numpy as jnp  # noqa: F401  (the JAX package's backend)

    tt.set_device("cpu")
    monkeypatch.setenv("TMOG_GOSS", "1")
    monkeypatch.setenv("TMOG_COST_HISTORY", "0")
    rng = np.random.default_rng(21)
    X = rng.normal(size=(4000, 8)).astype(np.float32)
    y = (20 + 5 * X[:, 0] - 4 * X[:, 1] * X[:, 2]
         + 2 * rng.normal(size=4000)).astype(np.float32)
    kw = dict(max_depth=8, max_iter=3, step_size=0.3, min_child_weight=20.0)
    assert tk.goss_plan(4000, 8) == (800, 800)
    jmodel = JGBT(**kw).fit_raw(X, y)
    calls = _inject_jax_goss(monkeypatch)
    est = OpGBTRegressor(**kw)
    model = est.fit_raw(X, y, device="cpu")
    assert est.metadata["goss"] == [800, 800]
    assert [c[:2] for c in calls] == [(0, 0), (1, 0), (2, 0)]
    assert est.metadata["rounds_grown"] == 3
    assert est.metadata["hist_levels"] == 3 * 8
    binned = tk.apply_bins(torch.from_numpy(X), model.edges).numpy()
    jf, jt, jl = (np.asarray(a) for a in (jmodel.feat, jmodel.thresh,
                                          jmodel.leaf))
    ties = 0
    for r in range(3):
        # a round's tree grows on its selected rows only
        rows = np.zeros(len(y), bool)
        rows[calls[r][2]] = True
        assert rows.sum() == 1600
        ties += _assert_same_tree(
            jf[r], jt[r], jl[r], model.feat[r].numpy(),
            model.thresh[r].numpy(), model.leaf[r].numpy(), binned, rows, 8)
    assert ties == 0
    got = model.predict_batch(torch.from_numpy(X)).prediction.numpy()
    want = np.asarray(jmodel.predict_batch(X).prediction)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_goss_select_contract():
    """The port's own GOSS draw: the k_top rows of largest |g| (ties to
    the smaller row id) at weight 1, k_rest distinct other rows at weight
    (N - k_top) / k_rest, deterministic in (seed, round, chain) and
    different across rounds and chains; the rest drawn uniformly (each
    other row's inclusion frequency over 400 draws near k_rest / (N -
    k_top), within 5 binomial standard deviations)."""
    n, k_top, k_rest = 1000, 200, 150
    ga = torch.from_numpy(np.random.default_rng(0).random(n).astype(
        np.float32))
    ga[10] = ga[11] = 5.0         # a tie among the largest
    idx, mult = tk.goss_select(ga, 7, 3, 1, k_top, k_rest)
    top, rest = idx[:k_top], idx[k_top:]
    want_top = np.argsort(-ga.numpy(), kind="stable")[:k_top]
    np.testing.assert_array_equal(top.numpy(), want_top)
    assert top[0] == 10 and top[1] == 11
    assert len(set(rest.tolist())) == k_rest
    assert not set(rest.tolist()) & set(top.tolist())
    assert (mult[:k_top] == 1).all()
    assert torch.allclose(mult[k_top:], torch.tensor((n - k_top) / k_rest))
    again = tk.goss_select(ga, 7, 3, 1, k_top, k_rest)[0]
    assert torch.equal(idx, again)
    for other in ((7, 4, 1), (7, 3, 2), (8, 3, 1)):
        assert not torch.equal(tk.goss_select(ga, *other, k_top, k_rest)[0],
                               idx)
    counts = np.zeros(n)
    for r in range(400):
        counts[tk.goss_select(ga, 1, r, 0, k_top, k_rest)[0][k_top:]
               .numpy()] += 1
    others = np.setdiff1d(np.arange(n), want_top)
    p = k_rest / (n - k_top)
    sd = np.sqrt(400 * p * (1 - p))
    assert counts[want_top].sum() == 0
    assert np.abs(counts[others] - 400 * p).max() <= 5 * sd
