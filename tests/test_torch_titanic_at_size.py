"""The Titanic demo's depth-12 forest at 100 000 rows, port against the
JAX package and numpy on the CPU.

At this size the checked matrix (~570 columns, ~97% zero) is above the
sparse rule's element count, so both packages take the nonzero-aware
sketch unpatched (the same edges).  The port grows the demo's depth-12
forest (50 trees, min info gain 0.001) with the JAX package's bags on
the first of the selector's 3 folds; most of its trees split on no level
or on one.

 * Splits against the JAX package: the JAX package draws each tree's bag
   and subset from (seed, tree), so it can grow any one tree of the
   forest alone (``_grow_chunk_rf`` from that tree's id).  It grows the
   first two trees that split and the tree that splits deepest, to the
   first level on which none of them splits (a node that does not split
   passes its rows to one child, whose histograms are its own, so no tree
   splits below that level).  Their splits must equal the port's and
   their leaves the port's bitwise.  (Growing the whole forest in the JAX
   package, which builds every level of its compile depth on the CPU,
   cost minutes inside the parallel test run.)
 * Every tree against numpy: its leaves are the class shares of the
   bagged, fold-weighted rows its own splits route to them (bitwise), and
   its root decision is the gain rule's: a root that does not split has
   no subset split whose gain per unit of node weight reaches
   ``min_info_gain`` (float64 gains), and a root that splits cuts the
   rows as numpy's best split does.
 * The histogram levels the port counts (one kernel launch each on the
   card) are those its trees imply: a tree builds every level down to its
   first level without a split, plus the one enqueued before that flag is
   read, at most ``max_depth``.

This holds the early stop the demo's forests show at size to the JAX
package's gain and ``min_info_gain`` rules, not only at 3 000 rows
(``tests/test_torch_titanic_sketch.py::test_forests_equal``).  torch runs
on one intra-op thread (a module fixture).  ``-s`` prints the count of
trees by their levels that split."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import transmogrifai_tpu_torch as tt
from test_torch_titanic import (  # noqa: F401  the shared fixtures
    PORT, OpRandomForestClassifier, OpWorkflow, _cpu, _jax_bags, build_demo,
    jg, one_thread, titanic_frame, tk, ttrees)
from transmogrifai_tpu.models import trees as jtrees
from transmogrifai_tpu_torch.selector.validators import make_folds

ROWS, DEPTH, BINS, TREES, MIN_IG = 100_000, 12, 32, 50, 0.001


def _split_levels(thresh: np.ndarray) -> np.ndarray:
    """Per tree of a (T, 2^depth - 1) threshold heap in level order: the
    number of levels that split (a node splits unless its threshold is
    the sentinel ``BINS``; the splitting levels are the top ones)."""
    level = np.floor(np.log2(np.arange(thresh.shape[1]) + 1)).astype(int)
    return np.where(thresh != BINS, level + 1, 0).max(axis=1)


def _route(binned, feat, thresh, depth):
    """Leaf ids (N,) of one tree's heap on ``binned`` (the split rule:
    bin > t goes right, t == BINS never splits)."""
    rows = np.arange(binned.shape[0])
    node = np.zeros(binned.shape[0], np.int64)
    for level in range(depth):
        at = 2 ** level - 1 + node
        node = 2 * node + (binned[rows, feat[at]] > thresh[at])
    return node


def _root_best(sub, y, bw):
    """numpy's best root split of a binary forest tree over its subset
    columns ``sub`` (N, m): float64 gains of the forests' rule (channels
    bw [y=0] and bw, the class-1 sum the count minus class 0's, lambda
    1e-3, at least 1 of bag weight a side, thresholds below B - 1);
    returns (best gain / node weight, column, threshold)."""
    lam = 1e-3
    best = (-np.inf, -1, -1)
    ctot = bw.sum()
    g0tot = (bw * (y == 0)).sum()
    for j in range(sub.shape[1]):
        c = np.cumsum(np.bincount(sub[:, j], weights=bw, minlength=BINS))
        g0 = np.cumsum(np.bincount(sub[:, j], weights=bw * (y == 0),
                                   minlength=BINS))
        gain = 0.0
        for gl, gt in ((g0, g0tot), (c - g0, ctot - g0tot)):
            gr = gt - gl
            gain = gain + (gl ** 2 / (c + lam) + gr ** 2 / (ctot - c + lam)
                           - gt ** 2 / (ctot + lam))
        ok = (c >= 1) & (ctot - c >= 1) & (np.arange(BINS) < BINS - 1)
        gain = np.where(ok, gain, -np.inf)
        t = int(np.argmax(gain))
        if gain[t] / ctot > best[0]:
            best = (gain[t] / ctot, j, t)
    return best


def test_forest_levels_at_100k():
    """The demo's depth-12 forest on 100 000 rows: the trees the JAX
    package grows equal the port's, every tree's leaves and root decision
    match numpy, and the port's histogram levels are those of its
    trees."""
    tt.set_device("cpu")
    df = titanic_frame(ROWS, seed=3)
    _, checked, _ = build_demo(PORT, with_selector=False)
    X = OpWorkflow().set_result_features(checked).set_input_data(
        df).train().train_data[checked.name].values.numpy()
    y = df["Survived"].to_numpy().astype(np.float32)
    w = (make_folds(len(y), 3, y, stratify=True, seed=42) != 0).astype(
        np.float32)
    kinds = dict(ttrees.SKETCH_KINDS)
    drawn = []

    def bags(*args):
        out = _jax_bags(*args)
        drawn.append([a.numpy() for a in out])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tk, "rf_bags_and_features", bags)
        est = OpRandomForestClassifier(max_depth=DEPTH, num_trees=TREES,
                                       min_info_gain=MIN_IG)
        tm = est.fit_raw(X, y, w)
    kinds = {k: ttrees.SKETCH_KINDS[k] - kinds[k] for k in kinds}
    assert kinds == {"dense": 0, "sparse_aware": 1}
    (bag, fidx), = drawn
    feat, thresh, leaf = (a.numpy() for a in (tm.feat, tm.thresh, tm.leaf))
    split = _split_levels(thresh)

    # the JAX package's trees: the first two that split, the deepest
    edges_j, binned_j, _ = jtrees._prep_tree_inputs_sparse(X, BINS)
    np.testing.assert_array_equal(tm.edges, np.asarray(edges_j))
    grown = sorted({*np.flatnonzero(split > 0)[:2].tolist(),
                    int(np.argmax(split))})
    depth = min(DEPTH, int(split[grown].max()) + 1)
    Y = jnp.asarray(np.eye(2, dtype=np.float32)[y.astype(int)])
    top = 2 ** depth - 1
    for t in grown:
        f, th, lf = (np.asarray(a)[0] for a in jg._grow_chunk_rf(
            binned_j, Y, jnp.asarray(w), jnp.int32(est.seed), jnp.int32(t),
            jnp.int32(TREES), jnp.int32(depth), jnp.float32(1.0), 1,
            fidx.shape[1], depth, BINS, jnp.float32(1e-3), jnp.float32(0.0),
            jnp.float32(MIN_IG), jnp.float32(1.0), jnp.float32(1.0),
            onehot_targets=True, hist_bf16=False))
        np.testing.assert_array_equal(feat[t, :top], f)
        np.testing.assert_array_equal(thresh[t, :top], th)
        # a row of a node on level ``depth`` goes left down to the port's
        # leaves: its leaf is the first of the node's 2^(12 - depth)
        lt = leaf[t].reshape(2 ** depth, 2 ** (DEPTH - depth), -1)
        np.testing.assert_array_equal(lt[:, 0], lf)
        assert not lt[:, 1:].any()
    assert (thresh[:, 2 ** (int(split.max()) + 1) - 1:] == BINS).all()

    # every tree against numpy: leaves and the root's decision
    binned = tk.apply_bins(torch.from_numpy(X), tm.edges).numpy()
    for t in range(TREES):
        bw = (bag[t] * w).astype(np.float64)
        node = _route(binned, feat[t], thresh[t], DEPTH)
        total = np.bincount(node, weights=bw, minlength=2 ** DEPTH)
        share = np.stack([np.bincount(node, weights=bw * (y == k),
                                      minlength=2 ** DEPTH)
                          for k in range(2)], 1)
        want = share.astype(np.float32) / np.maximum(
            total, 1e-12).astype(np.float32)[:, None]
        np.testing.assert_array_equal(leaf[t], want)
        ratio, j, tb = _root_best(binned[:, fidx[t]].astype(np.int64), y, bw)
        if thresh[t, 0] == BINS:
            assert ratio < MIN_IG, (t, ratio)
        else:
            assert ratio >= MIN_IG
            np.testing.assert_array_equal(
                binned[:, feat[t, 0]] > thresh[t, 0],
                binned[:, fidx[t, j]] > tb)
    assert est.metadata["hist_levels"] == int(
        np.minimum(split + 2, DEPTH).sum())
    print(f"\n{ROWS} rows x {X.shape[1]} columns: trees by levels that "
          f"split {np.bincount(split, minlength=DEPTH + 1).tolist()}, "
          f"{est.metadata['hist_levels']} histogram levels, the JAX "
          f"package's trees {grown} to depth {depth}")
