"""The Titanic demo's depth-12 forest at 100 000 rows, port against the
JAX package on the CPU.

At this size the checked matrix (~570 columns, ~97% zero) is above the
sparse rule's element count, so both packages take the nonzero-aware
sketch unpatched.  The port grows the demo's depth-12 forest (50 trees,
min info gain 0.001) with the JAX package's bags on the first of the
selector's 3 folds; most of its trees split on no level or on one.  The
JAX package grows the same forest to the first level on which none of
the port's trees splits: a node that does not split passes its rows to
one child, whose histograms are its own, so no tree can split below that
level, and the JAX package's trees to that depth are its whole depth-12
forest.  (On the CPU the JAX package builds every level of its compile
depth, and its levels past the seventh would cost minutes more here.)
The two forests must
have the same splits and bit-equal leaves, and the histogram levels the
port counts (one kernel launch each on the card) must be those the JAX
package's trees imply: a tree builds every level down to its first level
without a split, plus the one enqueued before that flag is read, at most
``max_depth``.  This holds the early stop the demo's forests show at
size to the JAX package's gain and ``min_info_gain`` rules, not only at
3 000 rows (``tests/test_torch_titanic_sketch.py::test_forests_equal``).
The test prints the count of trees by their levels that split."""
import numpy as np
import pytest

import transmogrifai_tpu_torch as tt
from test_torch_titanic import (  # noqa: F401  the shared fixture
    PORT, JRF, OpRandomForestClassifier, OpWorkflow, _cpu, _jax_bags,
    build_demo, titanic_frame, tk, ttrees)
from transmogrifai_tpu_torch.selector.validators import make_folds

ROWS, DEPTH, BINS = 100_000, 12, 32


def _split_levels(thresh: np.ndarray) -> np.ndarray:
    """Per tree of a (T, 2^depth - 1) threshold heap in level order: the
    number of levels that split (a node splits unless its threshold is
    the sentinel ``BINS``; the splitting levels are the top ones)."""
    level = np.floor(np.log2(np.arange(thresh.shape[1]) + 1)).astype(int)
    return np.where(thresh != BINS, level + 1, 0).max(axis=1)


def test_forest_levels_at_100k():
    """The demo's depth-12 forest on 100 000 rows: the port's trees equal
    the JAX package's, and its histogram levels are those of the JAX
    package's trees."""
    tt.set_device("cpu")
    df = titanic_frame(ROWS, seed=3)
    _, checked, _ = build_demo(PORT, with_selector=False)
    X = OpWorkflow().set_result_features(checked).set_input_data(
        df).train().train_data[checked.name].values.numpy()
    y = df["Survived"].to_numpy().astype(np.float32)
    w = (make_folds(len(y), 3, y, stratify=True, seed=42) != 0).astype(
        np.float32)
    kw = dict(num_trees=50, min_info_gain=0.001)
    kinds = dict(ttrees.SKETCH_KINDS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tk, "rf_bags_and_features", _jax_bags)
        est = OpRandomForestClassifier(max_depth=DEPTH, **kw)
        tm = est.fit_raw(X, y, w)
    kinds = {k: ttrees.SKETCH_KINDS[k] - kinds[k] for k in kinds}
    assert kinds == {"dense": 0, "sparse_aware": 1}
    split = _split_levels(tm.thresh.numpy())
    depth = min(DEPTH, int(split.max()) + 1)
    jm = JRF(max_depth=depth, **kw).fit_raw(X, y, w)
    top = 2 ** depth - 1
    np.testing.assert_array_equal(tm.feat.numpy()[:, :top],
                                  np.asarray(jm.feat))
    np.testing.assert_array_equal(tm.thresh.numpy()[:, :top],
                                  np.asarray(jm.thresh))
    assert (tm.thresh.numpy()[:, top:] == BINS).all()
    # a row of a node on level ``depth`` goes left down to the port's
    # leaves: its leaf is the first of the node's 2^(12 - depth)
    leaf = tm.leaf.numpy().reshape(50, 2 ** depth, 2 ** (DEPTH - depth), -1)
    np.testing.assert_array_equal(leaf[:, :, 0], np.asarray(jm.leaf))
    assert not leaf[:, :, 1:].any()
    jsplit = _split_levels(np.asarray(jm.thresh))
    assert est.metadata["hist_levels"] == int(
        np.minimum(jsplit + 2, DEPTH).sum())
    print(f"\n{ROWS} rows x {X.shape[1]} columns: trees by levels that "
          f"split {np.bincount(jsplit, minlength=DEPTH + 1).tolist()}, "
          f"{est.metadata['hist_levels']} histogram levels")
