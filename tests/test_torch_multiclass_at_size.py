"""The multiclass phase's K-class forest at 100 000 rows, port against the
JAX package on the CPU.

The data is ``chip_smoke.make_multiclass_data``'s recipe (500 Real
columns of ``make_data``, seed 11; five classes whose logits are linear
in their own 20 columns, priors 0.40 / 0.25 / 0.15 / 0.12 / 0.08, Gumbel
noise) cut from 1M to 100 000 training rows.  The port grows the default
grid's loosest K-class forest (50 trees, depth 12, min instances 10, min
info gain 0.001, 22-column subsets) with the JAX package's bags on the
first of the selector's 3 stratified folds, as ``RFGridGroup`` does.

 * Leaves, every tree (one case a tree): the K class shares of the
   bagged, fold-weighted training rows that the tree's own splits route
   to each leaf, recomputed in numpy, equal the port's leaves bitwise
   (integer sums, one float32 division; an empty leaf is 0).
 * Splits: the JAX package draws each tree's bag and subset from (seed,
   tree), so its forest of the first ``CHECKED`` trees is the first
   ``CHECKED`` trees of the 50-tree forest, and a tree's top levels do
   not depend on the depth it grows to.  Its depth-``TOP`` forest of
   those trees must have the port's bin edges, the splits of the port's
   depth-12 trees on their top ``TOP`` levels (the second tree splits on
   all 12), and the port's own depth-``TOP`` fit's splits and leaves
   (1e-6).  Growing the JAX package's trees to depth 12 here takes ~25 s
   a tree on two cores, minutes in a parallel test run.
 * Scores: the JAX package's ``TreeEnsembleModel`` scores the port's
   50-tree forest on the held-out fold's first ``SCORED`` rows (its host
   path): probabilities within 1e-6 (a float32 sum over trees in another
   order) and the same class on every row whose top two probabilities
   differ by more than 1e-6.
 * The baseline, and why: the forest's argmax is the majority class on
   at least 95% of the held-out rows and its F1 within 0.05 of always
   predicting class 0 (the softmax LR reaches ~0.65 on the same recipe at
   1M rows), while every class's one-vs-rest AuROC of its probability
   passes 0.6: the forest ranks the classes, but its mean of 50 trees,
   each seeing ~4 of the 100 informative columns, keeps every
   probability too close to the priors for the argmax to leave the
   majority class.  This is the F1 the card's ``multiclass`` phase reads
   for every forest candidate at 1M rows.

torch runs on one intra-op thread here: inside the parallel test run the
CPU is shared, and this module's sums (integers, or held to 1e-6) do not
depend on it.  ``-s`` prints the readings."""
import numpy as np
import pytest
import torch

import chip_smoke
import transmogrifai_tpu_torch as tt
from test_torch_multiclass import JRF, _jax_bags, tk
from transmogrifai_tpu.models.trees import TreeEnsembleModel as JTreeModel
from transmogrifai_tpu_torch.evaluators.metrics import (auroc_device,
                                                        multiclass_metrics)
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.selector.validators import make_folds

ROWS, COLS, DEPTH, BINS, TREES, CHECKED, TOP = (100_000, 500, 12, 32, 50,
                                                2, 6)
SCORED = 4096
GATES = dict(min_info_gain=0.001, min_instances_per_node=10)
K = chip_smoke.MC_CLASSES


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def grown(one_thread):
    """(X, y, fold ids, fold-0 training weights, the port's 50-tree
    forest, its binned matrix, the bags it drew) on the recipe's rows."""
    tt.set_device("cpu")
    train, _, _, _, _ = chip_smoke.make_multiclass_data(
        chip_smoke.make_datasets(ROWS, ROWS // 10, COLS))
    X = np.stack([train[f"f{j}"].values for j in range(COLS)],
                 axis=1).astype(np.float32)
    y = np.asarray(train["label"].values, np.float32)
    fold = make_folds(len(y), 3, y, stratify=True, seed=42)
    w = (fold != 0).astype(np.float32)
    drawn = []

    def bags(*args):
        out = _jax_bags(*args)
        drawn.append(out[0].numpy())
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tk, "rf_bags_and_features", bags)
        tm = OpRandomForestClassifier(num_trees=TREES, max_depth=DEPTH,
                                      **GATES).fit_raw(X, y, w)
    assert tm.leaf.shape == (TREES, 2 ** DEPTH, K) and len(drawn) == 1
    binned = tk.apply_bins(torch.from_numpy(X), tm.edges).numpy()
    return X, y, fold, w, tm, binned, drawn[0]


def _split_levels(thresh: np.ndarray) -> np.ndarray:
    """Per tree of a (T, 2^depth - 1) threshold heap in level order: the
    number of levels that split (unsplit nodes hold the sentinel BINS)."""
    level = np.floor(np.log2(np.arange(thresh.shape[1]) + 1)).astype(int)
    return np.where(thresh != BINS, level + 1, 0).max(axis=1)


@pytest.mark.parametrize("tree", range(TREES))
def test_leaves_are_the_class_shares_of_their_rows(grown, tree):
    """Tree ``tree``'s leaves, recomputed from its splits, the bag it drew
    and the fold's weights."""
    _, y, _, w, tm, binned, bags = grown
    feat, thresh = tm.feat.numpy()[tree], tm.thresh.numpy()[tree]
    rows = np.arange(len(y))
    node = np.zeros(len(y), np.int64)
    for level in range(DEPTH):
        at = 2 ** level - 1 + node
        x, t = binned[rows, feat[at]].astype(np.int64), thresh[at]
        # the split rule: bin > t goes right; t == BINS never splits; a
        # negative t is threshold -t-1 with bin 0 sent right
        right = np.where(t < 0, (x > -t - 1) | (x == 0), x > t)
        node = 2 * node + right
    bw = (bags[tree] * w).astype(np.float64)
    total = np.bincount(node, weights=bw, minlength=2 ** DEPTH)
    share = [np.bincount(node, weights=bw * (y == k), minlength=2 ** DEPTH)
             for k in range(K)]
    want = np.stack(share, 1).astype(np.float32) / np.maximum(
        total, 1e-12).astype(np.float32)[:, None]
    np.testing.assert_array_equal(tm.leaf.numpy()[tree], want)


def test_top_levels_equal_jax(grown):
    """The first ``CHECKED`` trees: the JAX package's depth-``TOP`` fit
    has the port's bin edges, the splits of the port's depth-12 trees on
    their top ``TOP`` levels, and the port's depth-``TOP`` fit's splits
    and K-class leaves (1e-6)."""
    X, y, _, w, tm, _, _ = grown
    jm = JRF(num_trees=CHECKED, max_depth=TOP, **GATES).fit_raw(X, y, w)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tk, "rf_bags_and_features", _jax_bags)
        t6 = OpRandomForestClassifier(num_trees=CHECKED, max_depth=TOP,
                                      **GATES).fit_raw(X, y, w)
    np.testing.assert_array_equal(tm.edges, np.asarray(jm.edges))
    top = 2 ** TOP - 1
    for feat, thresh in [(tm.feat.numpy()[:CHECKED, :top],
                          tm.thresh.numpy()[:CHECKED, :top]),
                         (t6.feat.numpy(), t6.thresh.numpy())]:
        np.testing.assert_array_equal(feat, np.asarray(jm.feat))
        np.testing.assert_array_equal(thresh, np.asarray(jm.thresh))
    np.testing.assert_allclose(t6.leaf.numpy(), np.asarray(jm.leaf),
                               rtol=0, atol=1e-6)
    split = _split_levels(tm.thresh.numpy())
    assert split[:CHECKED].max() == DEPTH
    print(f"\n{ROWS} rows: trees by levels that split "
          f"{np.bincount(split, minlength=DEPTH + 1).tolist()}, the first "
          f"{CHECKED} {split[:CHECKED].tolist()}")


def test_scores_match_jax_at_the_majority_baseline(grown):
    """Both packages score the port's forest alike on the held-out fold,
    at the majority-class baseline, while its probabilities rank every
    class."""
    X, y, fold, _, tm, _, _ = grown
    Xv, yv = X[fold == 0], y[fold == 0].astype(np.int64)
    port = tm.predict_batch(torch.from_numpy(Xv))
    P = port.probability.numpy()
    jm = JTreeModel("rf_cls", tm.edges, tm.feat.numpy(), tm.thresh.numpy(),
                    tm.leaf.numpy(), n_classes=K)
    JP = np.asarray(jm.predict_batch(Xv[:SCORED]).probability)
    np.testing.assert_allclose(P[:SCORED], JP, rtol=0, atol=1e-6)
    top2 = np.sort(JP, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-6
    pred = port.prediction.numpy().astype(np.int64)
    np.testing.assert_array_equal(pred[:SCORED][clear], JP.argmax(1)[clear])

    yt = torch.from_numpy(yv)
    f1 = multiclass_metrics(yt, torch.from_numpy(pred), K)["F1"]
    majority = multiclass_metrics(yt, torch.zeros_like(yt), K)["F1"]
    share0 = float((pred == 0).mean())
    auc = [float(auroc_device(torch.from_numpy((yv == k).astype(np.float64)),
                              torch.from_numpy(P[:, k].astype(np.float64))))
           for k in range(K)]
    print(f"\nheld-out fold {len(yv)} rows: F1 {f1} (majority {majority}), "
          f"class 0 predicted on {share0}, one-vs-rest AuROC {auc}, "
          f"mean probabilities {P.mean(0).tolist()}")
    assert share0 >= 0.95 and abs(f1 - majority) <= 0.05
    assert min(auc) > 0.6
