"""The port's sweep memo (``models.trees.memo_get``): one sketch and one
binning per distinct (matrix, sketch), on the CPU.

* Several sequential fits on one matrix (boosted, forest, decision tree,
  and the scoring of that matrix with their edges) build one binning.
* An in-place write to the matrix misses (its version counter moves); a
  new view of it misses; the entries of a freed matrix go with it.
* ``clear_sweep_caches`` and the end of ``OpWorkflow.train()`` empty it;
  past ``_BIN_CACHE_CAPACITY`` entries the oldest goes first.
* Models are bitwise equal with the memo on and off.
* The selector's ``sequential_fits`` record the binnings each fit built,
  and ``tree_binnings`` the sweep's: one for a multiclass selector over
  XGBoost and decision-tree grids (13 fits on one matrix).
"""
import gc

import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu_torch.models import trees as ttr

STATS = ttr.MEMO_STATS


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("TMOG_EFB", "TMOG_GOSS", "TMOG_SPARSE_HIST"):
        monkeypatch.delenv(var, raising=False)
    ttr.clear_sweep_caches()
    yield
    ttr.clear_sweep_caches()


def _data(n=1200, d=12, seed=3, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    z = X[:, 0] * 1.5 - X[:, 1] + 0.5 * rng.normal(size=n)
    if classes == 2:
        y = (z > 0).astype(np.float32)
    else:
        y = np.digitize(z, np.quantile(z, np.linspace(0, 1, classes + 1)
                                       [1:-1])).astype(np.float32)
    return torch.from_numpy(X), y


def _fits(X, y):
    """A boosted fit, a forest and a decision tree on ``X``, each scored
    on ``X``; their models."""
    w = np.ones(len(y), np.float32)
    w[::3] = 0
    models = [
        ttr.OpGBTClassifier(max_iter=3, max_depth=3).fit_raw(X, y, w,
                                                             device="cpu"),
        ttr.OpRandomForestClassifier(num_trees=3, max_depth=3).fit_raw(
            X, y, device="cpu"),
        ttr.OpDecisionTreeClassifier(max_depth=4).fit_raw(X, y,
                                                          device="cpu")]
    for m in models:
        m.predict_batch(X)
    return models


def test_one_binning_for_many_fits():
    X, y = _data()
    built, hits = STATS["binnings"], STATS["binning_hits"]
    _fits(X, y)
    # a dense matrix: the boosted fit's and the forest's sketch is the
    # decision tree's dense one
    assert STATS["binnings"] - built == 1
    assert STATS["binning_hits"] - hits == 5
    _fits(X, y)
    assert STATS["binnings"] - built == 1


def test_inplace_write_and_new_view_miss():
    X, y = _data()
    m0 = ttr.OpGBTClassifier(max_iter=2, max_depth=3).fit_raw(
        X, y, device="cpu")
    built = STATS["binnings"]
    X[0, 0] = 50.0
    m1 = ttr.OpGBTClassifier(max_iter=2, max_depth=3).fit_raw(
        X, y, device="cpu")
    assert STATS["binnings"] - built == 1
    # the binned matrix served now is the written one's
    top = int(np.isfinite(m1.edges[0]).sum())
    assert int(ttr.binned_for_edges(X, m1.edges)[0, 0]) == top
    assert int(ttr.binned_for_edges(X, m0.edges)[0, 0]) == top
    ttr.OpGBTClassifier(max_iter=2, max_depth=3).fit_raw(X[:], y,
                                                         device="cpu")
    assert STATS["binnings"] - built == 2


def test_freed_matrix_drops_its_entries():
    X, y = _data()
    ttr.OpGBTClassifier(max_iter=2, max_depth=3).fit_raw(X, y, device="cpu")
    assert len(ttr._MEMO) > 0
    del X
    gc.collect()
    assert len(ttr._MEMO) == 0 and not ttr._MEMO_OWNERS


def test_clear_and_train_end_empty_it():
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder
    from transmogrifai_tpu_torch.ops.vectorizers import VectorsCombiner
    from transmogrifai_tpu_torch.types import feature_types as ft
    from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                       FeatureColumn)
    from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

    X, y = _data()
    ttr.OpGBTClassifier(max_iter=2, max_depth=3).fit_raw(X, y, device="cpu")
    assert len(ttr._MEMO) > 0
    ttr.clear_sweep_caches()
    assert len(ttr._MEMO) == 0
    built = STATS["binnings"]
    ttr.OpGBTClassifier(max_iter=2, max_depth=3).fit_raw(X, y, device="cpu")
    assert STATS["binnings"] - built == 1

    label = FeatureBuilder.RealNN("label").as_response()
    vec = VectorsCombiner().set_input(
        FeatureBuilder.OPVector("X").as_predictor()).get_output()
    pred = label.transform_with(
        ttr.OpGBTClassifier(max_iter=2, max_depth=3), vec)
    built = STATS["binnings"]
    OpWorkflow().set_result_features(pred).set_input_data(ColumnarDataset({
        "X": FeatureColumn.from_values(ft.OPVector, X.numpy()),
        "label": FeatureColumn.from_values(ft.RealNN, y)})).train()
    assert STATS["binnings"] - built == 1
    assert len(ttr._MEMO) == 0 and not ttr._MEMO_OWNERS


def test_lru_eviction(monkeypatch):
    monkeypatch.setattr(ttr, "_BIN_CACHE_CAPACITY", 4)
    mats = [_data(seed=s)[0] for s in range(3)]
    built = STATS["binnings"]
    for X in mats:          # two entries each: edges, binned
        ttr.prep_tree_inputs(X, 32)
    assert len(ttr._MEMO) == 4 and STATS["binnings"] - built == 3
    ttr.prep_tree_inputs(mats[2], 32)          # the newest: a hit
    assert STATS["binnings"] - built == 3
    ttr.prep_tree_inputs(mats[0], 32)          # the oldest went first
    assert STATS["binnings"] - built == 4
    assert len(ttr._MEMO) == 4


def test_models_bitwise_with_memo_on_and_off(monkeypatch):
    X, y = _data(classes=2)
    on = _fits(X, y)
    ttr.clear_sweep_caches()
    monkeypatch.setattr(ttr, "_BIN_CACHE_CAPACITY", 0)
    off = _fits(X, y)
    assert len(ttr._MEMO) == 0
    for a, b in zip(on, off):
        assert np.array_equal(a.edges, b.edges)
        for attr in ("feat", "thresh", "leaf"):
            assert torch.equal(getattr(a, attr), getattr(b, attr)), attr


def test_selector_counts_binnings():
    """The multiclass selector of the card's ``boosted_multi`` phase, cut
    to size: 4 candidates x 3 folds + the winner's refit, every one a
    sequential fit, served by one binning of the checked matrix."""
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder
    from transmogrifai_tpu_torch.models.trees import (
        OpDecisionTreeClassifier, OpXGBoostClassifier)
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.preparators.sanity_checker import \
        SanityChecker
    from transmogrifai_tpu_torch.selector.model_selector import (
        MultiClassificationModelSelector, grid)
    from transmogrifai_tpu_torch.types import feature_types as ft
    from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                       FeatureColumn)
    from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

    X, y = _data(n=900, d=6, classes=3)
    label = FeatureBuilder.RealNN("label").as_response()
    names = [f"f{j}" for j in range(6)]
    preds = [FeatureBuilder.Real(nm).as_predictor() for nm in names]
    checked = label.transform_with(SanityChecker(max_correlation=0.99),
                                   transmogrify(preds))
    sel = MultiClassificationModelSelector.with_cross_validation(
        models_and_parameters=[
            (OpXGBoostClassifier(num_round=3, eta=0.3,
                                 early_stopping_rounds=0),
             grid(max_depth=[2, 3])),
            (OpDecisionTreeClassifier(),
             grid(max_depth=[3, 4], min_instances_per_node=[10]))])
    pred = label.transform_with(sel, checked)
    cols = {nm: FeatureColumn.from_values(ft.Real, X[:, j].numpy())
            for j, nm in enumerate(names)}
    cols["label"] = FeatureColumn.from_values(ft.RealNN, y)
    OpWorkflow().set_result_features(pred).set_input_data(
        ColumnarDataset(cols)).train()
    fits = sel.metadata["sequential_fits"]
    assert len(fits) == 13
    assert sum(f["binnings_built"] for f in fits) == 1
    assert fits[0]["binnings_built"] == 1
    assert sel.metadata["tree_binnings"]["binnings"] == 1
    assert sel.metadata["tree_binnings"]["binning_hits"] >= 12
