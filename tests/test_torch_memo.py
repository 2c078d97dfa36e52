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


# -- the in-flight dedupe and the tree-prep prefetch thread -----------------

def _concurrently(*fns):
    import threading

    out = [None] * len(fns)
    errs = []

    def run(i, fn):
        try:
            out[i] = fn()
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i, fn))
          for i, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    return out, errs


def test_two_threads_on_one_key_build_once():
    import threading
    import time

    X = torch.zeros(10, 2)
    builds = []
    started = threading.Event()

    def build():
        builds.append(1)
        started.set()
        time.sleep(0.3)
        return torch.ones(3)

    def second():
        started.wait(5)
        return ttr.memo_get(X, "probe", (1,), build)

    out, errs = _concurrently(
        lambda: ttr.memo_get(X, "probe", (1,), build), second)
    assert not errs and len(builds) == 1
    assert out[0] is out[1]


def test_a_failed_owner_lets_the_waiter_build():
    import threading
    import time

    X = torch.zeros(10, 2)
    started = threading.Event()
    calls = []

    def failing():
        calls.append("owner")
        started.set()
        time.sleep(0.3)
        raise RuntimeError("owner's build failed")

    def waiter():
        started.wait(5)
        return ttr.memo_get(X, "probe", (2,), lambda: (calls.append(
            "waiter"), torch.full((2,), 7.0))[1])

    out, errs = _concurrently(
        lambda: ttr.memo_get(X, "probe", (2,), failing), waiter)
    assert [str(e) for e in errs] == ["owner's build failed"]
    assert calls == ["owner", "waiter"]
    assert torch.equal(out[1], torch.full((2,), 7.0))
    assert not ttr._MEMO_INFLIGHT


def test_a_clear_during_a_build_drops_its_insert():
    X = torch.zeros(10, 2)

    def build():
        ttr.clear_sweep_caches()   # a train ends while the build runs
        return torch.ones(1)

    val = ttr.memo_get(X, "probe", (3,), build)
    assert torch.equal(val, torch.ones(1)) and len(ttr._MEMO) == 0
    # the next build of the key is inserted
    ttr.memo_get(X, "probe", (3,), lambda: torch.ones(1))
    assert len(ttr._MEMO) == 1


def _prefetch_selector():
    from transmogrifai_tpu_torch.models.classification import \
        OpLogisticRegression
    from transmogrifai_tpu_torch.selector.model_selector import (
        ModelSelector, grid)
    from transmogrifai_tpu_torch.selector.validators import \
        OpCrossValidation

    return ModelSelector(
        [(OpLogisticRegression(), grid(reg_param=[0.01, 0.1])),
         (ttr.OpRandomForestClassifier(num_trees=4, seed=3),
          [{"max_depth": 3}, {"max_depth": 4}])],
        problem_type="binary",
        validator=OpCrossValidation(num_folds=2, stratify=True))


def _fit_selector(sel, X, y):
    from transmogrifai_tpu_torch.types import feature_types as ft
    from transmogrifai_tpu_torch.types.columns import FeatureColumn

    return sel.fit_columns(None, FeatureColumn.from_values(
        ft.RealNN, y.astype(np.float64)), FeatureColumn(ft.OPVector, X))


def test_prefetch_drained_after_a_fit(monkeypatch):
    """The prefetch thread builds the forests' binning (the group then
    finds it in the memo) and is joined by the end of the fit."""
    from transmogrifai_tpu_torch.selector.model_selector import ModelSelector
    from transmogrifai_tpu_torch.utils.profiling import (MetricsCollector,
                                                         install_collector)

    monkeypatch.setattr(ModelSelector, "_PREFETCH_MIN_ELEMS", 0)
    X, y = _data(n=400, d=6, seed=13)
    sel = _prefetch_selector()
    built = STATS["binnings"]
    coll = MetricsCollector()
    with install_collector(coll):
        _fit_selector(sel, X, y)
    assert sel._prep_thread is None
    assert sel.metadata["tree_prefetch"]["joined"] is True
    assert sel.metadata["tree_prefetch"]["seconds"] >= 0
    assert "prefetchTreePrepSecs" in coll.metrics.custom_tags
    assert STATS["binnings"] - built == 1      # one binning, shared


def test_prefetch_drained_on_an_injected_device_loss(monkeypatch):
    """A device loss in the LR group fires the elastic shrink hook, which
    joins the prefetch thread before the members re-run; the fit ends
    with no thread alive."""
    from transmogrifai_tpu_torch.selector.model_selector import ModelSelector
    from transmogrifai_tpu_torch.utils import faults

    monkeypatch.setattr(ModelSelector, "_PREFETCH_MIN_ELEMS", 0)
    X, y = _data(n=400, d=6, seed=14)
    sel = _prefetch_selector()
    seen = []
    drain = sel._drain_tree_prefetch

    def recording_drain(*a, **k):
        t = sel._prep_thread
        drain(*a, **k)
        seen.append(t is None or not t.is_alive())

    monkeypatch.setattr(sel, "_drain_tree_prefetch", recording_drain)
    with pytest.warns(RuntimeWarning, match="falling back"):
        with faults.inject(faults.FaultSpec(
                point="device.loss", action="device_loss", at=1, times=1)):
            _fit_selector(sel, X, y)
    assert sel.metadata["elastic"]["deviceLosses"] == 1
    assert sel.metadata["elastic"]["retries"] == 1
    assert len(seen) >= 2 and all(seen)
    assert sel._prep_thread is None


def test_memo_under_thread_contention():
    """24 threads, more than the cores, over 6 keys of one matrix with a
    short switch interval: every key is built exactly once and every
    caller gets that build's value (a lost update or a double build would
    break it)."""
    import sys
    import threading

    X = torch.zeros(10, 2)
    builds: dict = {}
    lock = threading.Lock()

    def builder(k):
        def build():
            with lock:
                builds[k] = builds.get(k, 0) + 1
            return torch.full((1,), float(k))
        return build

    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out, errs = _concurrently(*[
            (lambda k=i % 6: ttr.memo_get(X, "stress", (k,), builder(k)))
            for i in range(24)])
        got = [float(v) for v in out]
    finally:
        sys.setswitchinterval(old)
    assert not errs
    assert builds == {k: 1 for k in range(6)}
    assert got == [float(i % 6) for i in range(24)]
