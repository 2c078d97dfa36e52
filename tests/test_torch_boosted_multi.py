"""The port's general tree grower and the boosted fits it carries — the
softmax objective (multiclass ``OpXGBoostClassifier``, mode
``gbdt_multi``), count-gated boosting, row and column subsampling —
against the JAX package on the CPU, at a few thousand rows x 10 columns,
depth <= 4 and <= 8 rounds.

 * The grower (bag mode ``"none"``: 2K+1 channels [G.., H.., C]) against
   the JAX package's ``grow_tree`` with a count channel, count and
   per-node-weight gain gates, a feature mask, Newton and mean leaves and
   default-direction splits: trees equal up to exact gain ties (the rule
   of ``test_torch_gbt_grid._assert_same_tree``), leaves within 1e-5.  The
   gates bite on these inputs: the same tree grown without them splits
   other nodes.
 * Softmax boosting (K = 3 and 5) with and without early stopping and
   with ``subsample``/``colsample_bytree`` < 1: both packages draw every
   round's rows and columns from ``np.random.default_rng(seed)``, so the
   round weights and feature masks they grow on are equal bitwise; trees
   equal up to ties over each round's rows, margins and probabilities
   within 1e-5.
 * Count-gated binary and regression boosting (``min_instances_per_node``
   > 1, ``min_info_gain`` > 0, fractional weights), sequential and through
   ``GBTGridGroup`` (3 channels), held as above; CV metrics within 1e-5
   where no tie routes a held-out row differently.
 * ``gbdt_multi`` artifacts saved by either package score equal in the
   other (1e-6); the local scorer agrees.
 * A multiclass selector over XGBoost and decision-tree grids (every
   candidate a sequential fit in both packages) picks the JAX package's
   winner with CV F1s within 1e-6.

torch runs on one intra-op thread (a module fixture), as in the other
heavy parity files of the port.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import transmogrifai_tpu_torch as tt
from test_torch_gbt_grid import (_assert_same_tree, _compare_chains, _folds,
                                 _make, _run_both)
from test_torch_multiclass import _dataset, _mc, _pipeline
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JEvaluators
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models import gbdt_kernels as jg
from transmogrifai_tpu.models import trees as jtr
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JSanityChecker
from transmogrifai_tpu.selector.model_selector import \
    MultiClassificationModelSelector as JMCMS
from transmogrifai_tpu.selector.model_selector import grid as jgrid
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import ColumnarDataset as JDataset
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu.workflow.workflow import \
    OpWorkflowModel as JWorkflowModel
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.local import score_function
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.models import trees as ttr
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.selector.model_selector import (
    MultiClassificationModelSelector, grid)
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import ColumnarDataset, FeatureColumn
from transmogrifai_tpu_torch.workflow.workflow import (OpWorkflow,
                                                       OpWorkflowModel)

B = 32
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# the general grower
# ---------------------------------------------------------------------------

#: the grower case's gates: each splits fewer nodes than without it
MIN_INST, MIN_GAIN = 60.0, 0.08


@pytest.fixture(scope="module")
def grower_inputs():
    """K = 3 softmax gradients and hessians at random margins on integer
    row weights 0..2 (the count channel), a feature mask and a
    default-direction mask, over 3 000 rows x 10 columns."""
    K, n = 3, 3000
    X, y = _mc(n, K, 31, nan_frac=0.0)
    X = X.astype(np.float32)
    d = X.shape[1]
    rng = np.random.default_rng(31)
    edges = tk.quantile_bins(torch.from_numpy(X), B)
    F = rng.normal(scale=0.5, size=(n, K))
    P = np.exp(F) / np.exp(F).sum(1, keepdims=True)
    w = rng.integers(0, 3, n).astype(np.float32)
    Y = np.eye(K)[y.astype(int)]
    G = (w[:, None] * (P - Y)).astype(np.float32)
    H = (w[:, None] * np.maximum(P * (1 - P), 1e-6)).astype(np.float32)
    return dict(X=X, edges=edges, G=G, H=H, w=w,
                mask=rng.random(d) < 0.7, dd=rng.random(d) < 0.5,
                binned=tk.apply_bins(torch.from_numpy(X), edges))


def _port_tree(inp, newton_leaf, default_dir, min_instances=MIN_INST,
               min_info_gain=MIN_GAIN):
    G, H, w, mask, dd = _t(inp["G"], inp["H"], inp["w"], inp["mask"],
                           inp["dd"])
    return tk.grow_tree(inp["binned"], G, H, 4, B, C=w, lam=1.0,
                        min_child_weight=0.5, min_info_gain=min_info_gain,
                        min_instances=min_instances, feat_mask=mask,
                        newton_leaf=newton_leaf, learning_rate=0.3,
                        default_dir=default_dir, dd_mask=dd)


@pytest.mark.parametrize("newton_leaf", [True, False])
@pytest.mark.parametrize("default_dir", [False, True])
def test_grower_matches_jax(grower_inputs, newton_leaf, default_dir):
    """11 = 2K+1 channels at K = 3: the port's tree equals the JAX
    package's up to ties, leaves within 1e-5; no split uses a masked
    feature, and each gate changes the tree on these inputs (so a grower
    that ignored either would not match)."""
    inp = grower_inputs
    f, t, lf = jg.grow_tree(
        jg.apply_bins(jnp.asarray(inp["X"]), jnp.asarray(inp["edges"])),
        jnp.asarray(inp["G"]), jnp.asarray(inp["H"]), jnp.asarray(inp["w"]),
        4, B, lam=1.0, min_child_weight=0.5, min_info_gain=MIN_GAIN,
        min_instances=MIN_INST, feat_mask=jnp.asarray(inp["mask"]),
        newton_leaf=newton_leaf, learning_rate=0.3, hist_bf16=False,
        seg_hist=False, default_dir=default_dir,
        dd_mask=jnp.asarray(inp["dd"]))
    tree = _port_tree(inp, newton_leaf, default_dir)
    assert tree.leaf.shape == (16, 3)
    _assert_same_tree(np.asarray(f), np.asarray(t), np.asarray(lf),
                      tree.feat.numpy(), tree.thresh.numpy(),
                      tree.leaf.numpy(), inp["binned"].numpy(),
                      inp["w"] > 0, 4)
    split = tree.thresh.numpy() < B
    assert split.sum() >= 5
    assert inp["mask"][tree.feat.numpy()[split]].all()
    if default_dir:
        assert (tree.thresh.numpy() < 0).any()

    def splits(tr):
        return tr.feat.numpy().tolist(), tr.thresh.numpy().tolist()

    ungated = _port_tree(inp, newton_leaf, default_dir, min_instances=1.0)
    no_gain_gate = _port_tree(inp, newton_leaf, default_dir,
                              min_info_gain=0.0)
    assert splits(ungated) != splits(tree)
    assert splits(no_gain_gate) != splits(tree)


def test_newton_mode_is_the_count_free_grower(grower_inputs):
    """Without a count channel (bag mode ``"newton"``) the grower builds
    2K channels and gates on hessian mass only, as the JAX package's
    newton mode does: at K = 1 its levels see 2 channels, with one 3."""
    inp = grower_inputs
    seen = []

    def spy(binned, slot, ch, M, B_):
        seen.append(ch.shape[1])
        return tk.seg_level_hists(binned, slot, ch, M, B_)

    G, H, w = _t(inp["G"][:, :1], inp["H"][:, :1], inp["w"])
    a = tk.grow_tree(inp["binned"], G, H, 3, B, hist_fn=spy)
    b = tk.grow_tree(inp["binned"], G, H, 3, B, C=w, min_instances=0.0,
                     hist_fn=spy)
    assert seen == [2] * 3 + [3] * 3
    assert a.feat.shape == b.feat.shape == (7,)


# ---------------------------------------------------------------------------
# softmax boosting, subsampling
# ---------------------------------------------------------------------------

def _spy_grow(monkeypatch, module, calls, c_arg):
    """Record each ``grow_tree`` call's count channel and feature mask."""
    grow = module.grow_tree

    def spy(*a, **k):
        c = k["C"] if c_arg == "C" else a[3]
        m = k.get("feat_mask")
        calls.append((np.asarray(c), None if m is None else np.asarray(m)))
        return grow(*a, **k)

    monkeypatch.setattr(module, "grow_tree", spy)


XGB_KW = dict(num_round=8, eta=0.3, max_depth=3, min_child_weight=5.0,
              gamma=0.2)


@pytest.mark.parametrize("K,es,subsample,colsample", [
    (3, 0, 1.0, 1.0), (5, 3, 1.0, 1.0), (3, 3, 0.8, 0.5), (5, 0, 0.7, 0.6)])
def test_multiclass_xgb_matches_jax(K, es, subsample, colsample,
                                    monkeypatch):
    """``OpXGBoostClassifier`` on a K-class label: the softmax objective in
    both packages, the same rounds grown and kept, each round's count
    channel (the row weights after the row draw) and feature mask equal
    bitwise, trees equal up to ties over each round's rows, leaves (T,
    2^3, K) and margins and probabilities within 1e-5."""
    X, y = _mc(2000, K, 40 + K, nan_frac=0.0)
    X, y = X.astype(np.float32), y.astype(np.float32)
    kw = dict(XGB_KW, early_stopping_rounds=es, subsample=subsample,
              colsample_bytree=colsample)
    jcalls, tcalls = [], []
    with monkeypatch.context() as mp:
        mp.setenv("TMOG_COST_HISTORY", "0")
        _spy_grow(mp, jtr, jcalls, "positional")
        jm = jtr.OpXGBoostClassifier(**kw).fit_raw(X, y)
    with monkeypatch.context() as mp:
        _spy_grow(mp, ttr, tcalls, "C")
        est = ttr.OpXGBoostClassifier(**kw)
        tm = est.fit_raw(X, y, device="cpu")
    assert tm.mode == jm.mode == "gbdt_multi" and tm.n_classes == K
    assert tm.base_score == 0.0
    assert len(tcalls) == len(jcalls) == est.metadata["rounds_grown"]
    assert est.metadata["hist_levels"] == 3 * len(tcalls)
    for (jc, jmask), (tc, tmask) in zip(jcalls, tcalls):
        np.testing.assert_array_equal(tc, jc)
        if colsample < 1.0:
            np.testing.assert_array_equal(tmask, jmask)
            assert tmask.sum() == int(10 * colsample)
        else:
            assert tmask is None and jmask.all()
    if subsample < 1.0:
        assert not np.array_equal(tcalls[0][0], tcalls[1][0])
    if es:
        assert est.metadata["best_len"] < est.metadata["rounds_grown"]
    jf, jt, jl = (np.asarray(a) for a in (jm.feat, jm.thresh, jm.leaf))
    assert tuple(tm.leaf.shape) == jl.shape == (len(jf), 8, K)
    binned = tk.apply_bins(torch.from_numpy(X), tm.edges).numpy()
    for r in range(len(jf)):
        _assert_same_tree(jf[r], jt[r], jl[r], tm.feat[r].numpy(),
                          tm.thresh[r].numpy(), tm.leaf[r].numpy(), binned,
                          tcalls[r][0] > 0, 3)
    jp = jm.predict_batch(X)
    tp = tm.predict_batch(torch.from_numpy(X))
    np.testing.assert_allclose(tp.raw_prediction.numpy(),
                               np.asarray(jp.raw_prediction), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tp.probability.numpy(),
                               np.asarray(jp.probability), rtol=0, atol=TOL)
    assert tp.probability.shape == (2000, K)
    assert (tp.prediction.numpy() == np.asarray(jp.prediction)).mean() > 0.99


def test_binary_subsampled_xgb_matches_jax(monkeypatch):
    """A subsampled binary XGBoost fit runs the JAX package's per-round
    loop: 2K+1 = 3 channels, the same drawn rows and columns, trees equal
    up to ties over each round's rows (the binary default-direction
    mirror is one), probabilities within 1e-5."""
    X, y = _make(2000, 15, binary=True)
    kw = dict(XGB_KW, subsample=0.8, colsample_bytree=0.5)
    seen, tcalls = [], []
    hist = tk.seg_level_hists

    def spy(binned, slot, ch, M, B_):
        seen.append(ch.shape[1])
        return hist(binned, slot, ch, M, B_)

    monkeypatch.setenv("TMOG_COST_HISTORY", "0")
    jm = jtr.OpXGBoostClassifier(**kw).fit_raw(X, y)
    monkeypatch.setattr(ttr, "grow_tree", _grow_with(spy))
    _spy_grow(monkeypatch, ttr, tcalls, "C")
    tm = ttr.OpXGBoostClassifier(**kw).fit_raw(X, y, device="cpu")
    assert tm.mode == "gbdt_binary" and set(seen) == {3}
    binned = tk.apply_bins(torch.from_numpy(X), tm.edges).numpy()
    jf, jt, jl = (np.asarray(a) for a in (jm.feat, jm.thresh, jm.leaf))
    assert len(tcalls) == 8 and len(jf) == len(tm.feat)   # kept rounds
    for r in range(len(jf)):
        _assert_same_tree(jf[r], jt[r], jl[r], tm.feat[r].numpy(),
                          tm.thresh[r].numpy(), tm.leaf[r].numpy(), binned,
                          tcalls[r][0] > 0, 3)
    np.testing.assert_allclose(
        tm.predict_batch(torch.from_numpy(X)).probability.numpy(),
        np.asarray(jm.predict_batch(X).probability), rtol=0, atol=TOL)


def _grow_with(hist_fn):
    def grow(*a, **k):
        k["hist_fn"] = hist_fn
        return tk.grow_tree(*a, **k)
    return grow


# ---------------------------------------------------------------------------
# count-gated boosting: sequential and through the group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["binary_gates", "regression_weights"])
def test_count_gated_fit_matches_jax(case, monkeypatch):
    """A sequential fit with the count channel: ``OpGBTClassifier`` with
    min_instances_per_node 20 and min_info_gain 0.001, or
    ``OpGBTRegressor`` on fractional row weights (the count is weighted,
    so the JAX package keeps it: ``skip_counts``).  3 channels a level,
    trees equal up to ties, predictions within 1e-5."""
    binary = case == "binary_gates"
    X, y = _make(2500, 16, binary=binary)
    w = None
    if binary:
        kw = dict(max_iter=6, max_depth=4, min_instances_per_node=20,
                  min_info_gain=0.001, step_size=0.3)
        jcls, tcls = jtr.OpGBTClassifier, ttr.OpGBTClassifier
    else:
        kw = dict(max_iter=6, max_depth=4, step_size=0.3,
                  min_child_weight=3.0)
        w = np.random.default_rng(16).uniform(0.5, 1.5, len(y)).astype(
            np.float32)
        jcls, tcls = jtr.OpGBTRegressor, ttr.OpGBTRegressor
    monkeypatch.setenv("TMOG_COST_HISTORY", "0")
    jm = jcls(**kw).fit_raw(X, y, w)
    chans = []
    hist = tk.seg_level_hists

    def spy(binned, slot, ch, M, B_):
        chans.append(ch.shape[1])
        return hist(binned, slot, ch, M, B_)

    monkeypatch.setattr(ttr, "grow_tree", _grow_with(spy))
    tm = tcls(**kw).fit_raw(X, y, w, device="cpu")
    assert chans == [3] * (6 * 4)
    binned = tk.apply_bins(torch.from_numpy(X), tm.edges).numpy()
    jf, jt, jl = (np.asarray(a) for a in (jm.feat, jm.thresh, jm.leaf))
    ties = 0
    for r in range(6):
        ties += _assert_same_tree(jf[r], jt[r], jl[r], tm.feat[r].numpy(),
                                  tm.thresh[r].numpy(), tm.leaf[r].numpy(),
                                  binned, np.ones(len(y), bool), 4)
    assert ties == 0
    jp, tp = jm.predict_batch(X), tm.predict_batch(torch.from_numpy(X))
    key = "probability" if binary else "prediction"
    np.testing.assert_allclose(getattr(tp, key).numpy(),
                               np.asarray(getattr(jp, key)), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("case", ["regression", "binary"])
def test_count_gated_group_matches_jax(case, monkeypatch):
    """``GBTGridGroup`` with count-gated chains (min_instances_per_node 10
    and 40, min_info_gain 0 and 0.01): no decline, 3-channel levels, every
    chain's trees equal up to ties; where no tie routes a held-out row
    differently, CV RMSE within 1e-5 and CV AuPR within 1e-4."""
    binary = case == "binary"
    X, y = _make(2000, 17, binary=binary)
    ctxs = _folds(y)
    pts = [dict(max_depth=d, min_instances_per_node=m, min_info_gain=g)
           for d, m, g in ((3, 10, 0.0), (4, 40, 0.01))]
    if binary:
        protos = (jtr.OpGBTClassifier(max_iter=5, step_size=0.3),
                  ttr.OpGBTClassifier(max_iter=5, step_size=0.3))
        metric = "AuPR"
    else:
        protos = (jtr.OpGBTRegressor(max_iter=5, step_size=0.3),
                  ttr.OpGBTRegressor(max_iter=5, step_size=0.3))
        metric = "RootMeanSquaredError"
    chans = []
    hist = tk.seg_level_hists

    def spy(binned, slot, ch, M, B_):
        chans.append(ch.shape[1])
        return hist(binned, slot, ch, M, B_)

    monkeypatch.setattr(ttr, "grow_tree", _grow_with(spy))
    jm, tm, jtrees, jleaves, _, tg = _run_both(*protos, pts, metric, X, y,
                                               ctxs, monkeypatch)
    assert tm.shape == jm.shape == (2, 3)
    assert set(chans) == {3} and tg.hist_levels == 5 * 3 * (3 + 4)
    ties = _compare_chains(jtrees, jleaves, tg, X, ctxs, [3, 4])
    if ties == 0:
        # held-out scores a float32 ulp apart (leaves summed in another
        # order) reorder near-equal rows, which moves a fold's AuPR by up
        # to ~1e-5 (1.2e-5 measured here); RMSE does not reorder
        np.testing.assert_allclose(tm, jm, rtol=0,
                                   atol=1e-4 if binary else TOL)


def test_skip_counts_rule():
    """The count channel is dropped only for XGBoost-gated chains on
    integer weights (the JAX package's ``skip_counts``)."""
    e = ttr.OpGBTRegressor()
    ones = np.ones((2, 4), np.float32)
    assert ttr.skip_counts([e, e], ones)
    assert not ttr.skip_counts([e, ttr.OpGBTRegressor(
        min_instances_per_node=2)], ones)
    assert not ttr.skip_counts([ttr.OpGBTRegressor(min_info_gain=1e-3)],
                               ones)
    assert not ttr.skip_counts([e], ones * 0.5)


# ---------------------------------------------------------------------------
# gbdt_multi artifacts, and the multiclass selector over XGBoost and
# decision trees
# ---------------------------------------------------------------------------

def _xgb_workflow(port, K=3, n=1500):
    X, y = _mc(n, K, 90 + K)
    est = (ttr.OpXGBoostClassifier if port else jtr.OpXGBoostClassifier)(
        **XGB_KW, early_stopping_rounds=0)
    pred = _pipeline(FeatureBuilder if port else JFB,
                     transmogrify if port else jtransmogrify,
                     SanityChecker if port else JSanityChecker, est)
    data = (_dataset(ColumnarDataset, FeatureColumn, ft, X, y) if port
            else _dataset(JDataset, JColumn, jft, X, y))
    wf = OpWorkflow() if port else JWorkflow()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMOG_COST_HISTORY", "0")
        return wf.set_result_features(pred).set_input_data(data).train(), \
            pred


def test_gbdt_multi_artifacts_cross_both_ways(tmp_path):
    """A softmax XGBoost model saved by either package loads in the other
    and scores within 1e-6 of its own package's probabilities; the port's
    load of its own save scores bitwise equal, and its local scorer's
    rows match the batch (1e-6)."""
    X, y = _mc(40, 3, 99)
    jhold = _dataset(JDataset, JColumn, jft, X, y)
    thold = _dataset(ColumnarDataset, FeatureColumn, ft, X, y)
    jmodel, jpred = _xgb_workflow(False)
    tmodel, tpred = _xgb_workflow(True)
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmodel.save(jpath)
    tmodel.save(tpath)
    want_j = np.asarray(jmodel.score(jhold)[jpred.name].values.probability)
    got = OpWorkflowModel.load(jpath).score(thold)[jpred.name].values
    np.testing.assert_allclose(got.probability.numpy(), want_j, rtol=0,
                               atol=1e-6)
    want_t = tmodel.score(thold)[tpred.name].values
    back = JWorkflowModel.load(tpath).score(jhold)[tpred.name].values
    np.testing.assert_allclose(np.asarray(back.probability),
                               want_t.probability.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(want_t.probability.numpy(), want_j, rtol=0,
                               atol=TOL)
    loaded = OpWorkflowModel.load(tpath)
    again = loaded.score(thold)[tpred.name].values
    assert torch.equal(again.probability, want_t.probability)
    inner = next(s for s in loaded.stages
                 if isinstance(s, ttr.TreeEnsembleModel))
    assert inner.mode == "gbdt_multi" and inner.n_classes == 3
    fn = score_function(loaded)
    for i in range(5):
        row = {f"x{j}": (None if np.isnan(X[i, j]) else float(X[i, j]))
               for j in range(X.shape[1])}
        out = fn(row)[tpred.name]
        np.testing.assert_allclose(
            [out[f"probability_{k}"] for k in range(3)],
            want_t.probability[i].numpy(), rtol=0, atol=1e-6)
        assert out["prediction"] == float(want_t.prediction[i])


def _selector_models(port):
    xgb = ttr.OpXGBoostClassifier if port else jtr.OpXGBoostClassifier
    dt = ttr.OpDecisionTreeClassifier if port \
        else jtr.OpDecisionTreeClassifier
    g = grid if port else jgrid
    return [(xgb(num_round=6, eta=0.3, early_stopping_rounds=0),
             g(max_depth=[2, 3])),
            (dt(), g(max_depth=[3, 4], min_instances_per_node=[10]))]


def test_multiclass_selector_over_xgb_and_trees_matches_jax():
    """``MultiClassificationModelSelector.with_cross_validation`` over a
    softmax XGBoost grid and a decision-tree grid at K = 3: no group takes
    either family, so all 4 x 3 fold fits and the winner's refit are
    sequential (``sequential_fits``); the same winner, every candidate's
    fold F1s within 1e-6, the same holdout F1 (1e-6)."""
    K, n = 3, 1500
    X, y = _mc(n, K, 80)
    Xh, yh = _mc(600, K, 81)
    runs = {}
    for port in (False, True):
        sel = (MultiClassificationModelSelector if port else JMCMS) \
            .with_cross_validation(models_and_parameters=_selector_models(
                port))
        pred = _pipeline(FeatureBuilder if port else JFB,
                         transmogrify if port else jtransmogrify,
                         SanityChecker if port else JSanityChecker, sel)
        data = (_dataset(ColumnarDataset, FeatureColumn, ft, X, y) if port
                else _dataset(JDataset, JColumn, jft, X, y))
        hold = (_dataset(ColumnarDataset, FeatureColumn, ft, Xh, yh) if port
                else _dataset(JDataset, JColumn, jft, Xh, yh))
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TMOG_COST_HISTORY", "0")
            mp.setenv("TMOG_SYNC_SWEEP", "1")
            model = (OpWorkflow() if port else JWorkflow()) \
                .set_result_features(pred).set_input_data(data).train()
        ev = (Evaluators if port else JEvaluators).MultiClassification.f1()
        _, metrics = model.score_and_evaluate(ev, data=hold)
        runs[port] = (sel, metrics)
    j = runs[False][0].metadata["model_selector_summary"]
    t = runs[True][0].metadata["model_selector_summary"]
    assert (t["bestModelType"], t["bestModelParams"]) == (
        j["bestModelType"], j["bestModelParams"])
    assert len(t["validationResults"]) == len(j["validationResults"]) == 4
    for a, b in zip(t["validationResults"], j["validationResults"]):
        assert (a["modelType"], a["params"]) == (b["modelType"], b["params"])
        np.testing.assert_allclose(a["foldValues"], b["foldValues"], rtol=0,
                                   atol=1e-6)
    meta = runs[True][0].metadata
    assert meta["group_errors"] == {} and set(meta["sweep_seconds"]) == {
        "rest"}
    fits = meta["sequential_fits"]
    assert len(fits) == 4 * 3 + 1
    assert {f["model"] for f in fits} == {"OpXGBoostClassifier",
                                          "OpDecisionTreeClassifier"}
    assert meta["hist_levels"] > 0
    assert runs[True][1]["F1"] == pytest.approx(runs[False][1]["F1"],
                                                abs=1e-6)
