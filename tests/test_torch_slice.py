"""The port's boosted-tree slice against the JAX package, end to end on the CPU.

FeatureBuilder -> transmogrify -> SanityChecker -> OpXGBoostClassifier ->
OpWorkflow.train -> score_and_evaluate(AuPR), on the same numpy-seeded data
in both packages.  Structural outputs (vector column names, SanityChecker
drops, early-stopping length, tree feat/thresh) must match exactly, a
mirrored tie between two forms of one split put in one form first;
probabilities agree within atol 1e-5 (float32 sums in another order and
another exp) and AuPR within 1e-6.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JEvaluators
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models.trees import OpXGBoostClassifier as JXGB
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JSanityChecker
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import ColumnarDataset as JDataset
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import ColumnarDataset, FeatureColumn
from transmogrifai_tpu_torch.workflow.dag import compute_dag
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

N_REAL = 12
XGB_KW = dict(max_depth=4, num_round=10, early_stopping_rounds=3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make(n, seed):
    """12 Real columns (some NaN), one PickList, a binary label with signal
    on a few reals and the category; column 7 leaks the label."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, N_REAL))
    X[rng.random((n, N_REAL)) < 0.08] = np.nan
    X[:, 9] = np.where(rng.random(n) < 0.5, np.nan, X[:, 9])
    cat = rng.choice(np.array(["red", "green", "blue", "teal", None],
                              dtype=object), size=n,
                     p=[0.4, 0.3, 0.15, 0.1, 0.05])
    z = (1.2 * np.nan_to_num(X[:, 0]) - 0.8 * np.nan_to_num(X[:, 3])
         + 0.6 * (cat == "red") + 0.5 * rng.normal(size=n))
    y = (z > 0.2).astype(np.float64)
    X[:, 7] = y + 0.01 * rng.normal(size=n)
    return X, list(cat), y


def _dataset(cls_ds, cls_col, types, X, cat, y):
    cols = {f"x{j}": cls_col.from_values(types.Real, X[:, j])
            for j in range(N_REAL)}
    cols["color"] = cls_col.from_values(types.PickList, cat)
    cols["label"] = cls_col.from_values(types.RealNN, y)
    return cls_ds(cols)


def _pipeline(fb, transmogrify_fn, checker_cls, xgb_cls):
    label = fb.RealNN("label").as_response()
    preds = ([fb.Real(f"x{j}").as_predictor() for j in range(N_REAL)]
             + [fb.PickList("color").as_predictor()])
    vec = transmogrify_fn(preds)
    checker = checker_cls(max_correlation=0.99)
    checked = label.transform_with(checker, vec)
    est = xgb_cls(**XGB_KW)
    pred = label.transform_with(est, checked)
    return pred, checker, est


@pytest.fixture(scope="module")
def data():
    return _make(3000, 21), _make(1000, 22)


@pytest.fixture(scope="module")
def jax_run(data):
    train, hold = data
    pred, checker, est = _pipeline(JFB, jtransmogrify, JSanityChecker, JXGB)
    with pytest.MonkeyPatch.context() as mp:
        # keep the JAX train from appending to benchmarks/cost_history.json
        mp.setenv("TMOG_COST_HISTORY", "0")
        model = JWorkflow().set_result_features(pred).set_input_data(
            _dataset(JDataset, JColumn, jft, *train)).train()
    scored, metrics = model.score_and_evaluate(
        JEvaluators.BinaryClassification.auPR(),
        data=_dataset(JDataset, JColumn, jft, *hold))
    return dict(model=model, pred=pred, checker=checker, est=est,
                scored=scored, metrics=metrics)


@pytest.fixture(scope="module")
def torch_run(data):
    tt.set_device("cpu")
    train, hold = data
    pred, checker, est = _pipeline(FeatureBuilder, transmogrify,
                                   SanityChecker, OpXGBoostClassifier)
    model = OpWorkflow().set_result_features(pred).set_input_data(
        _dataset(ColumnarDataset, FeatureColumn, ft, *train)).train()
    scored, metrics = model.score_and_evaluate(
        Evaluators.BinaryClassification.auPR(),
        data=_dataset(ColumnarDataset, FeatureColumn, ft, *hold))
    return dict(model=model, pred=pred, checker=checker, est=est,
                scored=scored, metrics=metrics)


def _stage(model, name):
    return next(s for s in model.stages if type(s).__name__ == name)


def _mirror_canonical(feat, thresh, leaf, binned, depth):
    """One tree (heap arrays) with every mirrored default-direction split
    rewritten as its plain twin: a split ``thresh = -(t+1)`` whose rows
    hold no bin above t sends bin 0 right and the rest left — the split
    ``thresh = 0`` with its two subtrees swapped.  Returns the rewritten
    arrays and the heap indices of the rewritten splits."""
    feat, thresh, leaf = feat.copy(), thresh.copy(), leaf.copy()
    rewritten = []
    node = np.zeros(binned.shape[0], np.int64)
    for level in range(depth):
        for i in range(2 ** level):
            h = 2 ** level - 1 + i
            rows = node == i
            if thresh[h] >= 0 or not rows.any():
                continue
            if (binned[rows, feat[h]] > -thresh[h] - 1).any():
                continue
            thresh[h] = 0
            rewritten.append(h)
            for k in range(1, depth - level + 1):   # swap the subtrees
                w = 2 ** (k - 1)
                lo = 2 ** k * i
                arrs = ([leaf] if level + k == depth
                        else [feat[2 ** (level + k) - 1:],
                              thresh[2 ** (level + k) - 1:]])
                for a in arrs:
                    a[lo:lo + w], a[lo + w:lo + 2 * w] = (
                        a[lo + w:lo + 2 * w].copy(), a[lo:lo + w].copy())
        h = 2 ** level - 1 + node
        x = binned[np.arange(len(node)), feat[h]].astype(np.int64)
        t = thresh[h]
        te = np.where(t < 0, -t - 1, t)
        node = 2 * node + ((x > te) | ((t < 0) & (x == 0)))
    return feat, thresh, leaf, rewritten


def _route(feat, thresh, binned, levels):
    """Node index of every row after ``levels`` levels of one tree."""
    node = np.zeros(binned.shape[0], np.int64)
    for lv in range(levels):
        hh = 2 ** lv - 1 + node
        x = binned[np.arange(len(node)), feat[hh]].astype(np.int64)
        t = thresh[hh]
        te = np.where(t < 0, -t - 1, t)
        node = 2 * node + ((x > te) | ((t < 0) & (x == 0)))
    return node


def _under(k, h):
    """Whether heap node ``k`` lies in the subtree rooted at ``h``."""
    while k > h:
        k = (k - 1) // 2
    return k == h


def _node_rows(feat, thresh, binned, h):
    """Rows that reach heap node ``h`` of one tree."""
    level = int(np.log2(h + 1))
    return _route(feat, thresh, binned, level) == h - (2 ** level - 1)


def _split_gains(x, G, H, lam, mcw, B, dd_mask):
    """float64 gain of every split the growth may pick at one node (plain
    thresholds, then default-direction ones), -inf where gated out; ``x``
    (rows, d) bins of the node's rows."""
    d = x.shape[1]
    hist = np.zeros((2, B, d))
    for c, v in enumerate((G, H)):
        np.add.at(hist[c], (x.astype(np.int64), np.arange(d)[None, :]),
                  v[:, None])
    GL, HL = np.cumsum(hist, axis=1)
    Gt, Ht = GL[-1:], HL[-1:]

    def gain(gl, hl):
        gr, hr = Gt - gl, Ht - hl
        g = gl * gl / (hl + lam) + gr * gr / (hr + lam) - Gt * Gt / (Ht + lam)
        ok = (hl >= mcw) & (hr >= mcw) & (np.arange(B)[:, None] < B - 1)
        return np.where(ok, g, -np.inf)

    plain = gain(GL, HL)
    mirrored = gain(GL - GL[0:1], HL - HL[0:1])
    mirrored[:, ~((hist[1, 0] > 0) & dd_mask)] = -np.inf
    return plain, mirrored


def _gain_of(x_col, G, H, t, lam):
    """float64 gain of the split ``t`` on one feature's bins ``x_col``."""
    te = -t - 1 if t < 0 else t
    right = (x_col > te) | ((t < 0) & (x_col == 0))
    gl, hl, gr, hr = G[~right].sum(), H[~right].sum(), G[right].sum(), \
        H[right].sum()
    return (gl * gl / (hl + lam) + gr * gr / (hr + lam)
            - (gl + gr) ** 2 / (hl + hr + lam))


def _combiner_names(model):
    meta = _stage(model, "VectorsCombiner").metadata["vector_metadata"]
    return [(c["parent_feature"], c["grouping"], c["indicator_value"])
            for c in meta["columns"]]


class TestSliceParity:
    def test_vector_metadata_columns(self, jax_run, torch_run):
        assert _combiner_names(torch_run["model"]) == \
            _combiner_names(jax_run["model"])

    def test_sanity_checker_drops(self, jax_run, torch_run):
        j = _stage(jax_run["model"], "SanityCheckerModel")
        t = _stage(torch_run["model"], "SanityCheckerModel")
        assert t.keep_indices == j.keep_indices
        dropped = jax_run["checker"].metadata["summary"]["dropped"]
        assert torch_run["checker"].metadata["summary"]["dropped"] == dropped
        assert any("x7" in c for c in dropped)   # the leaking column goes
        assert t.new_vmeta.column_names() == j._new_vmeta.column_names()

    def test_trees_and_early_stopping(self, data, jax_run, torch_run):
        """Identical splits once mirrored ties are put in one form: on a
        binary default-direction feature, ``bin 0 left`` (thresh 0) and
        ``bin 0 right`` (thresh -(t+1) with no rows above t) are one
        partition with the children swapped, equal in gain in exact
        arithmetic; float32 sums taken in another order break that tie
        either way.  Where the raw trees differ, the first difference must
        be such a mirror, both packages' splits there must reach the node's
        best float64 gain (rtol 1e-5: a genuine tie), and mirrors stay
        rare."""
        j = _stage(jax_run["model"], "TreeEnsembleModel")
        t = _stage(torch_run["model"], "TreeEnsembleModel")
        assert t.feat.shape[0] == np.asarray(j.feat).shape[0]
        assert torch_run["est"].metadata["best_len"] == t.feat.shape[0]
        np.testing.assert_array_equal(t.edges, np.asarray(j.edges))
        assert t.base_score == pytest.approx(j.base_score, abs=0)
        est = torch_run["est"]
        X = torch_run["model"].train_data[est.input_features[1].name].values
        binned = tk.apply_bins(X, t.edges).numpy()
        depth = XGB_KW["max_depth"]
        # the fit's gradients, replayed in float64: rows outside the
        # numpy-seeded early-stopping validation split, margins of the
        # port's own earlier trees
        y = data[0][2]
        n = len(y)
        W = (np.random.default_rng(est.seed).random(n)
             >= est.validation_fraction).astype(np.float64)
        dd = tk.default_dir_mask(t.edges)
        F = np.full(n, t.base_score)
        mirrored_nodes = 0
        for i in range(t.feat.shape[0]):
            raw_t = (t.feat[i].numpy(), t.thresh[i].numpy())
            raw_j = (np.asarray(j.feat[i]), np.asarray(j.thresh[i]))
            tf, tt_, tl, t_rw = _mirror_canonical(
                *raw_t, t.leaf[i].numpy(), binned, depth)
            jf, jt, jl, j_rw = _mirror_canonical(
                *raw_j, np.asarray(j.leaf[i]), binned, depth)
            np.testing.assert_array_equal(tf, jf)
            np.testing.assert_array_equal(tt_, jt)
            np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-7)
            diff = np.flatnonzero((raw_t[0] != raw_j[0])
                                  | (raw_t[1] != raw_j[1]))
            if diff.size:
                h = int(diff[0])   # heap order: the topmost difference
                assert h in t_rw or h in j_rw, (i, h)
                # ... and every other difference lies in its subtree
                assert all(_under(int(k), h) for k in diff), (i, diff)
                mirrored_nodes += 1
                P = 1 / (1 + np.exp(-F))
                G, H = W * (P - y), W * np.maximum(P * (1 - P), 1e-6)
                rows = _node_rows(*raw_t, binned, h)
                plain, mirr = _split_gains(
                    binned[rows], G[rows], H[rows], est.reg_lambda,
                    est.min_child_weight, est.max_bins, dd)
                best = max(plain.max(), mirr.max())
                for f_, t_ in ((raw_t[0][h], raw_t[1][h]),
                               (raw_j[0][h], raw_j[1][h])):
                    g = _gain_of(binned[rows, f_].astype(np.int64),
                                 G[rows], H[rows], int(t_), est.reg_lambda)
                    assert g == pytest.approx(best, rel=1e-5), (i, h, g, best)
            F = F + t.leaf[i].numpy()[
                _route(*raw_t, binned, depth), 0].astype(np.float64)
        splits = int((t.thresh.numpy() < est.max_bins).sum())
        assert mirrored_nodes <= 0.05 * splits, (mirrored_nodes, splits)

    def test_holdout_scores_and_aupr(self, jax_run, torch_run):
        jp = jax_run["scored"][jax_run["pred"].name].values.probability
        tp = torch_run["scored"][torch_run["pred"].name].values.probability
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-5)
        assert abs(torch_run["metrics"]["AuPR"]
                   - jax_run["metrics"]["AuPR"]) <= 1e-6
        assert torch_run["metrics"]["AuPR"] > 0.7


@pytest.mark.parametrize("levels", [7, 1000])
def test_aupr_matches_jax(levels):
    """The port's device AuPR (tied scores grouped in place) against the
    JAX package's host AuPR, within 1e-12."""
    from transmogrifai_tpu.evaluators.metrics import aupr as jaupr
    from transmogrifai_tpu_torch.evaluators.metrics import aupr

    rng = np.random.default_rng(levels)
    y = (rng.random(3000) < 0.3).astype(np.float32)
    s = (np.floor(rng.random(3000) * levels) / levels + 0.2 * y
         ).astype(np.float32)
    assert abs(aupr(torch.from_numpy(y), torch.from_numpy(s))
               - jaupr(y, s)) <= 1e-12


def test_convert_round_trip(data, jax_run):
    """JAX-fitted stages carried into the port score the holdout to JAX's
    scores (atol 1e-6: same trees and bins, float32 exp in torch)."""
    tt.set_device("cpu")
    _, hold = data
    jm = jax_run["model"]
    pred, _, est = _pipeline(FeatureBuilder, transmogrify, SanityChecker,
                             OpXGBoostClassifier)
    ests = {type(s).__name__: s for s in compute_dag([pred]).all_stages()}
    jr = _stage(jm, "RealVectorizerModel")
    jo = _stage(jm, "OneHotVectorizerModel")
    js = _stage(jm, "SanityCheckerModel")
    je = _stage(jm, "TreeEnsembleModel")
    fitted = [
        convert.real_vectorizer(ests["RealVectorizer"], list(jr.fills),
                                jr.track_nulls),
        convert.one_hot_vectorizer(ests["OneHotVectorizer"],
                                   [list(v) for v in jo.vocabs]),
        convert.sanity_checker(ests["SanityChecker"], list(js.keep_indices)),
        convert.tree_ensemble(est, je.mode, np.asarray(je.edges),
                              np.asarray(je.feat), np.asarray(je.thresh),
                              np.asarray(je.leaf), je.base_score),
    ]
    model = convert.workflow_model([pred], fitted)
    scored = model.score(_dataset(ColumnarDataset, FeatureColumn, ft, *hold))
    got = scored[pred.name].values.probability.numpy()
    want = np.asarray(jax_run["scored"][jax_run["pred"].name]
                      .values.probability)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


_ISOLATED = r"""
import sys
for k in [k for k in sys.modules if k == "jax" or k.startswith("jax.")]:
    del sys.modules[k]
sys.modules["jax"] = None
sys.modules["transmogrifai_tpu"] = None
import numpy as np, torch
from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow
rng = np.random.default_rng(0)
X = rng.normal(size=(400, 6)).astype(np.float32)
y = (X[:, 0] > 0).astype(np.float32)
m = OpXGBoostClassifier(max_depth=3, num_round=4,
                        early_stopping_rounds=0).fit_raw(X, y, device="cpu")
assert m.feat.shape == (4, 7), m.feat.shape
assert not any(k == "jax" or k.startswith(("jax.", "transmogrifai_tpu."))
               for k, v in sys.modules.items() if v is not None)
if not torch.cuda.is_available():
    for call in (lambda: OpXGBoostClassifier(num_round=2).fit_raw(X, y),
                 lambda: OpWorkflow().train()):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("entry point ran without a card")
print("OK")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _ISOLATED], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")
