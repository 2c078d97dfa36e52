"""RawFeatureFilter, its feature distributions and the streaming histogram
in the port against the JAX package, on the CPU.

The JAX package's ``StreamingHistogram.update`` takes its native C++
backend when it builds, which bins differently (a per-point insert); its
vectorized numpy path is the reference the port holds to, so these tests
run the JAX side with ``transmogrifai_tpu.native.AVAILABLE`` patched to
False.  Tolerances: centroids, counts, nulls, fill rates, text counts, JS
divergences, exclusion reasons and drop lists equal; the float64 moment
sums within 1e-12 relative (another summation order than numpy's).  The
workflow leg trains a Titanic-shaped 3 000-row frame with two planted
bad features in both packages: the same drops, and holdout AuPR within
1e-4 (the Titanic tests' tolerance for the LR winner)."""
import itertools
import os
import sys

import numpy as np
import pytest
import torch

import transmogrifai_tpu.native
import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JEvaluators
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.filters import RawFeatureFilter as JRFF
from transmogrifai_tpu.filters import feature_distribution as jfd
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JChecker
from transmogrifai_tpu.selector.model_selector import \
    BinaryClassificationModelSelector as JBCMS
from transmogrifai_tpu.selector.model_selector import grid as jgrid
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import ColumnarDataset as JDataset
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.utils.streaming_histogram import \
    StreamingHistogram as JHist
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.filters import RawFeatureFilter
from transmogrifai_tpu_torch.filters import feature_distribution as tfd
from transmogrifai_tpu_torch.models.classification import \
    OpLogisticRegression
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, grid)
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                   FeatureColumn)
from transmogrifai_tpu_torch.utils import uid as tuid
from transmogrifai_tpu_torch.utils.streaming_histogram import (
    StreamingHistogram, batched_histograms)
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
from bench_pipeline import make_titanic_like  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_numpy_histograms(monkeypatch):
    tt.set_device("cpu")
    monkeypatch.setattr(transmogrifai_tpu.native, "AVAILABLE", False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _columns():
    """Adversarial columns for the histogram (name -> values)."""
    rng = np.random.default_rng(5)
    return {
        "normal": rng.normal(size=3000),
        "monotone_gaps": np.cumsum(np.arange(1, 400) ** 1.5),
        "geometric": np.geomspace(1e-3, 1e9, 700),
        "equal_gaps": np.arange(0.0, 900.0, 0.5),
        "duplicates": rng.integers(0, 9, 3000).astype(float),
        "heavy_duplicates": np.r_[np.zeros(2500), rng.normal(size=500)],
        "all_null": np.full(200, np.nan),
        "single_value": np.full(300, 7.25),
        "few_values": rng.normal(size=40),
        "cauchy": rng.standard_cauchy(2000),
        "with_inf": np.r_[rng.normal(size=500), [np.inf, -np.inf, np.nan]],
        "float32_normals": rng.normal(size=3000).astype(np.float32),
    }


@pytest.mark.parametrize("max_bins", [2, 7, 100])
@pytest.mark.parametrize("name", sorted(_columns()))
def test_histogram_bitwise(name, max_bins):
    v = _columns()[name]
    j = JHist(max_bins).update(v)
    t = StreamingHistogram(max_bins).update(v)
    np.testing.assert_array_equal(t.centroids, j.centroids)
    np.testing.assert_array_equal(t.counts, j.counts)
    assert t.to_json() == j.to_json()


@pytest.mark.parametrize("max_bins", [2, 7, 100])
def test_batched_histograms_bitwise(max_bins):
    cols = _columns()
    n = max(len(v) for v in cols.values())
    X = np.full((len(cols), n), np.nan)
    for k, v in enumerate(cols.values()):
        X[k, :len(v)] = v
    C, N, L = batched_histograms(torch.from_numpy(X), None, max_bins)
    for k, v in enumerate(cols.values()):
        j = JHist(max_bins).update(v)
        m = int(L[k])
        np.testing.assert_array_equal(C[k, :m].numpy(), j.centroids)
        np.testing.assert_array_equal(N[k, :m].numpy(), j.counts)


def test_histogram_update_merge_and_value_counts():
    rng = np.random.default_rng(8)
    a, b = rng.normal(size=900), rng.normal(2.0, 1.0, size=1100)
    j = JHist(16).update(a).update(b)
    t = StreamingHistogram(16).update(a).update(b)
    assert t.to_json() == j.to_json()
    jm = JHist(12).update(a).merge(JHist(20).update(b))
    tm = StreamingHistogram(12).update(a).merge(StreamingHistogram(20)
                                               .update(b))
    assert tm.to_json() == jm.to_json()
    vals = np.r_[rng.integers(0, 50, 60).astype(float), [np.nan]]
    cnts = rng.integers(1, 9, 61).astype(float)
    assert (StreamingHistogram.from_value_counts(vals, cnts, 10).to_json()
            == JHist.from_value_counts(vals, cnts, 10).to_json())
    for q in (0.0, 0.1, 0.5, 0.99):
        assert tm.quantile(q) == jm.quantile(q)
    assert tm.bounds == jm.bounds
    grid = np.linspace(-3, 5, 20)
    np.testing.assert_array_equal(tm.density(grid), jm.density(grid))
    assert StreamingHistogram.from_json(tm.to_json()).to_json() == tm.to_json()


def test_murmur3_many_bitwise():
    """The text profile's batched hash against the JAX package's."""
    from transmogrifai_tpu.utils.hashing import murmur3_32 as jmurmur
    from transmogrifai_tpu_torch.utils.hashing import murmur3_32_many

    rng = np.random.default_rng(12)
    keys = ["", "a", "ab", "abc", "abcd", "abcde", "h\u00e9llo w\u00f6rld",
            "\u65e5\u672c\u8a9e", "x" * 37]
    keys += ["".join(map(chr, rng.integers(32, 0x2000, rng.integers(0, 30))))
             for _ in range(2000)]
    np.testing.assert_array_equal(
        murmur3_32_many(keys), np.array([jmurmur(k) for k in keys],
                                        np.uint32))
    assert murmur3_32_many([]).shape == (0,)


def _assert_json_equal(t, j, path=""):
    """Equal JSON, the float64 moment sums within 1e-12 relative."""
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _assert_json_equal(t[k], j[k], f"{path}.{k}")
    elif isinstance(j, list):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_json_equal(a, b, f"{path}[{i}]")
    elif isinstance(j, float) and path.endswith(("sum", "sum2")):
        assert t == pytest.approx(j, rel=1e-12, abs=1e-300), path
    else:
        assert t == j or (t != t and j != j), path


def _frame(n, seed, shift=0.0):
    """Every storage kind, as raw values (None = missing)."""
    rng = np.random.default_rng(seed)
    miss = rng.random(n)
    return {
        "label": (ft.RealNN, jft.RealNN,
                  list((rng.random(n) < 0.4).astype(float))),
        "real": (ft.Real, jft.Real, [None if m < 0.1 else float(x) for m, x in
                                     zip(miss, rng.normal(shift, 1, n))]),
        "integral": (ft.Integral, jft.Integral,
                     [None if m > 0.95 else int(x) for m, x in
                      zip(miss, rng.integers(0, 12, n))]),
        "binary": (ft.Binary, jft.Binary,
                   [None if m < 0.02 else bool(x) for m, x in
                    zip(miss, rng.random(n) < 0.3)]),
        "date": (ft.Date, jft.Date, [int(1.6e12 + x) for x in
                                     rng.integers(0, 10 ** 9, n)]),
        "text": (ft.Text, jft.Text, [None if m < 0.3 else f"w{x}" for m, x in
                                     zip(miss, rng.integers(0, 40, n))]),
        "picklist": (ft.PickList, jft.PickList,
                     [["a", "b", "c"][x] for x in rng.integers(0, 3, n)]),
        "textlist": (ft.TextList, jft.TextList,
                     [[f"t{x}", "u"] if x % 3 else [] for x in
                      rng.integers(0, 9, n)]),
        "multipick": (ft.MultiPickList, jft.MultiPickList,
                      [{"x", f"y{x}"} if x else set() for x in
                       rng.integers(0, 4, n)]),
        "datelist": (ft.DateList, jft.DateList,
                     [[int(1e12) + x, 7] if x % 2 else [] for x in
                      rng.integers(0, 100, n)]),
        "geo": (ft.Geolocation, jft.Geolocation,
                [None if m < 0.2 else [float(a), float(a) / 2, 1.0]
                 for m, a in zip(miss, rng.uniform(-80, 80, n))]),
        "realmap": (ft.RealMap, jft.RealMap,
                    [{"k1": float(a), **({"k2": 1.0} if a > 0 else {})}
                     for a in rng.normal(shift, 1, n)]),
        "textmap": (ft.TextMap, jft.TextMap,
                    [{"c": f"v{x}"} if x else {} for x in
                     rng.integers(0, 5, n)]),
        "sparse": (ft.Real, jft.Real, [float(x) if m < 0.0004 else None
                                       for m, x in zip(miss, range(n))]),
        # null exactly where the label is 1: null-label leakage
        "leak": (ft.Real, jft.Real, None),
    }


def _datasets(n, seed, shift=0.0):
    spec = _frame(n, seed, shift)
    lab = np.asarray(spec["label"][2])
    spec["leak"] = (ft.Real, jft.Real,
                    [None if y == 1 else float(i) for i, y in enumerate(lab)])
    t = ColumnarDataset({k: FeatureColumn.from_values(tt_, v)
                         for k, (tt_, _, v) in spec.items()})
    j = JDataset({k: JColumn.from_values(jt, v)
                  for k, (_, jt, v) in spec.items()})
    return t, j


def _features(fb, names):
    out = []
    spec = _frame(4, 0)
    for k in names:
        tt_, jt, _ = spec[k]
        typ = (tt_ if fb is FeatureBuilder else jt).__name__
        b = getattr(fb, typ)(k)
        out.append(b.as_response() if k == "label" else b.as_predictor())
    return out


@pytest.mark.parametrize("name", ["real", "integral", "binary", "date",
                                  "text", "picklist", "textlist",
                                  "multipick", "datelist", "geo", "realmap",
                                  "textmap", "sparse", "leak"])
def test_profiles_equal(name):
    tdata, jdata = _datasets(1500, 2)
    label = np.asarray(jdata["label"].values, np.float64)
    jd = jfd.profile_column(name, jdata[name], label)
    td = tfd.profile_column(name, tdata[name], label)
    assert [d.key for d in td] == [d.key for d in jd]
    for a, b in zip(td, jd):
        _assert_json_equal(a.to_json(), b.to_json())
        assert (a.lab_sum, a.lab_sum2, a.null_lab_sum) == (
            b.lab_sum, b.lab_sum2, b.null_lab_sum)
        assert a.null_label_corr() == b.null_label_corr()
    if tdata[name].ftype.storage in tfd.NUMERIC_STORAGE:
        (bd,) = tfd.profile_numeric_batch([name], [tdata[name]], label,
                                          torch.device("cpu"))
        _assert_json_equal(bd.to_json(), jd[0].to_json())
        assert bd.null_lab_sum == pytest.approx(jd[0].null_lab_sum,
                                                rel=1e-12)


def test_monoid_and_js():
    tdata, jdata = _datasets(1200, 3)
    sdata, sjdata = _datasets(900, 4, shift=2.5)
    for name in ("real", "text", "realmap", "geo"):
        td = tfd.profile_column(name, tdata[name])
        ts = tfd.profile_column(name, sdata[name])
        jd = jfd.profile_column(name, jdata[name])
        js = jfd.profile_column(name, sjdata[name])
        for a, b, c, e in zip(td, ts, jd, js):
            assert a.js_divergence(b) == c.js_divergence(e)
            assert a.relative_fill_ratio(b) == c.relative_fill_ratio(e)
            _assert_json_equal((a + b).to_json(), (c + e).to_json())


ALL = ["label", "real", "integral", "binary", "date", "text", "picklist",
       "textlist", "multipick", "datelist", "geo", "realmap", "textmap",
       "sparse", "leak"]


@pytest.mark.parametrize("scored", [False, True])
def test_filter_raw_data_equal(scored):
    tdata, jdata = _datasets(2000, 6)
    kw = dict(min_fill_rate=0.01, max_js_divergence=0.5)
    if scored:
        sdata, sjdata = _datasets(800, 7, shift=3.0)
        jr = JRFF(scoring_data=sjdata, **kw)
        tr = RawFeatureFilter(scoring_data=sdata, **kw)
    else:
        jr, tr = JRFF(**kw), RawFeatureFilter(**kw)
    jclean, jres = jr.filter_raw_data(jdata, _features(JFB, ALL))
    tclean, tres = tr.filter_raw_data(tdata, _features(FeatureBuilder, ALL))
    _assert_json_equal(tres.to_json(), jres.to_json())
    assert tres.dropped_features == jres.dropped_features
    assert "leak" in tres.dropped_features
    assert "sparse" in tres.dropped_features
    if scored:
        assert "real" in tres.dropped_features  # shifted by 3 sd
        assert tres.profile_seconds.keys() == {"numeric", "text"}
    assert tclean.names() == jclean.names()
    assert list(tclean["realmap"].values) == list(jclean["realmap"].values)


def test_dropped_map_keys_and_protection():
    tdata, jdata = _datasets(1500, 9)
    kw = dict(min_fill_rate=0.6, protected_features=["text"])
    jclean, jres = JRFF(**kw).filter_raw_data(jdata, _features(JFB, ALL))
    tclean, tres = RawFeatureFilter(**kw).filter_raw_data(
        tdata, _features(FeatureBuilder, ALL))
    assert tres.dropped_map_keys == jres.dropped_map_keys
    assert tres.dropped_map_keys == {"realmap": ["k2"]}
    assert "text" not in tres.dropped_features
    assert list(tclean["realmap"].values) == list(jclean["realmap"].values)
    assert [r.to_json() for r in tres.exclusion_reasons] == [
        r.to_json() for r in jres.exclusion_reasons]


def test_invalid_thresholds_and_unported():
    for bad in (dict(min_fill_rate=1.5), dict(max_fill_difference=-0.1),
                dict(max_fill_ratio_diff=-1.0), dict(max_js_divergence=2.0)):
        with pytest.raises(ValueError):
            JRFF(**bad)
        with pytest.raises(ValueError):
            RawFeatureFilter(**bad)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RawFeatureFilter().with_mesh(None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RawFeatureFilter().filter_streaming(None, [], 10)


def _titanic(rows, seed):
    df = make_titanic_like(rows, seed=seed)
    logit = (-1.1 + 2.4 * (df["Sex"] == "female").to_numpy()
             - 1.0 * (df["Pclass"] == "3").to_numpy()
             + 0.35 * np.log1p(df["Fare"].to_numpy())
             - 0.015 * np.nan_to_num(df["Age"].to_numpy(), nan=30))
    u = np.random.default_rng(11).random(rows)
    df["Survived"] = (1 / (1 + np.exp(-logit)) > u).astype(float)
    rng = np.random.default_rng(seed + 1)
    df["leak"] = np.where(df["Survived"] == 1, np.nan, rng.normal(size=rows))
    df["rare"] = np.where(rng.random(rows) < 0.0005, 1.0, np.nan)
    return df


def _workflow(pkg, train, hold):
    fb, tm, checker, sel, g, lr, wf = pkg
    survived = fb.RealNN("Survived").as_response()
    preds = [fb.PickList("Pclass").as_predictor(),
             fb.PickList("Sex").as_predictor(),
             fb.Real("Age").as_predictor(), fb.Real("Fare").as_predictor(),
             fb.Integral("SibSp").as_predictor(),
             fb.PickList("Embarked").as_predictor(),
             fb.Real("leak").as_predictor(), fb.Real("rare").as_predictor()]
    checked = checker().set_input(survived, tm(preds)).get_output()
    selector = sel.with_cross_validation(
        num_folds=3, models_and_parameters=[
            (lr(), g(reg_param=[0.01, 0.1], elastic_net_param=[0.0]))])
    pred = selector.set_input(survived, checked).get_output()
    return (wf().set_result_features(pred).set_input_data(train)
            .with_raw_feature_filter(scoring_data=hold))


def test_workflow_with_filter():
    train, hold = _titanic(3000, 7), _titanic(1000, 8)
    hold["Fare"] = hold["Fare"] * 1.5
    out = []
    for pkg, ev, uid in (
            ((JFB, jtransmogrify, JChecker, JBCMS, jgrid, JLR, JWorkflow),
             JEvaluators, juid),
            ((FeatureBuilder, transmogrify, SanityChecker,
              BinaryClassificationModelSelector, grid, OpLogisticRegression,
              OpWorkflow), Evaluators, tuid)):
        uid._counter = itertools.count(1)
        model = _workflow(pkg, train, hold).train()
        _, metrics = model.score_and_evaluate(
            ev.BinaryClassification.auPR(), data=hold)
        out.append((model, metrics))
    (jm, jmet), (tm, tmet) = out
    rff = tm.raw_feature_filter_results
    assert rff.dropped_features == jm.raw_feature_filter_results \
        .dropped_features == ["leak", "rare"]
    assert tm.blocklisted == ["leak", "rare"]
    _assert_json_equal(rff.to_json(), jm.raw_feature_filter_results.to_json())
    fare = next(r for r in rff.exclusion_reasons if r.name == "Fare")
    assert not fare.excluded
    for s in tm.stages:
        assert not {"leak", "rare"} & set(s.input_names)
    assert tmet["AuPR"] == pytest.approx(jmet["AuPR"], abs=1e-4)
    assert tm.lint_snapshot.rule_counts == jm.lint_snapshot.rule_counts
