"""The streaming-fit protocol (``begin_fit``/``update_chunk``/
``merge_states``/``finish_fit``, ``fit_streaming``) of every streamable
estimator of the port against the JAX package's streaming fit and the
port's in-core fit, on the same numpy-seeded chunks, on the CPU; and the
drift baselines of both paths.

Tolerances, and why:
 * vocabularies (ties in count included), modes, text strategies and keep
   lists are equal everywhere;
 * ``metadata["drift_baseline"]`` and ``drift_baseline_vector`` are equal
   bit for bit to the JAX package's on the same path (the in-core
   baselines of the vectorizers, and every streaming one): the same host
   numpy arithmetic, the port's in-core histograms built by
   ``batched_histograms`` bin for bin as the numpy histogram (the JAX
   side's native histogram patched off, as ``tests/test_torch_raw_
   feature_filter.py`` does);
 * streaming against in-core: the reals' fills and the checker's moments
   within 1e-12 relative (Welford merges against numpy's pairwise sums),
   its correlations within 1e-9 absolute;
 * naive Bayes: log likelihoods within 1e-5 of the JAX package's and of
   the in-core fit (float32 products summed in another order, on
   indicator and small integer columns);
 * ``streaming_bin_edges`` and ``quantile_bins_streaming``: bit-equal;
 * the real vectorizer model's vector, filled in blocks of columns: equal
   bit for bit to the JAX package's.
"""
import numpy as np
import pytest
import torch

import transmogrifai_tpu.native
import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models import gbdt_kernels as jg
from transmogrifai_tpu.models.classification import OpNaiveBayes as JNB
from transmogrifai_tpu.models.trees import OpGBTClassifier as JGBT
from transmogrifai_tpu.ops import vectorizers as jv
from transmogrifai_tpu.ops.vector_metadata import \
    VectorColumnMetadata as JVCM
from transmogrifai_tpu.ops.vector_metadata import VectorMetadata as JVM
from transmogrifai_tpu.preparators import sanity_checker as jsc
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import ColumnarDataset as JDataset
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.utils.streaming_histogram import \
    StreamingHistogram as JHist
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.models import gbdt_kernels as tg
from transmogrifai_tpu_torch.models.classification import OpNaiveBayes
from transmogrifai_tpu_torch.models.trees import OpGBTClassifier
from transmogrifai_tpu_torch.ops import vectorizers as tv
from transmogrifai_tpu_torch.ops.vector_metadata import (VectorColumnMetadata,
                                                         VectorMetadata)
from transmogrifai_tpu_torch.preparators import sanity_checker as tsc
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                   FeatureColumn)
from transmogrifai_tpu_torch.utils.streaming_histogram import \
    StreamingHistogram

N = 700
CHUNKS = (61, 7, 300)
JAX = dict(fb=JFB, ft=jft, col=JColumn, ds=JDataset, vcm=JVCM, vm=JVM)
PORT = dict(fb=FeatureBuilder, ft=ft, col=FeatureColumn, ds=ColumnarDataset,
            vcm=VectorColumnMetadata, vm=VectorMetadata)


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


def _raw(seed=0, n=N):
    """Raw columns with nulls, tied counts and a mostly constant real."""
    rng = np.random.default_rng(seed)
    cats = np.array(["a", "b", "c", "d", "e"], dtype=object)
    return {
        "r1": np.where(rng.random(n) < 0.2, np.nan, rng.normal(5, 3, n)),
        "r2": np.where(rng.random(n) < 0.5, np.nan,
                       rng.lognormal(2, 1, n)),
        "i1": np.where(rng.random(n) < 0.1, np.nan,
                       rng.integers(0, 4, n).astype(float)),
        # "a" and "b" tie in count; "c" first appears before "b"
        "p1": [None if i % 10 == 9 else ["c", "a", "b"][i % 3]
               for i in range(n)],
        "p2": [None if rng.random() < 0.2 else cats[rng.integers(0, 5)]
               for _ in range(n)],
        "m1": [set(rng.choice(cats, rng.integers(0, 3), replace=False))
               for _ in range(n)],
        "t1": [None if rng.random() < 0.1 else f"w{rng.integers(0, 8)}"
               for _ in range(n)],
        "t2": [None if rng.random() < 0.1 else f"long text {i}"
               for i in range(n)],
    }


SPECS = {"r1": "Real", "r2": "Real", "i1": "Integral", "p1": "PickList",
         "p2": "PickList", "m1": "MultiPickList", "t1": "Text",
         "t2": "Text"}


def _dataset(pkg, raw, names):
    return pkg["ds"]({n: pkg["col"].from_values(getattr(pkg["ft"],
                                                         SPECS[n]), raw[n])
                      for n in names})


def _chunks(ds, sizes=CHUNKS):
    out, a, i = [], 0, 0
    while a < len(ds):
        b = min(a + sizes[i % len(sizes)], len(ds))
        out.append(ds.slice(a, b))
        a, i = b, i + 1
    return out


def _wire(pkg, stage, names):
    stage.set_input(*[getattr(pkg["fb"], SPECS[n])(n).as_predictor()
                      for n in names])
    return stage


def _fits(make_port, make_jax, names, raw=None):
    """(port in-core, port streaming, JAX in-core, JAX streaming) models,
    each with its estimator's metadata."""
    raw = raw if raw is not None else _raw()
    out = []
    for pkg, make in ((PORT, make_port), (JAX, make_jax)):
        ds = _dataset(pkg, raw, names)
        est = _wire(pkg, make(), names)
        inc = est.adopt_model(est.fit_columns(ds, *[ds[n] for n in names]))
        inc_meta = dict(est.metadata)
        est2 = _wire(pkg, make(), names)
        st = est2.fit_streaming(_chunks(ds))
        out += [(inc, inc_meta), (st, dict(est2.metadata))]
    return out


def _same_tree(a, b):
    """Nested dicts / lists / arrays bit-equal."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same_tree(u, v)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


def test_real_vectorizer():
    names = ["r1", "r2"]
    (pi, pim), (ps, psm), (ji, jim), (js, jsm) = _fits(
        tv.RealVectorizer, jv.RealVectorizer, names)
    assert ps.fills == js.fills and pi.fills == ji.fills
    np.testing.assert_allclose(ps.fills, pi.fills, rtol=1e-12)
    _same_tree(pim["drift_baseline"], jim["drift_baseline"])
    _same_tree(psm["drift_baseline"], jsm["drift_baseline"])
    base = psm["drift_baseline"]["r1"]
    assert base["kind"] == "numeric" and base["n"] == pim[
        "drift_baseline"]["r1"]["n"]
    assert len(base["histCentroids"]) <= tv._BASELINE_BINS


@pytest.mark.parametrize("block_elems", [1 << 24, 2 * N])
@pytest.mark.parametrize("track_nulls", [True, False])
def test_real_vectorizer_transform_blocks(monkeypatch, block_elems,
                                          track_nulls):
    """The model fills its columns in blocks (one block for a single row,
    several for a tall matrix, a ragged last one): the vector equals the
    JAX package's bitwise, infinities and NaN included."""
    monkeypatch.setattr(tv.RealVectorizerModel, "_BLOCK_ELEMS", block_elems)
    raw = _raw()
    raw["r2"] = np.where(np.arange(N) % 17 == 3, np.inf, raw["r2"])
    raw["r2"] = np.where(np.arange(N) % 19 == 4, -np.inf, raw["r2"])
    names = ["r1", "r2", "i1"]
    outs = []
    for pkg, mod in ((PORT, tv), (JAX, jv)):
        ds = _dataset(pkg, raw, names)
        est = _wire(pkg, mod.RealVectorizer(track_nulls=track_nulls), names)
        model = est.adopt_model(est.fit_columns(ds, *[ds[n] for n in names]))
        outs.append(np.asarray(model.transform_columns(
            *[ds[n] for n in names]).values))
        for lo, hi in ((0, 1), (5, 6)):   # single rows, as requests send
            part = ds.slice(lo, hi)
            outs.append(np.asarray(model.transform_columns(
                *[part[n] for n in names]).values))
    half = len(outs) // 2
    for p, j in zip(outs[:half], outs[half:]):
        assert p.dtype == j.dtype == np.float32
        np.testing.assert_array_equal(p, j)
    assert outs[0].shape == (N, 3 * (2 if track_nulls else 1))


def test_real_vectorizer_in_core_sample_strides(monkeypatch):
    """Past ``_BASELINE_SAMPLE`` present values the in-core histogram
    takes every k-th value, as the JAX package does."""
    monkeypatch.setattr(tv, "_BASELINE_SAMPLE", 50)
    monkeypatch.setattr(jv, "_BASELINE_SAMPLE", 50)
    (pi, pim), _, (ji, jim), _ = _fits(tv.RealVectorizer, jv.RealVectorizer,
                                       ["r1", "r2"])
    _same_tree(pim["drift_baseline"], jim["drift_baseline"])
    present = _raw()["r1"][~np.isnan(_raw()["r1"])]
    h = StreamingHistogram(32).update(present[::len(present) // 50])
    np.testing.assert_array_equal(
        pim["drift_baseline"]["r1"]["histCounts"], h.counts)


def test_integral_vectorizer():
    (pi, pim), (ps, psm), (ji, jim), (js, jsm) = _fits(
        tv.IntegralVectorizer, jv.IntegralVectorizer, ["i1"])
    assert pi.fills == ps.fills == ji.fills == js.fills
    _same_tree(pim["drift_baseline"], jim["drift_baseline"])
    _same_tree(psm["drift_baseline"], jsm["drift_baseline"])


def test_integral_mode_ties_to_the_smallest():
    raw = {"i1": np.array([3.0, 3.0, 1.0, 1.0, 2.0, np.nan] * 5)}
    (pi, _), (ps, _), (ji, _), (js, _) = _fits(
        tv.IntegralVectorizer, jv.IntegralVectorizer, ["i1"], raw)
    assert pi.fills == ps.fills == ji.fills == js.fills == [1.0]


@pytest.mark.parametrize("names,make_p,make_j", [
    (["p1", "p2"], lambda: tv.OneHotVectorizer(top_k=3, min_support=2),
     lambda: jv.OneHotVectorizer(top_k=3, min_support=2)),
    (["m1"], lambda: tv.MultiPickListVectorizer(top_k=3, min_support=2),
     lambda: jv.MultiPickListVectorizer(top_k=3, min_support=2)),
])
def test_pivot_vectorizers(names, make_p, make_j):
    (pi, pim), (ps, psm), (ji, jim), (js, jsm) = _fits(make_p, make_j,
                                                       names)
    assert pi.vocabs == ps.vocabs == ji.vocabs == js.vocabs
    if names == ["p1", "p2"]:
        # the tie of "a" and "b" goes to the first seen
        assert pi.vocabs[0] == ["c", "a", "b"]
    _same_tree(pim["drift_baseline"], jim["drift_baseline"])
    _same_tree(psm["drift_baseline"], jsm["drift_baseline"])
    _same_tree(psm["drift_baseline"], pim["drift_baseline"])


def test_smart_text_vectorizer():
    make_p = lambda: tv.SmartTextVectorizer(max_cardinality=20,  # noqa
                                            min_support=2)
    make_j = lambda: jv.SmartTextVectorizer(max_cardinality=20,  # noqa
                                            min_support=2)
    (pi, pim), (ps, psm), (ji, jim), (js, jsm) = _fits(make_p, make_j,
                                                       ["t1", "t2"])
    assert pi.strategies == ps.strategies == ji.strategies == js.strategies \
        == ["pivot", "hash"]
    assert pi.vocabs == ps.vocabs == ji.vocabs == js.vocabs
    _same_tree(pim["drift_baseline"], jim["drift_baseline"])
    _same_tree(psm["drift_baseline"], jsm["drift_baseline"])
    assert list(psm["drift_baseline"]) == ["t1"]   # hashed text: none


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.RealVectorizer(), lambda pkg: pkg.IntegralVectorizer(),
    lambda pkg: pkg.OneHotVectorizer(top_k=3, min_support=2),
    lambda pkg: pkg.SmartTextVectorizer(max_cardinality=20)])
def test_merge_states_equals_one_stream(make):
    names = {"RealVectorizer": ["r1", "r2"], "IntegralVectorizer": ["i1"],
             "OneHotVectorizer": ["p1", "p2"],
             "SmartTextVectorizer": ["t1", "t2"]}[type(make(tv)).__name__]
    ds = _dataset(PORT, _raw(), names)
    one = _wire(PORT, make(tv), names)
    seq = one.fit_streaming(_chunks(ds))
    est = _wire(PORT, make(tv), names)
    states = []
    for part in (ds.slice(0, 333), ds.slice(333, N)):
        st = est.begin_fit()
        for c in _chunks(part):
            st = est.update_chunk(st, c, *[c[n] for n in names])
        states.append(st)
    merged = est.adopt_model(est.finish_fit(est.merge_states(*states)))
    for attr in ("vocabs", "strategies"):
        if hasattr(seq, attr):
            assert getattr(merged, attr) == getattr(seq, attr)
    if hasattr(seq, "fills"):
        np.testing.assert_allclose(merged.fills, seq.fills, rtol=1e-12)


# ---------------------------------------------------------------------------
# SanityChecker, MinVarianceFilter, naive Bayes: vector inputs
# ---------------------------------------------------------------------------

def _matrix(seed=1, n=N):
    """(X (n, 7) float32, y, vmeta columns): two reals, one correlated
    with the label, a constant, and a 3-slot indicator group + null."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.4).astype(np.float64)
    g = rng.integers(0, 3, n)
    X = np.zeros((n, 7), np.float32)
    X[:, 0] = rng.normal(size=n)
    X[:, 1] = y * 2 + rng.normal(size=n) * 0.5
    X[:, 2] = 1.0
    X[np.arange(n), 3 + g] = 1.0
    X[:, 6] = rng.random(n) < 0.1
    cols = [("a", None, None), ("b", None, None), ("c", None, None),
            ("g", "g", "x"), ("g", "g", "y"), ("g", "g", "z"),
            ("g", "g", "NullIndicatorValue")]
    return X, y, cols


def _vec_dataset(pkg, X, y, cols):
    vm = pkg["vm"]("features", [
        pkg["vcm"](p, "PickList" if grp else "Real", grouping=grp,
                   indicator_value=ind) for p, grp, ind in cols])
    vals = torch.from_numpy(X) if pkg is PORT else X
    return pkg["ds"]({
        "label": pkg["col"].from_values(pkg["ft"].RealNN, y),
        "features": pkg["col"](pkg["ft"].OPVector, vals, vmeta=vm)})


def _wire_vec(pkg, stage):
    stage.set_input(pkg["fb"].RealNN("label").as_response(),
                    pkg["fb"].OPVector("features").as_predictor())
    return stage


def _vec_fits(make_port, make_jax, X, y, cols):
    out = []
    for pkg, make in ((PORT, make_port), (JAX, make_jax)):
        ds = _vec_dataset(pkg, X, y, cols)
        est = _wire_vec(pkg, make())
        inc = est.adopt_model(est.fit_columns(ds, ds["label"],
                                              ds["features"]))
        inc_meta = dict(est.metadata)
        est2 = _wire_vec(pkg, make())
        st = est2.fit_streaming(_chunks(ds))
        out += [(inc, inc_meta), (st, dict(est2.metadata))]
    return out


@pytest.mark.parametrize("check_sample", [1.0, 0.5])
def test_sanity_checker_streaming(check_sample):
    X, y, cols = _matrix()
    kw = dict(check_sample=check_sample, max_correlation=0.9,
              max_cramers_v=0.5)
    (pi, pim), (ps, psm), (ji, jim), (js, jsm) = _vec_fits(
        lambda: tsc.SanityChecker(**kw), lambda: jsc.SanityChecker(**kw),
        X, y, cols)
    assert pi.keep_indices == ps.keep_indices == ji.keep_indices \
        == js.keep_indices
    # the port's streaming fit is the JAX package's, bit for bit
    _same_tree(psm["summary"], jsm["summary"])
    _same_tree(psm["drift_baseline_vector"], jsm["drift_baseline_vector"])
    # and the in-core fit's, up to the summation order; the sampled fit
    # keeps the same rows in both paths
    assert psm["summary"]["sampleSize"] == pim["summary"]["sampleSize"]
    if check_sample < 1:
        assert pim["summary"]["sampleSize"] < N
    for a, b in zip(psm["summary"]["columnStats"],
                    pim["summary"]["columnStats"]):
        assert a["dropped"] == b["dropped"] and a["reasons"] == b["reasons"]
        np.testing.assert_allclose(
            [a["mean"], a["variance"]], [b["mean"], b["variance"]],
            rtol=1e-12, atol=1e-15)
        assert abs(a["corr_label"] - b["corr_label"]) < 1e-9
    np.testing.assert_allclose(psm["drift_baseline_vector"]["mean"],
                               pim["drift_baseline_vector"]["mean"],
                               rtol=1e-12, atol=1e-15)
    assert (psm["drift_baseline_vector"]["names"]
            == pim["drift_baseline_vector"]["names"]
            == jim["drift_baseline_vector"]["names"])


def test_spearman_checker_does_not_stream():
    est = tsc.SanityChecker(correlation_type="spearman")
    assert not est.supports_streaming_fit
    with pytest.raises(ValueError, match="spearman"):
        est.begin_fit()
    assert tsc.SanityChecker().supports_streaming_fit


def test_min_variance_filter_streaming():
    X, y, cols = _matrix(2)
    (pi, pim), (ps, psm), (ji, jim), (js, jsm) = _vec_fits(
        lambda: tsc.MinVarianceFilter(min_variance=0.05),
        lambda: jsc.MinVarianceFilter(min_variance=0.05), X, y, cols)
    assert pi.keep_indices == ps.keep_indices == ji.keep_indices \
        == js.keep_indices == [0, 1, 3, 4, 5, 6]
    assert psm["summary"] == jsm["summary"] == pim["summary"]


def test_naive_bayes_streaming():
    X, y, cols = _matrix(3)
    X[:, 0] = np.abs(X[:, 0]).round()
    X[:, 1] = np.abs(X[:, 1]).round()
    (pi, _), (ps, _), (ji, _), (js, _) = _vec_fits(OpNaiveBayes, JNB, X, y,
                                                   cols)
    for got in (pi, ps):
        np.testing.assert_allclose(got.log_lik.numpy(),
                                   np.asarray(js.log_lik), atol=1e-5)
        np.testing.assert_allclose(got.log_prior.numpy(),
                                   np.asarray(js.log_prior), atol=1e-6)
    np.testing.assert_allclose(ps.log_lik.numpy(), pi.log_lik.numpy(),
                               atol=1e-5)
    est = _wire_vec(PORT, OpNaiveBayes())
    ds = _vec_dataset(PORT, X, y, cols)
    halves = []
    for part in (ds.slice(0, 250), ds.slice(250, N)):
        st = est.begin_fit()
        for c in _chunks(part):
            st = est.update_chunk(st, c, c["label"], c["features"])
        halves.append(st)
    merged = est.finish_fit(est.merge_states(*halves))
    np.testing.assert_allclose(merged.log_lik.numpy(), ps.log_lik.numpy(),
                               atol=1e-6)
    with pytest.raises(ValueError, match="no rows"):
        OpNaiveBayes().finish_fit(OpNaiveBayes().begin_fit())


def test_streaming_bin_edges_bitwise():
    rng = np.random.default_rng(9)
    X = np.column_stack([rng.normal(size=3000), rng.lognormal(size=3000),
                         rng.integers(0, 3, 3000).astype(float),
                         np.zeros(3000)]).astype(np.float32)
    chunks = [X[a:a + 257] for a in range(0, len(X), 257)]
    got = OpGBTClassifier(max_bins=16).streaming_bin_edges(
        [torch.from_numpy(c) for c in chunks])
    want = JGBT(max_bins=16).streaming_bin_edges(chunks)
    np.testing.assert_array_equal(got, want)
    hists = tg.streaming_histograms_for(chunks, hist_bins=64)
    jhists = jg.streaming_histograms_for(chunks, hist_bins=64)
    for h, j in zip(hists, jhists):
        np.testing.assert_array_equal(h.centroids, j.centroids)
        np.testing.assert_array_equal(h.counts, j.counts)
    np.testing.assert_array_equal(tg.quantile_bins_streaming(hists, 8),
                                  jg.quantile_bins_streaming(jhists, 8))
    assert isinstance(jhists[0], JHist)
