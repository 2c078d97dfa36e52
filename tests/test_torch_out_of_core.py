"""The out-of-core train (``OpWorkflow.train(chunk_rows=k)``,
``workflow/streaming.py``) in the port against the JAX package's chunked
train at the same ``chunk_rows`` and against the port's in-core train, on
Titanic-shaped rows (``chip_smoke.titanic_columns``: the demo's columns,
the label with signal), on the CPU.

The DAG of ``examples/bench_ingest.py``: the demo's ten predictors ->
``transmogrify`` -> ``SanityChecker(max_correlation=0.99)`` ->
``OpNaiveBayes``, every estimator streamed.  Both packages number uids
from 1, so every derived name agrees.  Tolerances, and why:
 * against the JAX package's chunked train: vocabularies, text
   strategies, fills, keep lists, the drift baselines and
   ``drift_baseline_vector`` bit-equal (the same host arithmetic, the
   JAX side's native histogram patched off); the naive Bayes log
   likelihoods within 1e-5 (float32 products on the card's side summed
   in another order) and holdout probabilities within 1e-5;
 * against the port's in-core train: vocabularies and keep lists equal,
   fills within 1e-12 relative (Welford against numpy's pairwise sums),
   log likelihoods within 1e-5, probabilities within 1e-4 (the in-core
   fit sums each class's features in one float32 product, the streamed
   one chunk by chunk: the sums part by an ulp, and a row's joint log
   likelihood weighs that by raw fares of up to a few hundred).
The retention budget's spill (``TMOG_STREAM_RETAIN_MB``) changes nothing,
bit for bit, and leaves no temp file, on success or error.  A selector
tail with a forest (the plain ``seg_hist`` on CPU tensors) picks the
in-core train's winner, holdout AuPR within 1e-4 (the Titanic tests'
tolerance).  RawFeatureFilter's chunked profile equals the JAX package's
at the same ``chunk_rows``, bins included, and drops what the in-core
filter drops."""
import glob
import itertools
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

import transmogrifai_tpu.native
import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.filters import RawFeatureFilter as JRFF
from transmogrifai_tpu.models.classification import OpNaiveBayes as JNB
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JChecker
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import ColumnarDataset as JDataset
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.filters import RawFeatureFilter
from transmogrifai_tpu_torch.models.classification import (
    OpLogisticRegression, OpNaiveBayes)
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, grid)
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                   FeatureColumn)
from transmogrifai_tpu_torch.utils import uid as tuid
from transmogrifai_tpu_torch.workflow import streaming as tstreaming
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

N_TRAIN, N_HOLD = 600, 300
JAX = dict(fb=JFB, ft=jft, col=JColumn, ds=JDataset, uid=juid,
           transmogrify=jtransmogrify, checker=JChecker, nb=JNB,
           workflow=JWorkflow)
PORT = dict(fb=FeatureBuilder, ft=ft, col=FeatureColumn, ds=ColumnarDataset,
            uid=tuid, transmogrify=transmogrify, checker=SanityChecker,
            nb=OpNaiveBayes, workflow=OpWorkflow)
PREDICTORS = [("PickList", "Pclass"), ("Text", "Name"), ("PickList", "Sex"),
              ("Real", "Age"), ("Integral", "SibSp"), ("Integral", "Parch"),
              ("PickList", "Ticket"), ("Real", "Fare"), ("PickList", "Cabin"),
              ("PickList", "Embarked")]


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


@pytest.fixture(scope="module")
def columns():
    cols, _ = chip_smoke.titanic_columns(N_TRAIN + N_HOLD)
    return cols


def _datasets(pkg, cols, extra=None):
    schema = dict(chip_smoke.TITANIC_SCHEMA)
    cols = dict(cols)
    for name, vals in (extra or {}).items():
        schema[name] = "Real"
        cols[name] = vals

    def ds(lo, hi):
        return pkg["ds"]({
            k: pkg["col"].from_values(
                getattr(pkg["ft"], v if isinstance(v, str) else v.__name__),
                cols[k][lo:hi]) for k, v in schema.items()})

    return ds(0, N_TRAIN), ds(N_TRAIN, N_TRAIN + N_HOLD)


def _bench_ingest_dag(pkg, extra=()):
    pkg["uid"]._counter = itertools.count(1)
    fb = pkg["fb"]
    survived = fb.RealNN("Survived").as_response()
    feats = pkg["transmogrify"]([getattr(fb, t)(n).as_predictor()
                                 for t, n in PREDICTORS]
                                + [fb.Real(n).as_predictor() for n in extra])
    checked = pkg["checker"](max_correlation=0.99).set_input(
        survived, feats).get_output()
    return pkg["nb"]().set_input(survived, checked).get_output()


def _train(pkg, cols, chunk_rows):
    train, hold = _datasets(pkg, cols)
    pred = _bench_ingest_dag(pkg)
    model = pkg["workflow"]().set_result_features(pred).set_input_data(
        train).train(chunk_rows=chunk_rows)
    scored = model.score(hold)
    proba = scored[pred.name].values.probability
    proba = proba.numpy() if isinstance(proba, torch.Tensor) else proba
    return model, np.asarray(proba)


def _meta(model, cls):
    return [s.metadata for s in model.stages if type(s).__name__ == cls]


def _by_class(model, cls):
    return [s for s in model.stages if type(s).__name__ == cls]


def _same_tree(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same_tree(u, v)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b, (a, b)


def _nb(model):
    (m,) = _by_class(model, "NaiveBayesModel")
    return np.asarray(m.log_prior), np.asarray(m.log_lik)


@pytest.fixture(scope="module")
def in_core(columns):
    tt.set_device("cpu")
    return _train(PORT, columns, None)


@pytest.mark.parametrize("chunk_rows", [7, 64, N_TRAIN])
def test_chunked_train_matches_jax_and_in_core(columns, in_core,
                                               chunk_rows):
    port, p_proba = _train(PORT, columns, chunk_rows)
    jax, j_proba = _train(JAX, columns, chunk_rows)
    inc, i_proba = in_core
    # every estimator streamed, the same passes as the JAX package's
    assert [p.label for p in port.ingest_profile.passes] == [
        p.label for p in jax.ingest_profile.passes]
    assert port.ingest_profile.total_rows == N_TRAIN
    assert set(port.fit_states) == {
        s.uid for s in port.stages if hasattr(s, "input_features")
        and type(s).__name__ != "VectorsCombiner"}
    for cls, attrs in (("RealVectorizerModel", ["fills"]),
                       ("OneHotVectorizerModel", ["vocabs"]),
                       ("SmartTextVectorizerModel", ["strategies",
                                                     "vocabs"]),
                       ("SanityCheckerModel", ["keep_indices"])):
        for a, b, c in zip(_by_class(port, cls), _by_class(jax, cls),
                           _by_class(inc, cls)):
            for attr in attrs:
                assert getattr(a, attr) == getattr(b, attr), (cls, attr)
                if attr == "fills":
                    np.testing.assert_allclose(a.fills, c.fills, rtol=1e-12)
                else:
                    assert getattr(a, attr) == getattr(c, attr)
    for cls in ("RealVectorizerModel", "OneHotVectorizerModel",
                "SmartTextVectorizerModel"):
        for a, b in zip(_meta(port, cls), _meta(jax, cls)):
            _same_tree(a["drift_baseline"], b["drift_baseline"])
    (pm,), (jm,), (im,) = (_meta(m, "SanityCheckerModel")
                           for m in (port, jax, inc))
    _same_tree(pm["drift_baseline_vector"], jm["drift_baseline_vector"])
    assert pm["summary"]["dropped"] == im["summary"]["dropped"]
    for got in (_nb(jax), _nb(inc)):
        np.testing.assert_allclose(_nb(port)[1], got[1], atol=1e-5)
        np.testing.assert_allclose(_nb(port)[0], got[0], atol=1e-6)
    np.testing.assert_allclose(p_proba, j_proba, atol=1e-5)
    np.testing.assert_allclose(p_proba, i_proba, atol=1e-4)


def test_spill_is_exact_and_leaves_no_file(columns, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    base, b_proba = _train(PORT, columns, 64)
    assert base.ingest_profile.spilled_bytes == 0
    monkeypatch.setenv("TMOG_STREAM_RETAIN_MB", "0.01")
    spilled, s_proba = _train(PORT, columns, 64)
    assert spilled.ingest_profile.spilled_bytes > 0
    np.testing.assert_array_equal(s_proba, b_proba)
    a, b = _by_class(base, "SanityCheckerModel")[0], _by_class(
        spilled, "SanityCheckerModel")[0]
    assert a.keep_indices == b.keep_indices
    np.testing.assert_array_equal(_nb(base)[1], _nb(spilled)[1])
    assert glob.glob(str(tmp_path / "tmog_spill_*")) == []

    # an error in the block cascade removes the file too
    def boom(self, state, data, *cols):
        raise RuntimeError("boom")

    monkeypatch.setattr(OpNaiveBayes, "update_chunk", boom)
    with pytest.raises(RuntimeError, match="boom"):
        _train(PORT, columns, 64)
    assert glob.glob(str(tmp_path / "tmog_spill_*")) == []


def test_block_store_round_trips_tensors_on_their_device(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    store = tstreaming._BlockStore(0)
    X = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    col = FeatureColumn.from_values(ft.Real, [1.0, None, 3.0, 4.0])
    store.append(ColumnarDataset({
        "v": FeatureColumn(ft.OPVector, X), "r": col}))
    assert store.spilled_bytes == 48 + 32 and len(store) == 1
    back = store.pop(0)
    assert isinstance(back["v"].values, torch.Tensor)
    assert back["v"].values.device == X.device
    assert torch.equal(back["v"].values, X)
    np.testing.assert_array_equal(back["r"].mask, col.mask)
    store.close()
    assert glob.glob(str(tmp_path / "tmog_spill_*")) == []


def _jax_bags(seed, n_trees, n, d, msub, subsample_rate, device):
    from transmogrifai_tpu.models import gbdt_kernels as jg

    bw, idx = jg.rf_bags_and_features(seed, n_trees, n, d, msub,
                                      subsample_rate)
    return (torch.from_numpy(np.array(bw)).to(device),
            torch.from_numpy(np.array(idx)).long().to(device))


def _selector_dag():
    tuid._counter = itertools.count(1)
    fb = FeatureBuilder
    survived = fb.RealNN("Survived").as_response()
    feats = transmogrify([getattr(fb, t)(n).as_predictor()
                          for t, n in PREDICTORS])
    checked = SanityChecker().set_input(survived, feats).get_output()
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, models_and_parameters=[
            (OpLogisticRegression(), grid(reg_param=[0.1])),
            (OpRandomForestClassifier(), grid(num_trees=[5],
                                              max_depth=[4]))])
    return sel.set_input(survived, checked).get_output(), checked, sel


def test_selector_tail_with_a_forest(columns, monkeypatch):
    from transmogrifai_tpu_torch.models import gbdt_kernels as tk

    monkeypatch.setattr(tk, "rf_bags_and_features", _jax_bags)
    out = {}
    for chunk_rows in (None, 64):
        pred, checked, sel = _selector_dag()
        train, hold = _datasets(PORT, columns)
        model = OpWorkflow().set_result_features(pred).set_input_data(
            train).train(chunk_rows=chunk_rows)
        _, metrics = model.score_and_evaluate(
            Evaluators.BinaryClassification.auPR(), data=hold)
        summ = sel.metadata["model_selector_summary"]
        out[chunk_rows] = (model, metrics["AuPR"], summ, checked,
                           sel.metadata)
    (inc, inc_aupr, inc_summ, inc_checked, _), (ch, ch_aupr, ch_summ,
                                                ch_checked, ch_meta) = \
        out[None], out[64]
    assert ch_meta["rf_trees"] > 0 and ch_meta["hist_levels"] > 0
    # the prefix streamed up to the selector, which fit in-core
    assert [p.label.split("[")[0] for p in ch.ingest_profile.passes] == [
        "fit", "fit+materialize", "assemble"]
    assert ch_summ["bestModelType"] == inc_summ["bestModelType"]
    assert abs(ch_aupr - inc_aupr) < 1e-4
    a = _by_class(inc, "SanityCheckerModel")[0]
    b = _by_class(ch, "SanityCheckerModel")[0]
    assert a.keep_indices == b.keep_indices
    X_in = inc.train_data[inc_checked.name].values
    X_ch = ch.train_data[ch_checked.name].values
    assert X_in.shape == X_ch.shape
    np.testing.assert_allclose(X_ch.numpy(), X_in.numpy(), rtol=1e-6)


def _planted(cols):
    """``leak``: null exactly where Survived is 1; ``rare``: never filled
    in the train rows (below the filter's 0.001 fill rate), on 1% of the
    holdout rows."""
    rng = np.random.default_rng(chip_smoke.VE_SEED)
    n = len(cols["Survived"])
    leak = np.where(cols["Survived"] == 1, np.nan, rng.normal(size=n))
    rare = np.where((rng.random(n) < 0.01) & (np.arange(n) >= N_TRAIN),
                    rng.normal(size=n), np.nan)
    return {"leak": leak, "rare": rare}


def _rff_features(fb):
    return ([fb.RealNN("Survived").as_response()]
            + [getattr(fb, t)(n).as_predictor() for t, n in PREDICTORS]
            + [fb.Real("leak").as_predictor(),
               fb.Real("rare").as_predictor()])


@pytest.mark.parametrize("chunk_rows", [64, 250])
def test_filter_streaming_matches_jax_and_in_core(columns, chunk_rows):
    extra = _planted(columns)
    train, hold = _datasets(PORT, columns, extra)
    jtrain, jhold = _datasets(JAX, columns, extra)
    res, stats = RawFeatureFilter(scoring_data=hold).filter_streaming(
        tt.readers.base.reader_for(train), _rff_features(FeatureBuilder),
        chunk_rows)
    jres, jstats = JRFF(scoring_data=jhold).filter_streaming(
        __import__("transmogrifai_tpu.readers.base", fromlist=["x"])
        .reader_for(jtrain), _rff_features(JFB), chunk_rows)
    _, inc = RawFeatureFilter(scoring_data=hold).filter_raw_data(
        train, _rff_features(FeatureBuilder))
    assert res.dropped_features == jres.dropped_features \
        == inc.dropped_features == ["leak", "rare"]
    assert stats["rows"] == jstats["rows"] == N_TRAIN
    assert stats["score_rows"] == N_HOLD and stats["passes"] == 2
    for dists, jdists in ((res.train_distributions,
                           jres.train_distributions),
                          (res.score_distributions,
                           jres.score_distributions)):
        assert [(d.name, d.key, d.count, d.nulls) for d in dists] == [
            (d.name, d.key, d.count, d.nulls) for d in jdists]
        for d, j in zip(dists, jdists):
            if j.hist is not None:
                np.testing.assert_array_equal(d.hist.centroids,
                                              j.hist.centroids)
                np.testing.assert_array_equal(d.hist.counts, j.hist.counts)
            if j.text_counts is not None:
                np.testing.assert_array_equal(d.text_counts, j.text_counts)
    for r, j in zip(res.exclusion_reasons, jres.exclusion_reasons):
        assert r.to_json() == j.to_json()


def test_chunked_train_with_the_filter(columns):
    extra = _planted(columns)
    train, hold = _datasets(PORT, columns, extra)
    pred = _bench_ingest_dag(PORT, extra=("leak", "rare"))
    model = (OpWorkflow().set_result_features(pred).set_input_data(train)
             .with_raw_feature_filter(scoring_data=hold)).train(chunk_rows=100)
    assert model.raw_feature_filter_results.dropped_features == [
        "leak", "rare"]
    assert model.ingest_profile.rff["rows"] == N_TRAIN
    assert model.lint_snapshot is not None


def test_not_ported_options_raise():
    pred = _bench_ingest_dag(PORT)
    train = ColumnarDataset({"Survived": FeatureColumn.from_values(
        ft.RealNN, [1.0])})
    wf = OpWorkflow().set_result_features(pred).set_input_data(train)
    for kwargs, item in ((dict(profile=True), "6.5"),
                         (dict(checkpoint_dir="/nonexistent",
                               chunk_rows=8), "6.5"),
                         (dict(tuner=object()), "6.5")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            wf.train(**kwargs)
    with pytest.raises(NotImplementedError, match="item 6.5"):
        OpWorkflow().set_result_features(pred).set_input_data(
            train).with_workflow_cv().train(chunk_rows=8)
    with pytest.raises(NotImplementedError, match="item 6.7"):
        OpWorkflow().with_mesh(object())
    with pytest.raises(ValueError, match="chunk_rows"):
        wf.train(chunk_rows=0, validate=False)
    # an estimator that cannot stream says so
    with pytest.raises(NotImplementedError, match="does not support "
                                                  "streaming fit"):
        OpLogisticRegression().fit_streaming([train])
