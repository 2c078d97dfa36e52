"""The port's stage arity bases, DSL transformers, time-period stages,
MinVarianceFilter and the full feature DSL against the JAX package's on
the CPU.

Host stages (the DSL transformers, time periods) must give equal values
and masks; MinVarianceFilter's keep list and ``dropped`` summary equal
exactly and its output bit-equal; every fluent method that the JAX
package installs on ``Feature`` exists in the port, and one workflow that
calls every one of them trains and scores in both packages with each
output equal: bit-equal, except Word2Vec's and LDA's (within
``test_torch_embeddings.py``'s tolerances: 2e-5 and 2e-4 absolute)."""
import itertools

import numpy as np
import pytest
import torch

import transmogrifai_tpu.dsl  # noqa: F401  the JAX package's fluent methods
import transmogrifai_tpu_torch as tt
from test_torch_text import JAX, PORT, assert_same_column, run_stage
from transmogrifai_tpu.features.feature import Feature as JFeature
from transmogrifai_tpu.ops import date_geo as jdg
from transmogrifai_tpu.ops import dsl_transformers as jdt
from transmogrifai_tpu.ops.text import OpCountVectorizer as JCountVectorizer
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.preparators import sanity_checker as jsc
from transmogrifai_tpu.stages import base as jbase
from transmogrifai_tpu.types.columns import ColumnarDataset as JDataset
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.features.feature import Feature
from transmogrifai_tpu_torch.ops import date_geo as tdg
from transmogrifai_tpu_torch.ops import dsl_transformers as tdt
from transmogrifai_tpu_torch.ops.text import OpCountVectorizer
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators import sanity_checker as tsc
from transmogrifai_tpu_torch.stages import base as tbase
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                   FeatureColumn)
from transmogrifai_tpu_torch.utils import uid as tuid
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARITY_BASES = ["UnaryTransformer", "BinaryTransformer", "TernaryTransformer",
               "QuaternaryTransformer", "SequenceTransformer",
               "BinarySequenceTransformer", "UnaryModel", "BinaryModel",
               "TernaryModel", "QuaternaryModel", "SequenceModel",
               "BinarySequenceModel", "UnaryEstimator", "BinaryEstimator",
               "TernaryEstimator", "QuaternaryEstimator", "SequenceEstimator",
               "BinarySequenceEstimator"]


@pytest.mark.parametrize("name", ARITY_BASES)
def test_arity_bases(name):
    tcls, jcls = getattr(tbase, name), getattr(jbase, name)
    assert tcls.input_arity == jcls.input_arity
    kind = next(k for k in ("Transformer", "Model", "Estimator")
                if name.endswith(k))
    assert issubclass(tcls, getattr(tbase, kind))
    lo, hi = tcls.input_arity

    class Probe(tcls):
        def __init__(self):
            super().__init__(operation_name="probe", output_type=ft.Real)

    feats = [FeatureBuilder.Real(f"f{i}").as_predictor()
             for i in range(5)]
    Probe().set_input(*feats[:lo])
    with pytest.raises(ValueError):
        Probe().set_input(*feats[:lo - 1])
    if hi is not None:
        with pytest.raises(ValueError):
            Probe().set_input(*feats[:hi + 1])


def test_lambda_transformer():
    specs = [("Real", "x")]
    x = [1.0, None, 3.5]

    def make(mod, col_cls):
        return mod.LambdaTransformer(
            lambda c: col_cls.from_values(
                ft.Real if mod is tbase else jft.Real,
                [None if v is None else v * 2 for v in c.to_list()]),
            ft.Real if mod is tbase else jft.Real, "double")

    _, (jo,) = run_stage(JAX, lambda: make(jbase, JColumn), specs, [x])
    t, (to,) = run_stage(PORT, lambda: make(tbase, FeatureColumn), specs, [x])
    assert t.operation_name == "double"
    assert_same_column(to, jo)


def _reals(n, seed, p_null=0.2):
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(0, 3, n), 1)
    x[rng.random(n) < p_null] = np.nan
    return x


def _words(n, seed, vocab=("red", "Green", "blue", "dark red", "")):
    rng = np.random.default_rng(seed)
    return [None if rng.random() < 0.15 else str(rng.choice(vocab))
            for _ in range(n)]


DSL_CASES = [
    ("FilterTransformer", lambda m: dict(predicate=lambda v: v > 0),
     [("Real", "x")], lambda: [_reals(200, 1)]),
    ("FilterTransformer", lambda m: dict(predicate=lambda v: "r" in v),
     [("Text", "t")], lambda: [_words(200, 2)]),
    ("ReplaceTransformer", lambda m: dict(replace="red", with_value="RED"),
     [("PickList", "p")], lambda: [_words(200, 3)]),
    ("ToOccurTransformer", lambda m: {}, [("Real", "x")],
     lambda: [_reals(200, 4)]),
    ("ToOccurTransformer", lambda m: dict(matches=lambda v: v == "blue"),
     [("Text", "t")], lambda: [_words(200, 5)]),
    ("ExistsTransformer", lambda m: {}, [("Text", "t")],
     lambda: [_words(200, 6)]),
    ("ExistsTransformer", lambda m: {}, [("TextList", "l")],
     lambda: [[w.split() if w else None for w in _words(200, 7)]]),
    ("SubstringTransformer", lambda m: {}, [("Text", "a"), ("Text", "b")],
     lambda: [_words(200, 8), _words(200, 9, ("red", "e", "BLUE", ""))]),
    ("JaccardSimilarity", lambda m: {},
     [("MultiPickList", "a"), ("MultiPickList", "b")],
     lambda: [[set(w.split()) if w else None for w in _words(200, 10)],
              [set(w.split()) if w else None for w in _words(200, 11)]]),
    ("NGramSimilarity", lambda m: {}, [("Text", "a"), ("Text", "b")],
     lambda: [_words(200, 12), _words(200, 13)]),
    ("NGramSimilarity", lambda m: dict(n=2),
     [("TextList", "a"), ("Text", "b")],
     lambda: [[w.split() if w else None for w in _words(200, 14)],
              _words(200, 15)]),
]


@pytest.mark.parametrize("name,kw,specs,raws", DSL_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(DSL_CASES)])
def test_dsl_transformers_equal(name, kw, specs, raws):
    r = raws()
    _, (jo,) = run_stage(JAX, lambda: getattr(jdt, name)(**kw(jdt)), specs,
                         r)
    _, (to,) = run_stage(PORT, lambda: getattr(tdt, name)(**kw(tdt)), specs,
                         r)
    assert_same_column(to, jo)


def test_present_predicate():
    for v in (None, [], (), set(), {}, "", 0.0, [0], {"a": None}, "x"):
        assert tdt.present(v) == (
            v is not None and not (isinstance(v, (list, tuple, set, dict))
                                   and not v))


def test_drop_indices_by_equal():
    """Through a one-feature transmogrify: the null indicators go."""
    data = {"x": _reals(150, 16), "y": _reals(150, 17)}
    outs = []
    for pkg, wf_cls, ds_cls, col_cls, types, uidmod, from_pkg, trans in (
            (JAX, JWorkflow, JDataset, JColumn, jft, juid, jdt,
             jtransmogrify),
            (PORT, OpWorkflow, ColumnarDataset, FeatureColumn, ft, tuid, tdt,
             transmogrify)):
        uidmod._counter = itertools.count(1)
        fb = pkg["fb"]
        x = fb.Real("x").as_predictor()
        y = fb.Real("y").as_predictor()
        vec = trans([x, y])
        out = vec.drop_indices_by(
            lambda c: c.indicator_value is not None)
        assert isinstance(out.origin_stage,
                          from_pkg.DropIndicesByTransformer)
        ds = ds_cls({k: col_cls.from_values(types.Real, v)
                     for k, v in data.items()})
        model = (wf_cls().set_result_features(out).set_input_data(ds)
                 .allow_non_serializable().train())
        outs.append(model.score(ds)[out.name])
    assert outs[1].values.shape[1] == 2
    assert_same_column(outs[1], outs[0])


PERIODS = ["DayOfMonth", "DayOfWeek", "DayOfYear", "HourOfDay",
           "MonthOfYear", "WeekOfMonth", "WeekOfYear"]


def _dates(n, seed):
    rng = np.random.default_rng(seed)
    return [None if rng.random() < 0.1 else int(rng.integers(0, 2 ** 41))
            for _ in range(n)]


@pytest.mark.parametrize("period", PERIODS)
def test_time_period_equal(period):
    _, (jo,) = run_stage(JAX, lambda: jdg.TimePeriodTransformer(period),
                         [("Date", "d")], [_dates(300, 18)])
    _, (to,) = run_stage(PORT, lambda: tdg.TimePeriodTransformer(period),
                         [("Date", "d")], [_dates(300, 18)])
    assert_same_column(to, jo)
    maps = [{k: v for k, v in zip("abc", _dates(3, 19 + i)) if v is not None}
            for i in range(100)] + [None, {}]
    _, (jo,) = run_stage(JAX, lambda: jdg.TimePeriodMapTransformer(period),
                         [("DateMap", "m")], [maps])
    _, (to,) = run_stage(PORT, lambda: tdg.TimePeriodMapTransformer(period),
                         [("DateMap", "m")], [maps])
    assert_same_column(to, jo)


def test_time_period_rejects_unknown():
    for mod in (tdg.TimePeriodTransformer, tdg.TimePeriodMapTransformer):
        with pytest.raises(ValueError, match="unknown time period"):
            mod("Fortnight")


@pytest.mark.parametrize("wiring", ["label_and_vector", "vector_only"])
@pytest.mark.parametrize("min_variance", [1e-5, 1e-3])
def test_min_variance_filter_equal(wiring, min_variance):
    data = {"x": _reals(400, 20, 0.0), "c": np.full(400, 2.0),
            "tiny": 1.0 + 1e-3 * (np.arange(400) % 2),
            "z": _reals(400, 21)}
    specs = [("RealNN", "label")] if wiring == "label_and_vector" else []
    results = []
    for pkg, wf_cls, ds_cls, col_cls, types, uidmod, mvf, trans in (
            (JAX, JWorkflow, JDataset, JColumn, jft, juid,
             jsc.MinVarianceFilter, jtransmogrify),
            (PORT, OpWorkflow, ColumnarDataset, FeatureColumn, ft, tuid,
             tsc.MinVarianceFilter, transmogrify)):
        uidmod._counter = itertools.count(1)
        fb = pkg["fb"]
        label = fb.RealNN("label").as_response()
        feats = [fb.Real(k).as_predictor() for k in data]
        vec = trans(feats)
        stage = mvf(min_variance=min_variance)
        out = (stage.set_input(label, vec) if specs else
               stage.set_input(vec)).get_output()
        cols = {k: col_cls.from_values(types.Real, v)
                for k, v in data.items()}
        cols["label"] = col_cls.from_values(types.RealNN,
                                            (data["x"] > 0).astype(float))
        ds = ds_cls(cols)
        model = wf_cls().set_result_features(out).set_input_data(ds).train()
        fitted = next(s for s in model.stages
                      if type(s).__name__ == "MinVarianceFilterModel")
        results.append((fitted, stage.metadata["summary"],
                        model.score(ds)[out.name]))
    (jm, jsum, jo), (tm, tsum, to) = results
    assert tm.keep_indices == jm.keep_indices
    assert tsum == jsum
    assert len(tsum["dropped"]) >= 2
    assert_same_column(to, jo)


#: every fluent method the JAX package installs on ``Feature``
FLUENT = ["alias", "filter_values", "replace_value", "to_occur", "exists",
          "contains", "jaccard_similarity", "ngram_similarity",
          "drop_indices_by", "tokenize", "ngrams", "remove_stop_words",
          "hashing_tf", "index_string", "text_len", "word2vec", "lda",
          "to_unit_circle", "to_time_period", "map_to_time_period",
          "vectorize_date_list", "bucketize", "auto_bucketize",
          "fill_missing_with_mean", "zscore", "calibrate_percentile",
          "sanity_check", "vectorize"]


def test_every_jax_fluent_method_exists():
    jax_methods = {n for n, v in vars(JFeature).items()
                   if getattr(v, "__module__", "") == "transmogrifai_tpu.dsl"}
    assert set(FLUENT) | {"__add__", "__sub__", "__mul__",
                          "__truediv__"} == jax_methods
    missing = [n for n in jax_methods if not hasattr(Feature, n)]
    assert not missing


def _dsl_data(n, seed):
    rng = np.random.default_rng(seed)
    x = _reals(n, seed + 1)
    words = ["alpha", "beta", "gamma", "delta", "the", "and", "eps"]
    text = [None if rng.random() < 0.1 else
            " ".join(rng.choice(words, int(rng.integers(1, 8))))
            for _ in range(n)]
    return {
        "label": (np.nan_to_num(x) + rng.normal(0, 1, n) > 0).astype(float),
        "x": x,
        "w": rng.lognormal(0, 1, n),
        "t": text,
        "u": _words(n, seed + 2),
        "d": _dates(n, seed + 3),
        "dm": [{k: v for k, v in zip("ab", _dates(2, seed + 10 + i))
                if v is not None} for i in range(n)],
        "dl": [[v for v in _dates(int(rng.integers(0, 4)), seed + 900 + i)
                if v is not None] for i in range(n)],
    }


TYPES = {"label": "RealNN", "x": "Real", "w": "Real", "t": "Text",
         "u": "PickList", "d": "Date", "dm": "DateMap", "dl": "DateList"}


def _fluent_dag(pkg, trans):
    fb = pkg["fb"]
    f = {k: (getattr(fb, t)(k).as_response() if k == "label" else
             getattr(fb, t)(k).as_predictor()) for k, t in TYPES.items()}
    toks = f["t"].tokenize()
    counts = toks.remove_stop_words().ngrams(n=1)
    count_vec = JCountVectorizer if pkg is JAX else OpCountVectorizer
    cv = count_vec(vocab_size=8).set_input(counts).get_output()
    outs = [
        f["x"].alias("x_alias"), f["x"].filter_values(lambda v: v > 0),
        f["u"].replace_value("red", "RED"), f["x"].to_occur(),
        f["t"].exists(), f["t"].contains(f["u"]),
        toks.jaccard_similarity(counts), f["t"].ngram_similarity(f["u"]),
        toks, counts, toks.hashing_tf(num_features=16),
        f["u"].index_string(handle_invalid="keep"), f["t"].text_len(),
        toks.word2vec(vector_size=6, min_count=1, batch_size=32), cv,
        cv.lda(k=3, max_iter=5), f["d"].to_unit_circle(),
        f["d"].to_time_period("DayOfWeek"),
        f["dm"].map_to_time_period("MonthOfYear"),
        f["dl"].vectorize_date_list(), f["w"].bucketize([0.0, 1.0, 3.0]),
        f["w"].auto_bucketize(f["label"], max_depth=3),
        f["x"].fill_missing_with_mean(), f["x"].zscore(),
        f["w"].calibrate_percentile(buckets=10),
        trans([f["x"], f["w"]]).sanity_check(f["label"]),
        trans([f["x"], f["u"]]).drop_indices_by(
            lambda c: c.indicator_value is not None),
        f["w"].vectorize(),
    ]
    return outs


def test_fluent_methods_workflow_equal():
    data = _dsl_data(400, 30)
    scored = []
    for pkg, wf_cls, ds_cls, col_cls, types, uidmod, trans in (
            (JAX, JWorkflow, JDataset, JColumn, jft, juid, jtransmogrify),
            (PORT, OpWorkflow, ColumnarDataset, FeatureColumn, ft, tuid,
             transmogrify)):
        uidmod._counter = itertools.count(1)
        outs = _fluent_dag(pkg, trans)
        ds = ds_cls({k: col_cls.from_values(getattr(types, TYPES[k]), v)
                     for k, v in data.items()})
        model = (wf_cls().set_result_features(*outs).set_input_data(ds)
                 .allow_non_serializable().train())
        res = model.score(ds)
        scored.append([(o.name, type(o.origin_stage).__name__, res[o.name])
                       for o in outs])
    for (jn, jcls, jo), (tn, tcls, to) in zip(*scored):
        assert (tn, tcls) == (jn, jcls)
        tol = {"OpWord2Vec": 2e-5, "OpLDA": 2e-4}.get(tcls, 0.0)
        assert_same_column(to, jo, atol=tol)
