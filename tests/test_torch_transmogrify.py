"""The port's vectorizers and ``transmogrify`` against the JAX package's
on the CPU: the same numpy-seeded raw columns go through each fitted
stage in both packages, on the training rows and on rows the fit never
saw.  Matrices must be bit-equal (the same float32 values) and the
``VectorMetadata`` equal slot by slot; strategies and vocabularies
equal.  The feature DSL's math transformers must give equal float64
values and equal masks; ``vectorize`` the same matrix as a one-feature
``transmogrify``."""
import numpy as np
import pytest

import transmogrifai_tpu.dsl  # noqa: F401  the JAX package's fluent methods
import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.ops import date_geo as jdg
from transmogrifai_tpu.ops import map_vectorizers as jmv
from transmogrifai_tpu.ops import vectorizers as jv
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import ColumnarDataset as JDataset
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.ops import date_geo as tdg
from transmogrifai_tpu_torch.ops import map_vectorizers as tmv
from transmogrifai_tpu_torch.ops import vectorizers as tv
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import ColumnarDataset, FeatureColumn
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

WORDS = ["alpha", "beta", "Gamma", "délta", "eps's", "zeta", "ÉTA"]
JAX = (JFB, jft, JColumn, JDataset, JWorkflow)
PORT = (FeatureBuilder, ft, FeatureColumn, ColumnarDataset, OpWorkflow)


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


def _frame(n, seed):
    """One raw column of each storage (and a few variants), by name:
    (type name, values)."""
    rng = np.random.default_rng(seed)

    def maybe(p, make):
        return [None if rng.random() < p else make(i) for i in range(n)]

    def pick(k):
        return str(rng.choice(WORDS[:k]))

    return {
        "r": ("Real", np.where(rng.random(n) < 0.1, np.nan,
                               rng.normal(size=n))),
        "i": ("Integral", rng.integers(0, 5, n).astype(float)),
        "b": ("Binary", maybe(0.1, lambda i: bool(rng.random() < 0.4))),
        "d": ("Date", maybe(0.1, lambda i: int(rng.integers(0, 2 ** 41)))),
        "dl": ("DateList", [[int(x) for x in rng.integers(
            0, 2 ** 41, rng.integers(0, 4))] for _ in range(n)]),
        "p": ("PickList", maybe(0.1, lambda i: f"c{rng.integers(0, 8)}")),
        # many distinct values: hashed
        "t": ("Text", maybe(0.1, lambda i: " ".join(rng.choice(WORDS, 3))
                            + f" n{i}")),
        # few distinct values: pivoted
        "tl": ("Text", maybe(0.1, lambda i: pick(5))),
        "m": ("MultiPickList", [set(rng.choice(WORDS, rng.integers(0, 3)))
                                for _ in range(n)]),
        "x": ("TextList", [list(rng.choice(WORDS, rng.integers(0, 4)))
                           for _ in range(n)]),
        "g": ("Geolocation", maybe(0.2, lambda i: [
            float(rng.normal()), float(rng.normal()), 1.0])),
        "v": ("OPVector", rng.normal(size=(n, 3)).astype(np.float32)),
        "rm": ("RealMap", [{k: float(rng.normal()) for k in rng.choice(
            ["a", "b", "c"], rng.integers(0, 3), replace=False)}
            for _ in range(n)]),
        "tm": ("TextMap", [{k: pick(6) + ("" if k == "a" else f"{i}")
                            for k in rng.choice(["a", "b"], rng.integers(
                                0, 3), replace=False)}
                           for i in range(n)]),
        "mm": ("MultiPickListMap", [{"k": set(rng.choice(WORDS, 2))}
                                    for _ in range(n)]),
        "gm": ("GeolocationMap", [{"h": [1.0, 2.0, 3.0]}
                                  if rng.random() < 0.5 else {}
                                  for _ in range(n)]),
    }


def _dataset(pkg, frame, names):
    _, types, col, ds, _ = pkg
    return ds({nm: col.from_values(getattr(types, frame[nm][0]),
                                   frame[nm][1]) for nm in names})


def _fit_and_score(pkg, frame, hold, names, make):
    """Train ``make(features)`` on ``frame`` and score ``hold``: the
    output column of each, and the result feature."""
    fb, _, _, _, wf = pkg
    feats = [getattr(fb, frame[nm][0])(nm).as_predictor() for nm in names]
    out = make(feats)
    model = wf().set_result_features(out).set_input_data(
        _dataset(pkg, frame, names)).train()
    scored = model.score(_dataset(pkg, hold, names))
    return model.train_data[out.name], scored[out.name], out


def _matrix(col):
    vals = col.values
    return vals.numpy() if hasattr(vals, "numpy") else np.asarray(vals)


def _meta(col):
    return [(c.parent_feature, c.parent_type, c.grouping, c.indicator_value,
             c.descriptor_value, c.index) for c in col.vmeta.columns]


def _assert_same(names, make_jax, make_port, n=500, seed=3):
    frame, hold = _frame(n, seed), _frame(n // 2, seed + 100)
    jfit, jscore, jout = _fit_and_score(JAX, frame, hold, names, make_jax)
    tfit, tscore, tout = _fit_and_score(PORT, frame, hold, names, make_port)
    for j, t in ((jfit, tfit), (jscore, tscore)):
        J, T = _matrix(j), _matrix(t)
        assert T.dtype == np.float32 and T.shape == J.shape
        np.testing.assert_array_equal(T, J)
        assert _meta(t) == _meta(j)
    return jout, tout


def _stage(jcls, tcls, **kw):
    return (lambda fs: jcls(**kw).set_input(*fs).get_output(),
            lambda fs: tcls(**kw).set_input(*fs).get_output())


@pytest.mark.parametrize("kw", [
    {},                                                  # pivot + hash
    {"max_cardinality": 4},                              # saturated: hash
    {"max_cardinality": 6, "track_text_len": True},
    {"min_fill_rate": 0.95},                             # ignore both
    {"track_nulls": False, "num_hash_features": 16, "min_support": 40},
], ids=["default", "saturated", "text_len", "ignore", "narrow"])
def test_smart_text(kw):
    jout, tout = _assert_same(["t", "tl"], *_stage(
        jv.SmartTextVectorizer, tv.SmartTextVectorizer, **kw))
    assert (tout.origin_stage.metadata["text_strategies"]
            == jout.origin_stage.metadata["text_strategies"])


def test_smart_text_strategies_and_vocab():
    """Each of the three strategies, and the saturation rule: counting
    stops once more than max_cardinality distinct values are seen."""
    make_j, make_t = _stage(jv.SmartTextVectorizer, tv.SmartTextVectorizer,
                            max_cardinality=5, min_fill_rate=0.5,
                            min_support=1)
    frame = _frame(300, 9)
    frame["e"] = ("Text", [None] * 290 + ["x"] * 10)
    frame["tl"] = ("Text", [WORDS[i % 5] for i in range(300)])
    hold = _frame(50, 10)
    hold["e"] = ("Text", [None] * 50)
    hold["tl"] = ("Text", [WORDS[i % 7] for i in range(50)])
    names = ["t", "tl", "e"]
    jfit, _, jout = _fit_and_score(JAX, frame, hold, names, make_j)
    tfit, _, tout = _fit_and_score(PORT, frame, hold, names, make_t)
    strategies = tout.origin_stage.metadata["text_strategies"]
    assert strategies == {"t": "hash", "tl": "pivot", "e": "ignore"}
    assert strategies == jout.origin_stage.metadata["text_strategies"]
    np.testing.assert_array_equal(_matrix(tfit), _matrix(jfit))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("binary_freq", [False, True])
def test_text_hashing(shared, binary_freq):
    _assert_same(["t", "x", "tl"], *_stage(
        jv.TextHashingVectorizer, tv.TextHashingVectorizer, num_features=64,
        shared_hash_space=shared, binary_freq=binary_freq))


def test_hash_rows_counts_collisions():
    """Two tokens in one bucket count 2 (and 1 under binary_freq)."""
    vals = np.array(["a b a", None, "", "b"], dtype=object)
    for bf in (False, True):
        want = np.zeros((4, 3), np.float32)
        got = np.zeros((4, 3), np.float32)
        e1 = jv._hash_rows(vals, want, 0, 1, 42, bf)
        e2 = tv._hash_rows(vals, got, 0, 1, 42, bf)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(e2, e1)
        assert got[0, 0] == (1.0 if bf else 3.0)


@pytest.mark.parametrize("names,stages", [
    (["b"], (jv.BinaryVectorizer, tv.BinaryVectorizer)),
    (["m"], (jv.MultiPickListVectorizer, tv.MultiPickListVectorizer)),
    (["d"], (jdg.DateToUnitCircleVectorizer,
             tdg.DateToUnitCircleVectorizer)),
    (["g"], (jdg.GeolocationVectorizer, tdg.GeolocationVectorizer)),
    (["rm"], (jmv.NumericMapVectorizer, tmv.NumericMapVectorizer)),
    (["tm"], (jmv.TextMapPivotVectorizer, tmv.TextMapPivotVectorizer)),
    (["tm"], (jmv.SmartTextMapVectorizer, tmv.SmartTextMapVectorizer)),
    (["mm"], (jmv.MultiPickListMapVectorizer,
              tmv.MultiPickListMapVectorizer)),
    (["gm"], (jmv.GeoMapVectorizer, tmv.GeoMapVectorizer)),
], ids=["binary", "multi_pick_list", "date", "geolocation", "numeric_map",
        "text_map_pivot", "smart_text_map", "multi_pick_list_map",
        "geo_map"])
def test_vectorizer(names, stages):
    kw = {"min_support": 2} if "min_support" in stages[0].__init__.__code__.\
        co_varnames else {}
    _assert_same(names, *_stage(*stages, **kw))


def test_date_unit_circle_periods():
    _assert_same(["d"], *_stage(
        jdg.DateToUnitCircleVectorizer, tdg.DateToUnitCircleVectorizer,
        time_periods=["HourOfDay", "DayOfWeek", "DayOfMonth", "DayOfYear"]))


@pytest.mark.parametrize("pivot", ["SinceFirst", "SinceLast", "ModeDay",
                                   "ModeMonth", "ModeHour"])
def test_date_list(pivot):
    _assert_same(["dl"], *_stage(jdg.DateListVectorizer,
                                 tdg.DateListVectorizer, pivot=pivot))


def test_extract_time_period():
    ms = np.random.default_rng(4).integers(0, 2 ** 42, 1000)
    for period in tdg.TIME_PERIOD_NAMES:
        np.testing.assert_array_equal(tdg.extract_time_period(ms, period),
                                      jdg.extract_time_period(ms, period))


def test_transmogrify_twelve_groups():
    """One frame with every group (and every map family): the vectors and
    their metadata bit-equal, through the default dispatcher."""
    names = list(_frame(10, 0))
    _assert_same(names, lambda fs: jtransmogrify(fs, min_support=5),
                 lambda fs: transmogrify(fs, min_support=5), n=600)


def test_group_of_matches():
    from transmogrifai_tpu.ops.transmogrify import _group_of as jgroup
    from transmogrifai_tpu_torch.ops.transmogrify import _group_of

    for t in ft.all_feature_types():
        name = t.type_name()
        jt_ = jft.type_by_name(name)
        try:
            want = jgroup(jt_)
        except TypeError:
            with pytest.raises(TypeError):
                _group_of(t)
            continue
        assert _group_of(t) == want, name


def _math_frame(pkg, n=400, seed=5):
    _, types, col, ds, _ = pkg
    rng = np.random.default_rng(seed)
    a = np.where(rng.random(n) < 0.1, np.nan, rng.normal(size=n))
    b = np.where(rng.random(n) < 0.1, np.nan,
                 rng.integers(-2, 3, n).astype(float))
    return ds({"a": col.from_values(types.Real, a),
               "b": col.from_values(types.Integral, b)})


@pytest.mark.parametrize("expr", [
    lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
    lambda a, b: a / b, lambda a, b: a + 1.0, lambda a, b: b * 2.5,
    lambda a, b: a / 0.0, lambda a, b: (a + b + 1.0) * a,
    lambda a, b: (b - 3).alias("renamed")],
    ids=["plus", "minus", "multiply", "divide", "plus_scalar",
         "multiply_scalar", "divide_by_zero", "chain", "alias"])
def test_math_transformers(expr):
    outs = []
    for pkg in (JAX, PORT):
        fb, _, _, _, wf = pkg
        out = expr(fb.Real("a").as_predictor(),
                   fb.Integral("b").as_predictor())
        model = wf().set_result_features(out).set_input_data(
            _math_frame(pkg)).train()
        outs.append((model.train_data[out.name], out))
    (jc, jo), (tc, to) = outs
    assert to.name.split("_")[0] == jo.name.split("_")[0]
    assert to.ftype.type_name() == jo.ftype.type_name()
    np.testing.assert_array_equal(tc.mask, jc.mask)
    np.testing.assert_array_equal(tc.values, jc.values)


def test_vectorize_is_one_feature_transmogrify():
    frame, hold = _frame(300, 8), _frame(100, 18)
    _assert_same(["p"], lambda fs: fs[0].vectorize(top_k=2, min_support=1),
                 lambda fs: fs[0].vectorize(top_k=2, min_support=1))
    _, _, tout = _fit_and_score(PORT, frame, hold, ["p"],
                                lambda fs: fs[0].vectorize(top_k=2))
    assert type(tout.origin_stage).__name__ == "OneHotVectorizer"


def test_single_rows_score_like_the_batch():
    """Single-row requests with every storage (text, sets, lists, dates,
    geolocations, maps, vectors) through the local scorer give the rows of
    the batch transform, bit for bit."""
    from transmogrifai_tpu_torch.local import score_function_batch

    frame, hold = _frame(400, 21), _frame(12, 22)
    names = list(frame)
    feats = [getattr(FeatureBuilder, frame[nm][0])(nm).as_predictor()
             for nm in names]
    out = transmogrify(feats, min_support=5)
    model = OpWorkflow().set_result_features(out).set_input_data(
        _dataset(PORT, frame, names)).train()
    want = _matrix(model.score(_dataset(PORT, hold, names))[out.name])
    score = score_function_batch(model)
    for i in range(12):
        row = {nm: hold[nm][1][i] for nm in names}
        (got,) = score([row])
        np.testing.assert_array_equal(
            np.asarray(got[out.name], np.float32), want[i])
