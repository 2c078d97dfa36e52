"""The feature-engineering options of the port (each set off the JAX
default) against the JAX package's, on the CPU, on the numpy-seeded raw
columns of ``test_torch_transmogrify._frame``.

Checked, in both packages on the same rows:
 * every option, one case each: the map vectorizers' ``allow_keys``/
   ``block_keys`` (the kept keys, in the JAX order), ``fill_with_mean``
   of ``NumericMapVectorizer`` and ``GeolocationVectorizer``,
   ``IntegralVectorizer(fill_with_mode=, fill_value=)`` in-core and
   streamed, the inert ``SmartTextVectorizer(auto_detect_languages=)``
   and ``SanityChecker(remove_feature_group=)``, the
   ``GeolocationMapVectorizer`` alias: fitted keys and fills equal,
   vectors within 1e-6 (they are float32 copies of the same float64
   values), column metadata equal;
 * a JAX model saved with every option off its default loads in the
   port and scores within 1e-6: the same weights, the LR's float32
   margin summed in another order (the hashed fields are 8 buckets wide
   there, so a margin sums ~50 terms; at the default 512 buckets, ~1 100
   terms, the probabilities part by up to 1.2e-6);
 * the pivot blocks (``ops.vectorizers.pivot_block``): OneHot,
   SmartText's pivot and MultiPickList blocks bitwise equal to the JAX
   package's, and the device scatter bitwise equal to the host build;
 * a raw ``OPVector`` column (a host array) fed straight to the
   SanityChecker moves to the device once, with the JAX package's keep
   list.
"""
import itertools

import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from test_torch_transmogrify import JAX, PORT, _frame, _matrix, _meta
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
from transmogrifai_tpu.ops import date_geo as jdg
from transmogrifai_tpu.ops import map_vectorizers as jmv
from transmogrifai_tpu.ops import vectorizers as jv
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JChecker
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch.ops import date_geo as tdg
from transmogrifai_tpu_torch.ops import map_vectorizers as tmv
from transmogrifai_tpu_torch.ops import vectorizers as tv
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.utils import uid as tuid
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflowModel

VEC_TOL = 1e-6
SCORE_TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(n=400, seed=3):
    """``_frame``'s columns plus an Integral with missing values, a
    geolocation map and a multi-pick-list map with two keys each, and a
    0/1 label."""
    out = []
    for k, s in ((n, seed), (n // 2, seed + 100)):
        fr = _frame(k, s)
        rng = np.random.default_rng(s + 7)
        fr["in"] = ("Integral", np.where(rng.random(k) < 0.2, np.nan,
                                         rng.integers(0, 4, k).astype(float)))
        fr["gm2"] = ("GeolocationMap", [
            {key: [float(rng.normal()), float(rng.normal()), 2.0]
             for key in ("h", "w") if rng.random() < 0.6}
            for _ in range(k)])
        fr["mm2"] = ("MultiPickListMap", [
            {key: set(rng.choice(["x", "y", "z"], 2))
             for key in ("j", "k") if rng.random() < 0.7}
            for _ in range(k)])
        fr["label"] = ("RealNN", (rng.random(k) < 0.4).astype(float))
        out.append(fr)
    return out


def _dataset(pkg, frame, names):
    _, types, col, ds, _ = pkg
    return ds({nm: col.from_values(getattr(types, frame[nm][0]),
                                   frame[nm][1]) for nm in names})


def _feature(pkg, frame, name):
    f = getattr(pkg[0], frame[name][0])(name)
    return f.as_response() if name == "label" else f.as_predictor()


def _fit(pkg, frame, hold, names, make):
    """Train ``make(features)`` in ``pkg``: (the fitted stage, its output
    on the training rows, on the holdout rows)."""
    feats = [_feature(pkg, frame, nm) for nm in names]
    out = make(feats)
    model = pkg[4]().set_result_features(out).set_input_data(
        _dataset(pkg, frame, names)).train()
    stage = next(s for s in model.stages
                 if s.get_output().name == out.name)
    scored = model.score(_dataset(pkg, hold, names))
    return stage, model.train_data[out.name], scored[out.name]


#: (id, input columns, (JAX class, port class), options, fitted attributes)
OPTIONS = [
    ("numeric_map_keys_no_mean", ["rm"],
     (jmv.NumericMapVectorizer, tmv.NumericMapVectorizer),
     dict(allow_keys=["a", "c"], block_keys=["c"], fill_with_mean=False),
     ("keysets", "fills")),
    ("numeric_map_block_only", ["rm"],
     (jmv.NumericMapVectorizer, tmv.NumericMapVectorizer),
     dict(block_keys=["b"]), ("keysets", "fills")),
    ("text_map_pivot_keys", ["tm"],
     (jmv.TextMapPivotVectorizer, tmv.TextMapPivotVectorizer),
     dict(allow_keys=["a"], min_support=2), ("keysets", "vocabs")),
    ("smart_text_map_keys", ["tm"],
     (jmv.SmartTextMapVectorizer, tmv.SmartTextMapVectorizer),
     dict(block_keys=["a"], min_support=2),
     ("keysets", "strategies", "vocabs")),
    ("multi_pick_list_map_keys", ["mm2"],
     (jmv.MultiPickListMapVectorizer, tmv.MultiPickListMapVectorizer),
     dict(allow_keys=["k", "z"], block_keys=["z"], min_support=2),
     ("keysets", "vocabs")),
    ("geolocation_map_alias_keys", ["gm2"],
     (jmv.GeolocationMapVectorizer, tmv.GeolocationMapVectorizer),
     dict(block_keys=["w"]), ("keysets",)),
    ("geolocation_zero_fill", ["g"],
     (jdg.GeolocationVectorizer, tdg.GeolocationVectorizer),
     dict(fill_with_mean=False), ("fills",)),
    ("integral_fill_value", ["in"],
     (jv.IntegralVectorizer, tv.IntegralVectorizer),
     dict(fill_with_mode=False, fill_value=7), ("fills",)),
    ("smart_text_auto_detect_languages", ["t", "tl"],
     (jv.SmartTextVectorizer, tv.SmartTextVectorizer),
     dict(auto_detect_languages=True, min_support=2),
     ("strategies", "vocabs")),
]


@pytest.mark.parametrize("names,classes,kw,attrs",
                         [c[1:] for c in OPTIONS],
                         ids=[c[0] for c in OPTIONS])
def test_option_matches_jax(names, classes, kw, attrs):
    frame, hold = _frames()
    jcls, tcls = classes
    got = []
    for pkg, cls in ((JAX, jcls), (PORT, tcls)):
        got.append(_fit(pkg, frame, hold, names,
                        lambda fs, c=cls: c(**kw).set_input(*fs)
                        .get_output()))
    (js, jfit, jhold), (ts, tfit, thold) = got
    for a in attrs:
        assert getattr(ts, a) == getattr(js, a), a
    for j, t in ((jfit, tfit), (jhold, thold)):
        assert _matrix(t).shape == _matrix(j).shape
        np.testing.assert_allclose(_matrix(t), _matrix(j), rtol=0,
                                   atol=VEC_TOL)
        assert _meta(t) == _meta(j)
    # an option off its default changes the fit, except the inert one
    default = _fit(PORT, frame, hold, names,
                   lambda fs: tcls(**{k: v for k, v in kw.items()
                                      if k == "min_support"})
                   .set_input(*fs).get_output())[0]
    changed = any(getattr(default, a) != getattr(ts, a) for a in attrs)
    assert changed == ("auto_detect_languages" not in kw)


def test_keys_keep_the_jax_order():
    """allow/block keys leave the kept keys sorted, as the JAX package
    does (the order sets the vector's columns)."""
    vals = [{"zeta": 1.0, "alpha": 2.0}, {"mid": 3.0, "beta": None}]
    out = []
    for pkg, mod in ((JAX, jmv), (PORT, tmv)):
        f = pkg[0].RealMap("m").as_predictor()
        est = mod.NumericMapVectorizer(allow_keys=["zeta", "mid", "alpha"],
                                       block_keys=["mid"]).set_input(f)
        col = pkg[2].from_values(pkg[1].RealMap, vals)
        out.append(est.fit_columns(None, col).keysets)
    assert out[0] == out[1] == [["alpha", "zeta"]]


def test_integral_fill_value_streams():
    """IntegralVectorizer(fill_with_mode=False) through the streaming fit:
    the in-core fill in both packages."""
    frame, _ = _frames()
    fills = []
    for pkg, mod in ((JAX, jv), (PORT, tv)):
        f = _feature(pkg, frame, "in")
        est = mod.IntegralVectorizer(fill_with_mode=False,
                                     fill_value=-3).set_input(f)
        ds = _dataset(pkg, frame, ["in"])
        chunks = [ds.slice(a, min(a + 37, len(ds)))
                  for a in range(0, len(ds), 37)]
        fills.append((est.fit_streaming(chunks).fills,
                      est.fit_columns(ds, ds["in"]).fills))
    assert fills[0] == fills[1] == ([-3.0], [-3.0])


def test_remove_feature_group_is_inert():
    """SanityChecker(remove_feature_group=False) keeps what the default
    keeps, in both packages, and the port records it."""
    frame, _ = _frames()
    keeps = []
    for pkg, cls, mod in ((JAX, JChecker, jv), (PORT, SanityChecker, tv)):
        fs = [_feature(pkg, frame, n) for n in ("label", "p", "r")]
        vec = mod.VectorsCombiner().set_input(
            mod.OneHotVectorizer(min_support=2).set_input(fs[1])
            .get_output(),
            mod.RealVectorizer().set_input(fs[2]).get_output()).get_output()
        for flag in (True, False):
            chk = cls(remove_feature_group=flag, max_correlation=0.5)
            out = chk.set_input(fs[0], vec).get_output()
            model = pkg[4]().set_result_features(out).set_input_data(
                _dataset(pkg, frame, ["label", "p", "r"])).train()
            stage = next(s for s in model.stages
                         if s.get_output().name == out.name)
            keeps.append(stage.keep_indices)
            if pkg is PORT:
                assert chk.get_params()["remove_feature_group"] is flag
    assert keeps[0] == keeps[1] == keeps[2] == keeps[3]


def _all_options_dag(pkg, mods, checker, lr, frame):
    """Every option off its default: the map vectorizers with key lists
    and no mean fill, the zero-filled geolocation, the fixed integral
    fill, SmartText with language detection, the checker keeping feature
    groups -> LR."""
    mv, v, dg = mods
    f = {n: _feature(pkg, frame, n) for n in
         ("label", "rm", "tm", "mm2", "gm2", "g", "in", "t", "tl")}
    vecs = [
        mv.NumericMapVectorizer(allow_keys=["a", "b"], block_keys=["b"],
                                fill_with_mean=False).set_input(f["rm"]),
        mv.TextMapPivotVectorizer(allow_keys=["a"], min_support=2)
        .set_input(f["tm"]),
        mv.SmartTextMapVectorizer(block_keys=["a"], min_support=2,
                                  num_hash_features=8).set_input(f["tm"]),
        mv.MultiPickListMapVectorizer(allow_keys=["k"], min_support=2)
        .set_input(f["mm2"]),
        mv.GeolocationMapVectorizer(block_keys=["w"]).set_input(f["gm2"]),
        dg.GeolocationVectorizer(fill_with_mean=False).set_input(f["g"]),
        v.IntegralVectorizer(fill_with_mode=False, fill_value=7)
        .set_input(f["in"]),
        v.SmartTextVectorizer(auto_detect_languages=True, min_support=2,
                              num_hash_features=8)
        .set_input(f["t"], f["tl"]),
    ]
    combined = v.VectorsCombiner().set_input(
        *[s.get_output() for s in vecs]).get_output()
    checked = checker(remove_feature_group=False).set_input(
        f["label"], combined).get_output()
    return lr(max_iter=30).set_input(f["label"], checked).get_output()


def test_jax_model_with_every_option_loads_and_scores(tmp_path):
    frame, hold = _frames()
    names = ["label", "rm", "tm", "mm2", "gm2", "g", "in", "t", "tl"]
    juid._counter = itertools.count(1)
    pred = _all_options_dag(JAX, (jmv, jv, jdg), JChecker, JLR, frame)
    jmodel = JAX[4]().set_result_features(pred).set_input_data(
        _dataset(JAX, frame, names)).train()
    path = str(tmp_path / "jax_model")
    jmodel.save(path)
    tuid._counter = itertools.count(1)
    loaded = OpWorkflowModel.load(path)
    jp = np.asarray(jmodel.score(_dataset(JAX, hold, names))[
        pred.name].values.probability)
    tp = loaded.score(_dataset(PORT, hold, names))[
        pred.name].values.probability.numpy()
    assert tp.shape == jp.shape and np.isfinite(tp).all()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("names,classes,kw", [
    (["p"], (jv.OneHotVectorizer, tv.OneHotVectorizer),
     dict(min_support=2, top_k=3)),
    (["t", "tl"], (jv.SmartTextVectorizer, tv.SmartTextVectorizer),
     dict(min_support=2, track_text_len=True)),
    (["m"], (jv.MultiPickListVectorizer, tv.MultiPickListVectorizer),
     dict(min_support=2, top_k=4)),
], ids=["one_hot", "smart_text", "multi_pick_list"])
def test_pivot_block_bitwise_equal_to_jax(names, classes, kw):
    frame, hold = _frames()
    got = [_fit(pkg, frame, hold, names,
                lambda fs, c=cls: c(**kw).set_input(*fs).get_output())
           for pkg, cls in zip((JAX, PORT), classes)]
    (_, jfit, jhold), (ts, tfit, thold) = got
    for j, t in ((jfit, tfit), (jhold, thold)):
        np.testing.assert_array_equal(_matrix(t), _matrix(j))
        assert _matrix(t).dtype == np.float32
    # the device scatter against the host build of the same indices
    cols = _dataset(PORT, hold, names)
    n, width, rows, idx = ts.pivot_ones(*[cols[nm] for nm in names])
    assert rows.dtype == np.int32 and idx.dtype == np.int32
    np.testing.assert_array_equal(
        tv.pivot_block(n, width, rows, idx, "cpu").numpy(),
        tv.pivot_block_host(n, width, rows, idx))


def test_raw_vector_input_moves_to_the_device_once():
    """A raw OPVector column (a host float32 array) fed straight to the
    SanityChecker: fitted (the JAX keep list) and transformed as a
    tensor."""
    rng = np.random.default_rng(8)
    n = 300
    y = (rng.random(n) < 0.5).astype(float)
    X = np.column_stack([rng.normal(size=n), y + rng.normal(0, 1e-3, n),
                         np.zeros(n)]).astype(np.float32)
    keeps = []
    for pkg, cls in ((JAX, JChecker), (PORT, SanityChecker)):
        label = pkg[0].RealNN("label").as_response()
        vec = pkg[0].OPVector("v").as_predictor()
        out = cls().set_input(label, vec).get_output()
        ds = pkg[3]({"label": pkg[2].from_values(pkg[1].RealNN, y),
                     "v": pkg[2](pkg[1].OPVector, X)})
        model = pkg[4]().set_result_features(out).set_input_data(ds).train()
        keeps.append(next(s for s in model.stages
                          if s.get_output().name == out.name).keep_indices)
        if pkg is PORT:
            vals = model.score(ds)[out.name].values
            assert isinstance(vals, torch.Tensor)
            np.testing.assert_array_equal(vals.numpy(), X[:, keeps[-1]])
    assert keeps[0] == keeps[1] == [0]
