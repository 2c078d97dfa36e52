"""The port's text stages (``ops/text.py``) against the JAX package's on
the CPU: the same numpy-seeded columns through each stage in both
packages, fitted on one draw and applied to it and to a second draw the
fit never saw.  Tokens, n-grams, stop-word removal, string indices and
lengths must be equal; count and hashed term-frequency blocks bit-equal
(the same float32 values) with equal vector metadata.

The helpers here (``wire``, ``run_stage``, ``assert_same_column``) drive
one stage of either package on raw columns; the other feature-engineering
parity files import them."""
import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.ops import text as jtext
from transmogrifai_tpu.stages.base import Estimator as JEstimator
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.ops import text as ttext
from transmogrifai_tpu_torch.stages.base import Estimator
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import FeatureColumn

JAX = dict(fb=JFB, ft=jft, col=JColumn, est=JEstimator)
PORT = dict(fb=FeatureBuilder, ft=ft, col=FeatureColumn, est=Estimator)

WORDS = ["The", "quick", "brown", "fox", "and", "a", "lazy", "dog's",
         "über", "niño", "is", "in", "of", "Zürich", "café", "it"]


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


def wire(pkg, stage, specs):
    """Wire ``stage`` to fresh raw features: ``specs`` is a list of
    (type name, feature name); the first may be the response."""
    fb = pkg["fb"]
    feats = []
    for i, (tname, name) in enumerate(specs):
        f = getattr(fb, tname)(name)
        feats.append(f.as_response() if name == "label" else
                     f.as_predictor())
    stage.set_input(*feats)
    return stage


def columns(pkg, specs, raws):
    """The package's FeatureColumns of raw values, one per spec."""
    return [pkg["col"].from_values(getattr(pkg["ft"], tname), raw)
            for (tname, _), raw in zip(specs, raws)]


def run_stage(pkg, make, specs, fit_raws, apply_raws=()):
    """Fit (an estimator) on ``fit_raws`` and apply to each raw set:
    (the fitted stage, [output columns])."""
    stage = wire(pkg, make(), specs)
    fit_cols = columns(pkg, specs, fit_raws)
    if isinstance(stage, pkg["est"]):
        stage = stage.adopt_model(stage.fit_columns(None, *fit_cols))
    outs = [stage.transform_columns(*fit_cols)]
    outs += [stage.transform_columns(*columns(pkg, specs, r))
             for r in apply_raws]
    return stage, outs


def _host(values):
    if isinstance(values, torch.Tensor):
        return values.cpu().numpy()
    return values


def assert_same_column(t, j, rtol=0.0, atol=0.0):
    """Port column ``t`` against JAX column ``j``: the same type name,
    values (bit-equal by default, else within the tolerance), masks and
    vector metadata."""
    assert t.ftype.type_name() == j.ftype.type_name()
    tv, jv = _host(t.values), np.asarray(j.values)
    if jv.dtype == object:
        assert list(tv) == list(jv)
    elif rtol == 0 and atol == 0:
        assert tv.dtype == jv.dtype or jv.dtype == np.float64
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(tv, jv, rtol=rtol, atol=atol)
    if j.mask is not None:
        np.testing.assert_array_equal(np.asarray(t.mask), np.asarray(j.mask))
    if j.vmeta is not None:
        assert t.vmeta.to_json() == j.vmeta.to_json()


def _texts(n, seed, p_null=0.1):
    rng = np.random.default_rng(seed)
    return [None if rng.random() < p_null else
            " ".join(rng.choice(WORDS, int(rng.integers(0, 9))))
            for _ in range(n)]


def _token_lists(n, seed):
    tok = jtext.TextTokenizer()
    return [tok.tokenize(v) for v in _texts(n, seed)]


@pytest.mark.parametrize("kw", [{}, {"to_lowercase": False},
                                {"min_token_length": 3}])
def test_tokenizer(kw):
    specs = [("Text", "t")]
    raws = ([_texts(300, 1)], [_texts(50, 2)])
    _, jout = run_stage(JAX, lambda: jtext.TextTokenizer(**kw), specs, *raws)
    _, tout = run_stage(PORT, lambda: ttext.TextTokenizer(**kw), specs,
                        *raws)
    for t, j in zip(tout, jout):
        assert_same_column(t, j)


@pytest.mark.parametrize("name,kw", [
    ("OpNGram", {}), ("OpNGram", {"n": 3}), ("OpNGram", {"n": 1}),
    ("OpStopWordsRemover", {}),
    ("OpStopWordsRemover", {"stop_words": ["fox", "The"],
                            "case_sensitive": True}),
    ("TextLenTransformer", {})])
def test_token_list_transformers(name, kw):
    specs = [("TextList", "toks")]
    raws = ([_token_lists(300, 3)], [_token_lists(40, 4)])
    _, jout = run_stage(JAX, lambda: getattr(jtext, name)(**kw), specs,
                        *raws)
    _, tout = run_stage(PORT, lambda: getattr(ttext, name)(**kw), specs,
                        *raws)
    for t, j in zip(tout, jout):
        assert_same_column(t, j)


def test_text_len_of_text():
    specs = [("Text", "t")]
    raws = ([_texts(200, 5)],)
    _, jout = run_stage(JAX, jtext.TextLenTransformer, specs, *raws)
    _, tout = run_stage(PORT, ttext.TextLenTransformer, specs, *raws)
    assert_same_column(tout[0], jout[0])


@pytest.mark.parametrize("kw", [{}, {"vocab_size": 5},
                                {"min_df": 20, "binary": True}])
def test_count_vectorizer(kw):
    specs = [("TextList", "a"), ("TextList", "b")]
    fit = [_token_lists(400, 6), _token_lists(400, 7)]
    unseen = [_token_lists(60, 8), _token_lists(60, 9)]
    jm, jout = run_stage(JAX, lambda: jtext.OpCountVectorizer(**kw), specs,
                         fit, [unseen])
    tm, tout = run_stage(PORT, lambda: ttext.OpCountVectorizer(**kw), specs,
                         fit, [unseen])
    assert tm.vocab == jm.vocab
    for t, j in zip(tout, jout):
        assert t.values.dtype == torch.float32
        assert_same_column(t, j)


@pytest.mark.parametrize("kw", [{}, {"num_features": 16, "binary": True},
                                {"num_features": 7, "seed": 3}])
def test_hashing_tf(kw):
    specs = [("TextList", "toks")]
    raws = ([_token_lists(400, 10)], [_token_lists(50, 11)])
    _, jout = run_stage(JAX, lambda: jtext.OpHashingTF(**kw), specs, *raws)
    _, tout = run_stage(PORT, lambda: ttext.OpHashingTF(**kw), specs, *raws)
    for t, j in zip(tout, jout):
        assert_same_column(t, j)


def _labels(n, seed, k=6):
    rng = np.random.default_rng(seed)
    vals = rng.choice([f"c{i}" for i in range(k)], n,
                      p=np.arange(k, 0, -1) / (k * (k + 1) / 2))
    return [None if rng.random() < 0.05 else str(v) for v in vals]


@pytest.mark.parametrize("make", ["keep", "skip", "nofilter"])
def test_string_indexer_round_trip(make):
    """Indices equal (unseen labels per ``handle_invalid``), and
    OpIndexToString maps them back to the labels both ways."""
    def build(mod):
        if make == "nofilter":
            return mod.OpStringIndexerNoFilter()
        return mod.OpStringIndexer(handle_invalid=make)

    specs = [("Text", "s")]
    fit = [_labels(500, 12, 5)]
    unseen = [_labels(80, 13, 7)]
    jm, jout = run_stage(JAX, lambda: build(jtext), specs, fit, [unseen])
    tm, tout = run_stage(PORT, lambda: build(ttext), specs, fit, [unseen])
    assert tm.labels == jm.labels
    for t, j in zip(tout, jout):
        assert_same_column(t, j)
    back_specs = [("RealNN", "idx")]
    for t, j in zip(tout, jout):
        vals = [float(v) for v in np.asarray(j.values)]
        _, (jb,) = run_stage(JAX, lambda: jtext.OpIndexToString(jm.labels),
                             back_specs, [vals])
        _, (tb,) = run_stage(PORT, lambda: ttext.OpIndexToString(tm.labels),
                             back_specs, [vals])
        assert_same_column(tb, jb)
    # the training rows' labels come back exactly (missing -> unseen)
    src = fit[0]
    seen_back = [jm.labels[int(v)] if int(v) < len(jm.labels)
                 else "UnseenLabel" for v in np.asarray(tout[0].values)]
    assert seen_back == [v if v is not None else "UnseenLabel" for v in src]


def test_string_indexer_error_on_unseen():
    specs = [("Text", "s")]
    for mod in (jtext, ttext):
        pkg = JAX if mod is jtext else PORT
        with pytest.raises(ValueError, match="unseen label"):
            run_stage(pkg, mod.OpStringIndexer, specs, [["a", "b"]],
                      [[["c"]]])
