"""The reference's headline Titanic demo (``examples/op_titanic_simple.py``)
in the port against the JAX package, end to end on the CPU.

FeatureBuilder -> feature arithmetic and ``vectorize`` -> ``transmogrify``
(real, integral, pivoted text, SmartText hashing and a vector) ->
``SanityChecker(remove_bad_features=True)`` ->
``BinaryClassificationModelSelector.with_cross_validation(num_folds=3)``
over the demo's grid (LR reg_param {0.01, 0.1, 0.3}; RF 50 trees x depth
{6, 12}, min info gain 0.001) -> ``OpWorkflow.train`` ->
``score_and_evaluate(AuPR)`` -> save, load, local scoring and serving, on
3 000 train + 1 000 holdout rows of ``examples/bench_pipeline.py``'s
``make_titanic_like`` with a label regenerated from a logit of sex, class,
fare and age (the generator's own label is noise). The port's forests draw
the JAX package's bags (``rf_bags_and_features`` patched) and grow the
same trees (same splits, equal leaves; ``test_forests_equal``).
Tolerances: the checked vectors bit-equal, the same winner, LR CV metrics
within 1e-4 (``tests/test_torch_selector.py``'s), RF CV metrics within
1e-4: a forest's probability is a float32 sum over its 50 trees, taken in
another order than the JAX package's, so scores differ by an ulp, which
makes or breaks exact score ties among held-out rows (the depth-12
forests' pure leaves tie often) and moves an AuPR by a tie group's share
(1e-6 to 2e-5 on these rows; ``tests/test_torch_selector.py``'s own
fractional-weight regime allows 1e-3). Holdout AuPR within 1e-4, for the
same reason. Run once as is and once with ``_SPARSE_MIN_ELEMS`` patched
down in both packages' ``models.trees`` (a test-time patch) so both take
the nonzero-aware sketch (that leg and the forest comparison are in
``tests/test_torch_titanic_sketch.py``). A 100 000-row leg holds
transmogrify and the sanity checker bit-equal at scale. Artifacts cross
both ways: a JAX-saved demo model scores in the port within 1e-6, the
port's in JAX, and their ``summary_pretty`` lines are equal."""
import itertools
import os
import sys

import numpy as np
import pytest
import torch

import transmogrifai_tpu.dsl  # noqa: F401  the JAX package's fluent methods
import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JEvaluators
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models import gbdt_kernels as jg
from transmogrifai_tpu.models import trees as jtrees
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
from transmogrifai_tpu.models.trees import OpRandomForestClassifier as JRF
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JSanityChecker
from transmogrifai_tpu.selector.model_selector import \
    BinaryClassificationModelSelector as JBCMS
from transmogrifai_tpu.selector.model_selector import grid as jgrid
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu.workflow.workflow import OpWorkflowModel as JModel
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.local import score_function_batch
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.models import trees as ttrees
from transmogrifai_tpu_torch.models.classification import \
    OpLogisticRegression
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, grid)
from transmogrifai_tpu_torch.serving import ModelServer
from transmogrifai_tpu_torch.utils import uid as tuid
from transmogrifai_tpu_torch.workflow.workflow import (OpWorkflow,
                                                       OpWorkflowModel)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
from bench_pipeline import make_titanic_like  # noqa: E402

N_TRAIN, N_HOLD = 3000, 1000
JAX = dict(fb=JFB, transmogrify=jtransmogrify, checker=JSanityChecker,
           selector=JBCMS, grid=jgrid, lr=JLR, rf=JRF, workflow=JWorkflow,
           evaluators=JEvaluators, uid=juid)
PORT = dict(fb=FeatureBuilder, transmogrify=transmogrify,
            checker=SanityChecker, selector=BinaryClassificationModelSelector,
            grid=grid, lr=OpLogisticRegression, rf=OpRandomForestClassifier,
            workflow=OpWorkflow, evaluators=Evaluators, uid=tuid)


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one intra-op thread: inside the parallel test run the CPU
    is shared, and the port's forests (integer sums) and the checked
    vectors do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def titanic_frame(rows, seed=7, label_seed=11):
    """``make_titanic_like`` with ``Survived`` drawn from the logit
    -1.1 + 2.4 [female] - 1.0 [3rd class] + 0.35 log1p(fare)
    - 0.015 age (30 where missing)."""
    df = make_titanic_like(rows, seed=seed)
    logit = (-1.1 + 2.4 * (df["Sex"] == "female").to_numpy()
             - 1.0 * (df["Pclass"] == "3").to_numpy()
             + 0.35 * np.log1p(df["Fare"].to_numpy())
             - 0.015 * np.nan_to_num(df["Age"].to_numpy(), nan=30))
    u = np.random.default_rng(label_seed).random(rows)
    df["Survived"] = (1 / (1 + np.exp(-logit)) > u).astype(float)
    return df


def _reset_uids(pkg):
    """Both packages number their uids from 1 for a pipeline, so derived
    feature names (and every name in the vector metadata) agree."""
    pkg["uid"]._counter = itertools.count(1)


def build_demo(pkg, with_selector=True):
    """The demo's DAG in ``pkg``: (prediction or None, checked vector,
    selector or None)."""
    _reset_uids(pkg)
    fb = pkg["fb"]
    survived = fb.RealNN("Survived").as_response()
    pclass = fb.PickList("Pclass").as_predictor()
    name = fb.Text("Name").as_predictor()
    sex = fb.PickList("Sex").as_predictor()
    age = fb.Real("Age").as_predictor()
    sibsp = fb.Integral("SibSp").as_predictor()
    parch = fb.Integral("Parch").as_predictor()
    ticket = fb.PickList("Ticket").as_predictor()
    fare = fb.Real("Fare").as_predictor()
    cabin = fb.PickList("Cabin").as_predictor()
    embarked = fb.PickList("Embarked").as_predictor()
    family_size = sibsp + parch + 1.0
    estimated_cost = family_size * fare
    pivoted_sex = sex.vectorize(top_k=2)
    features = pkg["transmogrify"]([
        pclass, name, age, sibsp, parch, ticket, fare, cabin, embarked,
        family_size, estimated_cost, pivoted_sex])
    checked = pkg["checker"](remove_bad_features=True).set_input(
        survived, features).get_output()
    if not with_selector:
        return None, checked, None
    g = pkg["grid"]
    sel = pkg["selector"].with_cross_validation(
        num_folds=3, models_and_parameters=[
            (pkg["lr"](), g(reg_param=[0.01, 0.1, 0.3],
                            elastic_net_param=[0.0])),
            (pkg["rf"](), g(num_trees=[50], max_depth=[6, 12],
                            min_info_gain=[0.001]))])
    return sel.set_input(survived, checked).get_output(), checked, sel


def _jax_bags(seed, n_trees, n, d, msub, subsample_rate, device):
    bw, idx = jg.rf_bags_and_features(seed, n_trees, n, d, msub,
                                      subsample_rate)
    return (torch.from_numpy(np.array(bw)).to(device),
            torch.from_numpy(np.array(idx)).long().to(device))


def _train(pkg, train, hold, sparse):
    tt.set_device("cpu")
    pred, checked, sel = build_demo(pkg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMOG_COST_HISTORY", "0")
        mp.setenv("TMOG_SYNC_SWEEP", "1")
        mp.setattr(tk, "rf_bags_and_features", _jax_bags)
        if sparse:
            mp.setattr(jtrees, "_SPARSE_MIN_ELEMS", 1000)
            mp.setattr(ttrees, "_SPARSE_MIN_ELEMS", 1000)
        kinds = dict(ttrees.SKETCH_KINDS)
        model = pkg["workflow"]().set_result_features(pred).set_input_data(
            train).train()
        kinds = {k: ttrees.SKETCH_KINDS[k] - kinds[k] for k in kinds}
    scored, metrics = model.score_and_evaluate(
        pkg["evaluators"].BinaryClassification.auPR(), data=hold)
    return dict(model=model, pred=pred, checked=checked, selector=sel,
                scored=scored, metrics=metrics, kinds=kinds)


@pytest.fixture(scope="module")
def frames():
    df = titanic_frame(N_TRAIN + N_HOLD)
    return df.iloc[:N_TRAIN].reset_index(drop=True), \
        df.iloc[N_TRAIN:].reset_index(drop=True)


def _both(frames, sparse):
    train, hold = frames
    return _train(JAX, train, hold, sparse), _train(PORT, train, hold,
                                                    sparse), sparse


@pytest.fixture(scope="module")
def runs(frames):
    """The demo as is (``tests/test_torch_titanic_sketch.py`` runs it
    with the nonzero-aware sketch)."""
    return _both(frames, False)


def _summary(run):
    return run["selector"].metadata["model_selector_summary"]


def _matrix(col):
    v = col.values
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _meta(col):
    return [c.to_json() for c in col.vmeta.columns]


class TestDemoParity:
    def test_checked_vectors_bit_equal(self, runs):
        j, t, _ = runs
        jc = j["model"].train_data[j["checked"].name]
        tc = t["model"].train_data[t["checked"].name]
        assert t["checked"].name == j["checked"].name
        np.testing.assert_array_equal(_matrix(tc), _matrix(jc))
        assert _meta(tc) == _meta(jc)
        # the demo's width: 512 hash slots of Name and the other groups
        assert _matrix(tc).shape[1] > 500

    def test_sketch_kind(self, runs):
        _, t, sparse = runs
        kind = "sparse_aware" if sparse else "dense"
        assert t["kinds"][kind] > 0
        assert t["kinds"]["sparse_aware" if not sparse else "dense"] == 0

    def test_same_winner(self, runs):
        j, t, _ = runs
        assert _summary(t)["bestModelType"] == _summary(j)["bestModelType"]
        assert (_summary(t)["bestModelParams"]
                == _summary(j)["bestModelParams"])

    def test_cv_metrics(self, runs):
        j, t, _ = runs
        jr, tr = (_summary(r)["validationResults"] for r in (j, t))
        assert len(tr) == len(jr) == 5
        for a, b in zip(tr, jr):
            assert (a["modelType"], a["params"]) == (b["modelType"],
                                                    b["params"])
            np.testing.assert_allclose(a["foldValues"], b["foldValues"],
                                       rtol=0, atol=1e-4)
        assert t["selector"].metadata["group_errors"] == {}

    def test_holdout(self, runs):
        j, t, _ = runs
        assert abs(t["metrics"]["AuPR"] - j["metrics"]["AuPR"]) <= 1e-4
        assert t["metrics"]["AuPR"] > 0.6


def test_smoke_generator_is_make_titanic_like():
    """``chip_smoke.py`` builds the demo's frame without pandas: its
    columns equal ``make_titanic_like``'s."""
    sys.path.insert(0, REPO)
    import chip_smoke

    df = make_titanic_like(2000, seed=7)
    cols = chip_smoke.make_titanic(2000, seed=7)
    assert list(cols) == list(df.columns)
    for name in df.columns:
        # pandas stores the missing cabins as NaN
        want = [None if isinstance(v, float) and np.isnan(v) else v
                for v in df[name].tolist()]
        got = list(cols[name])
        if df[name].dtype.kind == "f":
            np.testing.assert_array_equal(np.asarray(got, np.float64),
                                          np.asarray(want, np.float64))
        else:
            assert [None if v is None else str(v) for v in got] == \
                [None if v is None else str(v) for v in want], name


def test_transmogrify_and_checker_at_100k():
    """transmogrify + SanityChecker on 100 000 rows of the demo's frame:
    the checked vectors, their metadata and the dropped columns equal."""
    df = titanic_frame(100_000, seed=3)
    out = []
    for pkg in (JAX, PORT):
        _, checked, _ = build_demo(pkg, with_selector=False)
        model = pkg["workflow"]().set_result_features(checked) \
            .set_input_data(df).train()
        out.append((model.train_data[checked.name],
                    checked.origin_stage.metadata["summary"]["dropped"]))
    (jc, jd), (tc, td) = out
    assert td == jd
    np.testing.assert_array_equal(_matrix(tc), _matrix(jc))
    assert _meta(tc) == _meta(jc)


@pytest.fixture(scope="module")
def artifacts(frames, runs, tmp_path_factory):
    """The demo trained in each package and saved."""
    hold = frames[1]
    root = tmp_path_factory.mktemp("titanic")
    j, t, _ = runs
    j["model"].save(str(root / "jax"))
    t["model"].save(str(root / "port"))
    return dict(jax=j, port=t, jax_path=str(root / "jax"),
                port_path=str(root / "port"), hold=hold)


def _proba(scored, pred_name):
    p = scored[pred_name].values.probability
    return p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


class TestDemoArtifacts:
    def test_jax_saved_model_scores_in_port(self, artifacts):
        j = artifacts["jax"]
        loaded = OpWorkflowModel.load(artifacts["jax_path"])
        got = _proba(loaded.score(artifacts["hold"]), j["pred"].name)
        np.testing.assert_allclose(got, _proba(j["scored"], j["pred"].name),
                                   rtol=0, atol=1e-6)

    def test_port_saved_model_scores_in_jax(self, artifacts):
        t = artifacts["port"]
        loaded = JModel.load(artifacts["port_path"])
        got = _proba(loaded.score(artifacts["hold"]), t["pred"].name)
        np.testing.assert_allclose(got, _proba(t["scored"], t["pred"].name),
                                   rtol=0, atol=1e-6)

    def test_summary_pretty_equal(self, artifacts):
        for path in (artifacts["jax_path"], artifacts["port_path"]):
            jl, tl = JModel.load(path), OpWorkflowModel.load(path)
            assert tl.summary_pretty().splitlines() == \
                jl.summary_pretty().splitlines()
        assert "Best model:" in tl.summary_pretty()

    def test_round_trip_bitwise_and_local_rows(self, artifacts):
        t = artifacts["port"]
        loaded = OpWorkflowModel.load(artifacts["port_path"])
        hold = artifacts["hold"]
        np.testing.assert_array_equal(
            _proba(loaded.score(hold), t["pred"].name),
            _proba(t["scored"], t["pred"].name))
        rows = [{k: (None if isinstance(v, float) and np.isnan(v) else v)
                 for k, v in r.items() if k != "Survived"}
                for r in hold.iloc[:16].to_dict("records")]
        local = [r[t["pred"].name]["probability_1"]
                 for r in score_function_batch(loaded)(rows)]
        np.testing.assert_allclose(
            local, _proba(t["scored"], t["pred"].name)[:16, 1],
            rtol=0, atol=1e-6)

    def test_serves_single_rows_with_text(self, artifacts):
        t = artifacts["port"]
        hold = artifacts["hold"]
        rows = [{k: (None if isinstance(v, float) and np.isnan(v) else v)
                 for k, v in r.items() if k != "Survived"}
                for r in hold.iloc[:8].to_dict("records")]
        with ModelServer.from_path(artifacts["port_path"], name="titanic",
                                   max_batch=4, warmup_row=rows[0]) as srv:
            served = [srv.score([r])[0][t["pred"].name]["probability_1"]
                      for r in rows]
        np.testing.assert_allclose(
            served, _proba(t["scored"], t["pred"].name)[:8, 1],
            rtol=0, atol=1e-6)
