"""The reference's Iris demo (``examples/op_iris_simple.py``) in the port,
against the JAX package on the CPU, and the MLP it selects among.

The Iris CSV is not in the repository, so the frame is Iris-shaped: 4
Real columns, 3 balanced classes, each class drawn from its own Gaussian
(``iris_frame``).  The port's MLP draws its initial weights from a torch
generator; the tests inject the JAX package's (``init_params`` is
patched to return ``transmogrifai_tpu.models.mlp._init_params``'s), so
both packages run the same full-batch Adam from the same start.

Tolerances, and why: Adam in float32 over a few hundred steps drifts
between the packages as their products and reductions round in another
order; measured at these sizes (300 steps at hidden layers [5, 4] and
[10]) the weights agree to 6.4e-6 and the probabilities to 1.8e-6, so
they are held within 1e-4, with the same number of steps run; the
demo's validation F1 per candidate within
1e-4, the same winner, holdout probabilities within 1e-4; a saved MLP
scores within 1e-6 in the other package.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JEvaluators
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models import mlp as jmlp
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
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
from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.models import mlp as tmlp
from transmogrifai_tpu_torch.models.classification import \
    OpLogisticRegression
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.selector.model_selector import (
    MultiClassificationModelSelector, SelectedModel, grid)
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import ColumnarDataset, FeatureColumn
from transmogrifai_tpu_torch.workflow.workflow import (OpWorkflow,
                                                       OpWorkflowModel)

COLS = ("sepalLength", "sepalWidth", "petalLength", "petalWidth")
#: per class (setosa, versicolor, virginica): the reference CSV's class
#: means and standard deviations of the four measurements
MEANS = np.array([[5.006, 3.428, 1.462, 0.246], [5.936, 2.770, 4.260, 1.326],
                  [6.588, 2.974, 5.552, 2.026]])
SDS = np.array([[0.352, 0.379, 0.174, 0.105], [0.516, 0.314, 0.470, 0.198],
                [0.636, 0.322, 0.552, 0.275]])


def iris_frame(n, seed):
    """(X (n, 4), y (n,)): three balanced classes, each row drawn from its
    class's diagonal Gaussian."""
    rng = np.random.default_rng(seed)
    y = np.arange(n) % 3
    rng.shuffle(y)
    X = MEANS[y] + SDS[y] * rng.normal(size=(n, 4))
    return X, y.astype(np.float64)


def _jax_init(sizes, seed, device):
    """The JAX package's initial weights, as the port's tensors."""
    return [(torch.from_numpy(np.array(W)).to(device),
             torch.from_numpy(np.array(b)).to(device))
            for W, b in jmlp._init_params(jax.random.PRNGKey(seed), sizes)]


# ---------------------------------------------------------------------------
# the MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hidden", [(5, 4), (10,)])
def test_fit_mlp_matches_jax(hidden):
    """``fit_mlp`` from the JAX package's initial weights: the same number
    of Adam steps, weights within 1e-4, probabilities within 1e-4."""
    X, y = iris_frame(600, 1)
    X = ((X - X.mean(0)) / X.std(0)).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[y.astype(int)]
    w = (np.arange(600) % 4 != 0).astype(np.float32)
    sizes = (4, *hidden, 3)
    kw = dict(max_iter=300, tol=1e-6, step_size=0.1)
    jp, jn, jloss = jmlp.fit_mlp(X, Y, w, sizes, seed=42, **kw)
    net, tn, tloss = tmlp.fit_mlp(
        *(torch.from_numpy(a) for a in (X, Y, w)),
        _jax_init(sizes, 42, "cpu"), **kw)
    assert tn == int(jn)
    assert abs(tloss - float(jloss)) <= 1e-5
    for (Wj, bj), Wt, bt in zip(jp, net.W, net.b):
        np.testing.assert_allclose(Wt.detach().numpy(), np.asarray(Wj),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(bt.detach().numpy(), np.asarray(bj),
                                   rtol=0, atol=1e-4)
    pj = np.asarray(jax.nn.softmax(jmlp._forward(jp, X), axis=1))
    with torch.no_grad():
        pt = torch.softmax(net(torch.from_numpy(X)), 1).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)


def test_mlp_estimator_matches_jax(monkeypatch):
    """``OpMultilayerPerceptronClassifier.fit_raw`` on raw inputs with row
    weights: the standardization, the steps run and the probabilities
    (1e-4) of the JAX estimator; argmax predictions."""
    X, y = iris_frame(900, 2)
    X = X.astype(np.float32)
    w = (np.arange(900) % 3 != 0).astype(np.float32)
    kw = dict(hidden_layers=[5, 4], max_iter=300, step_size=0.1)
    jm = jmlp.OpMultilayerPerceptronClassifier(**kw).fit_raw(X, y, w)
    monkeypatch.setattr(tmlp, "init_params", _jax_init)
    est = tmlp.OpMultilayerPerceptronClassifier(**kw)
    tmod = est.fit_raw(X, y, w, device="cpu")
    np.testing.assert_allclose(tmod.mu.numpy(), np.asarray(jm.mu),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tmod.sigma.numpy(), np.asarray(jm.sigma),
                               rtol=1e-5)
    assert 0 < est.metadata["n_iter"] <= 300
    jb = jm.predict_batch(X)
    tb = tmod.predict_batch(torch.from_numpy(X))
    np.testing.assert_allclose(tb.probability.numpy(),
                               np.asarray(jb.probability), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tb.prediction.numpy(),
                                  tb.probability.argmax(1).numpy())


def test_mlp_layers_spec():
    """Spark's ``layers`` spec is checked against the data: its input
    width must match, and it may declare more classes than the labels
    hold (the softmax head keeps them)."""
    X, y = iris_frame(90, 3)
    with pytest.raises(ValueError, match="input dim"):
        tmlp.OpMultilayerPerceptronClassifier(layers=[5, 3, 3]).fit_raw(
            X, y, device="cpu")
    with pytest.raises(ValueError, match="declare"):
        tmlp.OpMultilayerPerceptronClassifier(layers=[4, 3, 2]).fit_raw(
            X, y, device="cpu")
    m = tmlp.OpMultilayerPerceptronClassifier(
        layers=[4, 6, 4], max_iter=5).fit_raw(X, y, device="cpu")
    assert m.predict_batch(torch.from_numpy(X)).probability.shape == (90, 4)


def test_convert_mlp_model():
    """``convert.mlp_model`` carries the JAX package's fitted layers and
    standardization: the same probabilities (1e-6)."""
    X, y = iris_frame(300, 4)
    X = X.astype(np.float32)
    jm = jmlp.OpMultilayerPerceptronClassifier(
        hidden_layers=[10], max_iter=50).fit_raw(X, y)
    tm = convert.mlp_model(jm.weights, np.asarray(jm.mu),
                           np.asarray(jm.sigma), device="cpu")
    np.testing.assert_allclose(
        tm.predict_batch(torch.from_numpy(X)).probability.numpy(),
        np.asarray(jm.predict_batch(X).probability), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the demo's DAG end to end
# ---------------------------------------------------------------------------

def _dataset(cls_ds, cls_col, types, X, y):
    cols = {c: cls_col.from_values(types.Real, X[:, j])
            for j, c in enumerate(COLS)}
    cols["label"] = cls_col.from_values(types.RealNN, y)
    return cls_ds(cols)


def build_demo(port: bool):
    """``examples/op_iris_simple.py``'s DAG with either package's imports:
    4 Reals -> transmogrify -> SanityChecker -> the multiclass selector
    on a stratified train/validation split over LR {0.01, 0.1} and the
    MLP at hidden layers [5, 4] and [10] (300 steps of 0.1)."""
    if port:
        fb, tm_, checker, sel_cls, lr, mlp, g = (
            FeatureBuilder, transmogrify, SanityChecker,
            MultiClassificationModelSelector, OpLogisticRegression,
            tmlp.OpMultilayerPerceptronClassifier, grid)
    else:
        fb, tm_, checker, sel_cls, lr, mlp, g = (
            JFB, jtransmogrify, JSanityChecker, JMCMS, JLR,
            jmlp.OpMultilayerPerceptronClassifier, jgrid)
    label = fb.RealNN("label").as_response()
    predictors = [fb.Real(c).as_predictor() for c in COLS]
    features = tm_(predictors)
    checked = checker().set_input(label, features).get_output()
    sel = sel_cls.with_train_validation_split(
        models_and_parameters=[
            (lr(), g(reg_param=[0.01, 0.1])),
            (mlp(max_iter=300, step_size=0.1),
             g(hidden_layers=[[5, 4], [10]])),
        ])
    prediction = sel.set_input(label, checked).get_output()
    return prediction, label, sel


@pytest.fixture(scope="module")
def demo_runs():
    train, hold = iris_frame(1500, 13), iris_frame(600, 14)
    out = {}
    for port in (False, True):
        prediction, label, sel = build_demo(port)
        if port:
            tt.set_device("cpu")
            data = _dataset(ColumnarDataset, FeatureColumn, ft, *train)
            hdata = _dataset(ColumnarDataset, FeatureColumn, ft, *hold)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tmlp, "init_params", _jax_init)
                model = OpWorkflow().set_result_features(
                    prediction, label).set_input_data(data).train()
            ev = Evaluators.MultiClassification.f1()
        else:
            data = _dataset(JDataset, JColumn, jft, *train)
            hdata = _dataset(JDataset, JColumn, jft, *hold)
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("TMOG_COST_HISTORY", "0")
                mp.setenv("TMOG_SYNC_SWEEP", "1")
                model = JWorkflow().set_result_features(
                    prediction, label).set_input_data(data).train()
            ev = JEvaluators.MultiClassification.f1()
        scored, metrics = model.score_and_evaluate(ev, data=hdata)
        out[port] = dict(model=model, pred=prediction, sel=sel,
                         scored=scored, metrics=metrics, hold=hdata)
    return out


def _summary(run):
    return run["sel"].metadata["model_selector_summary"]


class TestIrisDemo:
    def test_split_and_summary(self, demo_runs):
        j, t = _summary(demo_runs[False]), _summary(demo_runs[True])
        assert set(t) == set(j)
        assert t["validationType"] == "OpTrainValidationSplit"
        assert t["dataPrepResults"] == j["dataPrepResults"]
        assert t["dataPrepResults"]["labelsKept"] == [0.0, 1.0, 2.0]
        assert len(t["validationResults"]) == 4

    def test_same_winner_and_validation_f1(self, demo_runs):
        j, t = _summary(demo_runs[False]), _summary(demo_runs[True])
        assert (t["bestModelType"], t["bestModelParams"]) == (
            j["bestModelType"], j["bestModelParams"])
        for a, b in zip(t["validationResults"], j["validationResults"]):
            assert (a["modelType"], a["params"]) == (b["modelType"],
                                                    b["params"])
            assert abs(a["metricValue"] - b["metricValue"]) <= 1e-4
        families = {r["modelType"] for r in t["validationResults"]}
        assert families == {"OpLogisticRegression",
                            "OpMultilayerPerceptronClassifier"}
        meta = demo_runs[True]["sel"].metadata
        assert "SoftmaxGridGroup" in meta["sweep_seconds"]
        assert meta["group_errors"] == {}

    def test_holdout(self, demo_runs):
        """Holdout probabilities within 1e-4 and F1 within 1e-3.  At
        1 500 rows the sample correlation of petalLength with the label
        index passes the checker's 0.95 (0.948 in the population, as in
        the reference CSV), so both packages' checkers drop both petal
        columns here and F1 sits near 0.76."""
        j, t = demo_runs[False], demo_runs[True]
        jp = np.asarray(j["scored"][j["pred"].name].values.probability)
        tp = t["scored"][t["pred"].name].values.probability.numpy()
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
        assert t["metrics"]["F1"] == pytest.approx(j["metrics"]["F1"],
                                                   abs=1e-3)
        assert t["metrics"]["F1"] > 0.7
        dropped = next(s for s in t["model"].stages
                       if type(s).__name__ == "SanityCheckerModel"
                       ).metadata["summary"]["dropped"]
        jdropped = next(s for s in j["model"].stages
                        if type(s).__name__ == "SanityCheckerModel"
                        ).metadata["summary"]["dropped"]
        assert dropped == jdropped and "petalWidth_6" in dropped

    def test_mlp_round_trip_both_ways(self, demo_runs, tmp_path):
        """The demo's MLP candidate as the only family: saved by the
        port, loaded by the JAX package (and back), scores within 1e-6."""
        tt.set_device("cpu")
        X, y = iris_frame(600, 15)
        label = FeatureBuilder.RealNN("label").as_response()
        checked = SanityChecker().set_input(
            label, transmogrify([FeatureBuilder.Real(c).as_predictor()
                                 for c in COLS])).get_output()
        sel = MultiClassificationModelSelector.with_train_validation_split(
            models_and_parameters=[(tmlp.OpMultilayerPerceptronClassifier(
                max_iter=60, step_size=0.1), grid(hidden_layers=[[5, 4]]))])
        pred = sel.set_input(label, checked).get_output()
        model = OpWorkflow().set_result_features(pred).set_input_data(
            _dataset(ColumnarDataset, FeatureColumn, ft, X, y)).train()
        path = str(tmp_path / "mlp")
        model.save(path)
        want = model.score(demo_runs[True]["hold"])[pred.name].values
        loaded = OpWorkflowModel.load(path)
        inner = next(s for s in loaded.stages
                     if isinstance(s, SelectedModel)).inner
        assert type(inner).__name__ == "MLPClassificationModel"
        again = loaded.score(demo_runs[True]["hold"])[pred.name].values
        assert torch.equal(again.probability, want.probability)
        back = JWorkflowModel.load(path).score(
            demo_runs[False]["hold"])[pred.name].values
        np.testing.assert_allclose(np.asarray(back.probability),
                                   want.probability.numpy(), rtol=0,
                                   atol=1e-6)


_ISOLATED = r"""
import sys
for k in [k for k in sys.modules if k == "jax" or k.startswith("jax.")]:
    del sys.modules[k]


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "transmogrifai_tpu.")) \
                or name == "transmogrifai_tpu":
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, _Block())
import numpy as np
import torch
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.models.classification import OpLogisticRegression
from transmogrifai_tpu_torch.models.mlp import \
    OpMultilayerPerceptronClassifier
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.selector.model_selector import (
    MultiClassificationModelSelector, grid)
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import ColumnarDataset, FeatureColumn
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

rng = np.random.default_rng(0)
X = rng.normal(size=(600, 4))
y = (X[:, 0] > 0.5).astype(float) + (X[:, 1] > 0).astype(float)
data = ColumnarDataset({**{f"x{j}": FeatureColumn.from_values(ft.Real, X[:, j])
                           for j in range(4)},
                        "label": FeatureColumn.from_values(ft.RealNN, y)})
label = FeatureBuilder.RealNN("label").as_response()
vec = transmogrify([FeatureBuilder.Real(f"x{j}").as_predictor()
                    for j in range(4)])
for factory in (MultiClassificationModelSelector.with_cross_validation,
                MultiClassificationModelSelector.with_train_validation_split):
    sel = factory(models_and_parameters=[
        (OpLogisticRegression(), grid(reg_param=[0.01])),
        (OpRandomForestClassifier(), grid(num_trees=[2], max_depth=[3])),
        (OpMultilayerPerceptronClassifier(max_iter=20), grid())])
    pred = label.transform_with(sel, SanityChecker().set_input(
        label, vec).get_output())
    wf = OpWorkflow(device="cpu").set_result_features(pred).set_input_data(
        data)
    m = wf.train()
    _, metrics = m.score_and_evaluate(Evaluators.MultiClassification.f1(),
                                      data=data)
    assert metrics["F1"] > 0.5, metrics
    assert len(sel.metadata["model_selector_summary"][
        "validationResults"]) == 3
assert not any(k == "jax" or k.startswith(("jax.", "transmogrifai_tpu."))
               for k, v in sys.modules.items() if v is not None)
if not torch.cuda.is_available():
    try:
        OpWorkflow().set_result_features(pred).set_input_data(data).train()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("the multiclass train ran without a card")
print("OK")
"""


def test_multiclass_path_runs_with_jax_blocked():
    """The multiclass path (both validators, LR, forests, the MLP)
    imports nothing of JAX, and its train raises without a card unless
    asked for the CPU."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _ISOLATED],
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")
