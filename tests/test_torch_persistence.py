"""Saved models across the two packages, on the CPU.

One format serves both: the port writes the JAX package's class paths and
reads them back through its class map.  Held here: the committed
``model_v1`` artifact scores to its frozen expectations in the port
(within 1e-5, as ``tests/test_backcompat.py`` holds the JAX package), and
so does ``model_v2`` (an MLP and a forest blended by the combiner); a
class the port lacks is named with its ROADMAP item; workflows trained and
saved by the JAX package load in the port, and the port's load in the JAX
package, with tree ``feat``/``thresh`` equal exactly and probabilities
within 1e-6 (a boosted model: the same trees summed in another order) or
1e-5 (a selected model: a logistic margin or a forest's mean, in another
order and another ``exp``); a port save/load round trip scores bitwise
equal; the selector's summary survives; overwrite protection and the
train-time serializability gate.  Inputs are numpy-seeded.
"""
import csv
import os

import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
from transmogrifai_tpu.models.trees import OpRandomForestClassifier as JRF
from transmogrifai_tpu.models.trees import OpXGBoostClassifier as JXGB
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JSanityChecker
from transmogrifai_tpu.selector.model_selector import \
    BinaryClassificationModelSelector as JBCMS
from transmogrifai_tpu.selector.model_selector import grid as jgrid
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import ColumnarDataset as JDataset
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu.workflow.workflow import \
    OpWorkflowModel as JWorkflowModel
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.local import load_model_local, score_function
from transmogrifai_tpu_torch.models.classification import \
    OpLogisticRegression
from transmogrifai_tpu_torch.models.trees import (OpRandomForestClassifier,
                                                  OpXGBoostClassifier,
                                                  TreeEnsembleModel)
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.readers.files import CSVReader
from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, SelectedModel, grid)
from transmogrifai_tpu_torch.serving import ModelRegistry, ModelServer
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import ColumnarDataset, FeatureColumn
from transmogrifai_tpu_torch.workflow import persistence
from transmogrifai_tpu_torch.workflow.workflow import (OpWorkflow,
                                                       OpWorkflowModel)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MODEL_V1 = os.path.join(FIXTURES, "model_v1")
N_REAL = 6
#: tolerances by the model a workflow ends in
TOL = {"xgb": 1e-6, "lr_rf": 1e-5, "rf": 1e-5}


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


def _make(n, seed):
    """Reals (some NaN), one PickList and a binary label with signal on
    two reals and the category."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, N_REAL))
    X[rng.random((n, N_REAL)) < 0.08] = np.nan
    cat = rng.choice(np.array(["red", "green", "blue", None], dtype=object),
                     size=n, p=[0.45, 0.3, 0.2, 0.05])
    z = (1.2 * np.nan_to_num(X[:, 0]) - 0.8 * np.nan_to_num(X[:, 3])
         + 0.6 * (cat == "red") + 0.5 * rng.normal(size=n))
    return X, list(cat), (z > 0.2).astype(np.float64)


def _dataset(cls_ds, cls_col, types, X, cat, y):
    cols = {f"x{j}": cls_col.from_values(types.Real, X[:, j])
            for j in range(N_REAL)}
    cols["color"] = cls_col.from_values(types.PickList, cat)
    cols["label"] = cls_col.from_values(types.RealNN, y)
    return cls_ds(cols)


def _final_stage(kind, jax: bool):
    """The workflow's last estimator: a boosted model, or a selector over
    a small LR + RF grid, or over the RF alone (so a forest wins)."""
    if kind == "xgb":
        return (JXGB if jax else OpXGBoostClassifier)(
            max_depth=3, num_round=8, early_stopping_rounds=0)
    lr, rf, bcms, g = ((JLR, JRF, JBCMS, jgrid) if jax else
                       (OpLogisticRegression, OpRandomForestClassifier,
                        BinaryClassificationModelSelector, grid))
    models = [(rf(), g(num_trees=[5], max_depth=[3]))]
    if kind == "lr_rf":
        models.insert(0, (lr(), g(reg_param=[0.01])))
    return bcms.with_cross_validation(num_folds=3,
                                      models_and_parameters=models)


def _train(kind, jax: bool, data):
    fb, trans, checker, wf, ds, col, types = (
        (JFB, jtransmogrify, JSanityChecker, JWorkflow, JDataset, JColumn,
         jft) if jax else
        (FeatureBuilder, transmogrify, SanityChecker, OpWorkflow,
         ColumnarDataset, FeatureColumn, ft))
    label = fb.RealNN("label").as_response()
    preds = ([fb.Real(f"x{j}").as_predictor() for j in range(N_REAL)]
             + [fb.PickList("color").as_predictor()])
    checked = label.transform_with(checker(max_correlation=0.99),
                                   trans(preds))
    est = _final_stage(kind, jax)
    pred = label.transform_with(est, checked)
    model = wf().set_result_features(pred).set_input_data(
        _dataset(ds, col, types, *data)).train()
    return model, est


def _proba_port(model, data):
    scored = model.score(_dataset(ColumnarDataset, FeatureColumn, ft, *data))
    name = model.result_features[0].name
    return scored[name].values.probability[:, 1].numpy()


def _proba_jax(model, data):
    scored = model.score(_dataset(JDataset, JColumn, jft, *data))
    name = model.result_features[0].name
    return np.asarray(scored[name].values.probability[:, 1])


def _trees(model):
    """(feat, thresh) of every tree ensemble in a model, as numpy."""
    out = []
    for s in model.stages:
        m = getattr(s, "inner", s)
        if type(m).__name__ == "TreeEnsembleModel":
            out.append((np.asarray(m.feat), np.asarray(m.thresh)))
    return out


@pytest.fixture(scope="module")
def data():
    return _make(1500, 31), _make(400, 32)


@pytest.fixture(scope="module")
def jax_artifacts(data, tmp_path_factory):
    """Each kind trained and saved by the JAX package."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMOG_COST_HISTORY", "0")
        for kind in TOL:
            model, _ = _train(kind, True, data[0])
            path = str(tmp_path_factory.mktemp(f"jax_{kind}") / "m")
            model.save(path)
            out[kind] = (model, path)
    return out


@pytest.fixture(scope="module")
def port_artifacts(data, tmp_path_factory):
    """Each kind trained and saved by the port."""
    tt.set_device("cpu")
    out = {}
    for kind in TOL:
        model, est = _train(kind, False, data[0])
        path = str(tmp_path_factory.mktemp(f"port_{kind}") / "m")
        model.save(path)
        out[kind] = (model, est, path)
    return out


def _v1_dataset():
    with open(os.path.join(FIXTURES, "model_v1_input.csv")) as f:
        rows = list(csv.DictReader(f))
    return ColumnarDataset({
        "label": FeatureColumn.from_values(
            ft.RealNN, [float(r["label"]) for r in rows]),
        "x": FeatureColumn.from_values(ft.Real, [r["x"] for r in rows]),
        "cat": FeatureColumn.from_values(ft.PickList,
                                         [r["cat"] for r in rows])})


class TestCommittedArtifacts:
    def test_model_v1_scores_to_expected(self):
        model = OpWorkflowModel.load(MODEL_V1)
        expected = np.load(os.path.join(FIXTURES, "model_v1_expected.npy"))
        name = model.result_features[0].name
        for data in (_v1_dataset(),
                     CSVReader(os.path.join(FIXTURES,
                                            "model_v1_input.csv"))):
            got = model.score(data)[name].values.probability[:, 1]
            np.testing.assert_allclose(got.numpy(), expected, atol=1e-5)
        fn = score_function(load_model_local(MODEL_V1))
        with open(os.path.join(FIXTURES, "model_v1_input.csv")) as f:
            rows = list(csv.DictReader(f))
        for i, r in enumerate(rows[:8]):
            (pred,) = fn({"x": float(r["x"]), "cat": r["cat"]}).values()
            assert abs(pred["probability_1"] - expected[i]) < 1e-5

    def test_model_v1_state_reads_jax_forms(self):
        model = OpWorkflowModel.load(MODEL_V1)
        sel = next(s for s in model.stages if isinstance(s, SelectedModel))
        # model_v1's coef is a plain JSON list; it loads as float32
        assert sel.inner.coef.dtype == torch.float32
        assert sel.inner.coef.device.type == "cpu"
        checker = next(s for s in model.stages
                       if type(s).__name__ == "SanityCheckerModel")
        assert checker.keep_indices == [0, 2, 3]
        assert checker.new_vmeta.column_names() == [
            "x_0", "cat_cat_b_1", "cat_cat_a_2"]

    def test_model_v2_names_what_is_not_ported(self, tmp_path):
        """model_v2 with its combiner's record renamed to a JAX class the
        port lacks: the load names that class and its ROADMAP item, and
        nothing the port has (the MLP, the forest, the combiner)."""
        import json
        import shutil

        path = str(tmp_path / "m")
        shutil.copytree(os.path.join(FIXTURES, "model_v2"), path)
        with open(os.path.join(path, "op-model.json")) as f:
            doc = json.load(f)
        assert doc["stages"][-1]["className"] == \
            "transmogrifai_tpu.selector.combiner.SelectedCombinerModel"
        doc["stages"][-1]["className"] = (
            "transmogrifai_tpu.ops.map_vectorizers."
            "GeolocationMapVectorizerModel")
        with open(os.path.join(path, "op-model.json"), "w") as f:
            json.dump(doc, f)
        with pytest.raises(NotImplementedError) as err:
            OpWorkflowModel.load(path)
        msg = str(err.value)
        assert "GeolocationMapVectorizerModel" in msg
        assert "ROADMAP Queue A item 6" in msg
        for ported in ("MLPClassificationModel", "TreeEnsembleModel",
                       "SelectedCombinerModel"):
            assert ported not in msg

    def test_model_v2_scores_to_expected(self):
        """The committed model_v2 (two selectors, an MLP and a forest,
        blended by SelectedCombinerModel) scores its input within 1e-5 of
        its frozen expectations, through the workflow and the local
        scorer."""
        model = OpWorkflowModel.load(os.path.join(FIXTURES, "model_v2"))
        expected = np.load(os.path.join(FIXTURES, "model_v2_expected.npy"))
        name = model.result_features[0].name
        comb = model.get_fitted_stage("SelectedCombinerModel")
        assert comb.get_output().name == name
        assert (comb.strategy, comb.metric) == ("weighted", "AuPR")
        assert [f.origin_stage.uid for f in comb.input_features[1:]] == [
            "ModelSelector_000000000017", "ModelSelector_00000000001a"]
        got = model.score(CSVReader(os.path.join(
            FIXTURES, "model_v2_input.csv")))[name].values.probability
        np.testing.assert_allclose(got[:, 1].numpy(), expected, rtol=0,
                                   atol=1e-5)
        fn = score_function(load_model_local(os.path.join(FIXTURES,
                                                          "model_v2")))
        with open(os.path.join(FIXTURES, "model_v2_input.csv")) as f:
            rows = list(csv.DictReader(f))
        for i, r in enumerate(rows[:8]):
            row = {k: (r[k] if k == "cat" else float(r[k]))
                   for k in ("x0", "x1", "x2", "x3", "cat")}
            assert abs(fn(row)[name]["probability_1"] - expected[i]) < 1e-5

    def test_unported_tree_mode_names_its_item(self, tmp_path):
        import json
        import shutil

        path = str(tmp_path / "m")
        shutil.copytree(MODEL_V1, path)
        with open(os.path.join(path, "op-model.json")) as f:
            doc = json.load(f)
        doc["stages"][-1]["params"]["inner"] = {"__stage__": {
            "className": "transmogrifai_tpu.models.trees.TreeEnsembleModel",
            "uid": "TreeEnsembleModel_1", "params": {"mode": "gbdt_rank"}}}
        with open(os.path.join(path, "op-model.json"), "w") as f:
            json.dump(doc, f)
        # every mode the JAX package writes loads (gbdt_multi too); a mode
        # the port lacks names the tree family's item
        with pytest.raises(NotImplementedError,
                           match="'gbdt_rank'.*Queue A item 3"):
            OpWorkflowModel.load(path)

    def test_class_map_paths_are_jax_classes(self):
        import importlib

        for path, cls in persistence.CLASS_MAP.items():
            mod, _, name = path.rpartition(".")
            jcls = getattr(importlib.import_module(mod), name)
            assert jcls.__name__ == cls.__name__


class TestJaxArtifactsInThePort:
    @pytest.mark.parametrize("kind", list(TOL))
    def test_loads_with_exact_trees_and_close_scores(self, kind, data,
                                                     jax_artifacts):
        jmodel, path = jax_artifacts[kind]
        model = OpWorkflowModel.load(path)
        jt, pt = _trees(jmodel), _trees(model)
        assert len(jt) == len(pt)
        for (jf, jth), (pf, pth) in zip(jt, pt):
            assert pf.dtype == np.int32 and pth.dtype == np.int32
            np.testing.assert_array_equal(pf, jf)
            np.testing.assert_array_equal(pth, jth)
        np.testing.assert_allclose(_proba_port(model, data[1]),
                                   _proba_jax(jmodel, data[1]),
                                   rtol=0, atol=TOL[kind])

    def test_selector_metadata_survives(self, jax_artifacts):
        jmodel, path = jax_artifacts["lr_rf"]
        model = OpWorkflowModel.load(path)
        got = next(s for s in model.stages
                   if isinstance(s, SelectedModel)).metadata
        want = next(s for s in jmodel.stages
                    if type(s).__name__ == "SelectedModel").metadata
        assert (got["model_selector_summary"]["bestModelType"]
                == want["model_selector_summary"]["bestModelType"])
        assert (len(got["model_selector_summary"]["validationResults"])
                == len(want["model_selector_summary"]["validationResults"]))


class TestPortArtifactsInJax:
    @pytest.mark.parametrize("kind", list(TOL))
    def test_jax_loads_port_artifact(self, kind, data, port_artifacts):
        model, _, path = port_artifacts[kind]
        jmodel = JWorkflowModel.load(path)
        for (pf, pth), (jf, jth) in zip(_trees(model), _trees(jmodel)):
            np.testing.assert_array_equal(np.asarray(jf), pf)
            np.testing.assert_array_equal(np.asarray(jth), pth)
        assert len(_trees(model)) == len(_trees(jmodel))
        np.testing.assert_allclose(_proba_jax(jmodel, data[1]),
                                   _proba_port(model, data[1]),
                                   rtol=0, atol=TOL[kind])

    def test_port_artifact_writes_jax_paths_and_no_device(self,
                                                          port_artifacts):
        import json

        _, _, path = port_artifacts["lr_rf"]
        with open(os.path.join(path, "op-model.json")) as f:
            doc = json.load(f)
        assert doc["version"] == persistence.FORMAT_VERSION
        assert doc["versionInfo"]["torch_version"] == torch.__version__

        def walk(rec):
            assert rec["className"].startswith("transmogrifai_tpu.")
            assert rec["className"] in persistence.CLASS_MAP
            assert "device" not in rec["params"]
            inner = rec["params"].get("inner")
            if inner:
                walk(inner["__stage__"])

        for rec in doc["stages"]:
            walk(rec)
        kinds = {}
        for _, _, p in port_artifacts.values():
            with np.load(os.path.join(p, "arrays.npz")) as arrays:
                kinds.update({k.rsplit(".", 1)[1]: arrays[k].dtype
                              for k in arrays.files})
        assert kinds.get("coef") == np.float32
        assert kinds.get("feat") == np.int32
        assert kinds.get("thresh") == np.int32
        assert kinds.get("leaf") == np.float32
        assert kinds.get("edges") == np.float32


class TestPortRoundTrip:
    @pytest.mark.parametrize("kind", list(TOL))
    def test_round_trip_is_bitwise(self, kind, data, port_artifacts):
        model, _, path = port_artifacts[kind]
        loaded = OpWorkflowModel.load(path)
        assert np.array_equal(_proba_port(loaded, data[1]),
                              _proba_port(model, data[1]))
        for (a, b), (c, d) in zip(_trees(model), _trees(loaded)):
            assert np.array_equal(a, c) and np.array_equal(b, d)

    def test_selector_summary_survives(self, port_artifacts):
        _, est, path = port_artifacts["lr_rf"]
        loaded = OpWorkflow().load_model(path)
        meta = next(s for s in loaded.stages
                    if isinstance(s, SelectedModel)).metadata
        assert meta["model_selector_summary"] == \
            est.metadata["model_selector_summary"]

    def test_overwrite_protection(self, port_artifacts, tmp_path):
        model, _, _ = port_artifacts["xgb"]
        path = str(tmp_path / "m")
        model.save(path)
        with pytest.raises(FileExistsError):
            model.save(path, overwrite=False)
        model.save(path)   # overwrite=True replaces it
        assert isinstance(OpWorkflowModel.load(path).stages[-1],
                          TreeEnsembleModel)


class TestSerializabilityGate:
    def _workflow(self, data):
        label = FeatureBuilder.RealNN("label").as_response()
        x0 = FeatureBuilder.Real("x0").extract(
            lambda r: r["x0"]).as_predictor()
        x1 = FeatureBuilder.Real("x1").as_predictor()
        pred = label.transform_with(
            OpLogisticRegression(), transmogrify([x0, x1]))
        rows = [{"x0": float(a), "x1": float(b), "label": float(c)}
                for a, b, c in zip(data[0][0][:200, 0], data[0][0][:200, 1],
                                   data[0][2][:200])]
        return OpWorkflow().set_result_features(pred).set_input_data(rows)

    def test_lambda_extract_fails_train_with_actionable_error(self, data):
        with pytest.raises(ValueError, match=r"(?s)extract_fn.*allow_non_serializable"):
            self._workflow(data).train()

    def test_opt_out_trains_and_saving_stubs(self, data, tmp_path):
        model = self._workflow(data).allow_non_serializable().train()
        with pytest.warns(UserWarning, match="non-serializable callable"):
            model.save(str(tmp_path / "m"))


class TestDeviceRule:
    """With no card and no request for the CPU, every entry point that
    loads a model raises instead of running on the CPU."""

    @pytest.mark.parametrize("entry", [
        lambda: OpWorkflowModel.load(MODEL_V1),
        lambda: OpWorkflow().load_model(MODEL_V1),
        lambda: load_model_local(MODEL_V1),
        lambda: ModelRegistry().load("m", MODEL_V1),
        lambda: ModelServer.from_path(MODEL_V1, name="m"),
    ], ids=["load", "load_model", "load_model_local", "registry_load",
            "from_path"])
    def test_no_card_raises(self, entry, monkeypatch):
        from transmogrifai_tpu_torch import device

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(device, "_default", "cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()

    def test_explicit_cpu_loads(self, monkeypatch):
        from transmogrifai_tpu_torch import device

        monkeypatch.setattr(device, "_default", "cuda")
        model = OpWorkflowModel.load(MODEL_V1, device="cpu")
        sel = next(s for s in model.stages if isinstance(s, SelectedModel))
        assert sel.inner.coef.device.type == "cpu"


def test_port_and_smoke_import_no_jax():
    """The port and ``chip_smoke.py`` import neither JAX nor the JAX
    package (class paths in ``CLASS_MAP`` are strings, not imports)."""
    import ast

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(repo, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(repo,
                                               "transmogrifai_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    and node.level == 0 else [])
            bad += [f"{path}: {m}" for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib",
                                           "transmogrifai_tpu")]
    assert len(files) > 30 and not bad, bad


def _chunked(pkg: str, data, nb: bool = False):
    """A chunked train (64-row chunks) of the test's DAG ending in LR, or
    in naive Bayes (whose state holds the card's sums in the port): the
    model, its streamed fit states by uid."""
    from transmogrifai_tpu.models.classification import OpNaiveBayes as JNB
    from transmogrifai_tpu.utils.uid import reset_uids as jreset
    from transmogrifai_tpu_torch.models.classification import OpNaiveBayes
    from transmogrifai_tpu_torch.utils.uid import reset_uids

    jax = pkg == "jax"
    (jreset if jax else reset_uids)()
    fb, trans, checker, wf, ds, col, types = (
        (JFB, jtransmogrify, JSanityChecker, JWorkflow, JDataset, JColumn,
         jft) if jax else
        (FeatureBuilder, transmogrify, SanityChecker, OpWorkflow,
         ColumnarDataset, FeatureColumn, ft))
    label = fb.RealNN("label").as_response()
    preds = ([fb.Real(f"x{j}").as_predictor() for j in range(N_REAL)]
             + [fb.PickList("color").as_predictor()])
    checked = label.transform_with(checker(max_correlation=0.99),
                                   trans(preds))
    est = ((JNB if jax else OpNaiveBayes)() if nb
           else (JLR if jax else OpLogisticRegression)())
    pred = label.transform_with(est, checked)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMOG_COST_HISTORY", "0")
        model = wf().set_result_features(pred).set_input_data(
            _dataset(ds, col, types, *data)).train(chunk_rows=64)
    return model


def _encoded(fit_states, encode, store):
    return {uid: encode(p, f"fitstate.{uid}", store)
            for uid, p in fit_states.items()}


class TestFitStates:
    """A chunked model's ``fit_states`` through save and load, in either
    direction between the packages: the same uids, the same JSON and the
    same ``fitstate.<uid>...`` array keys in arrays.npz, the arrays
    bitwise."""

    @pytest.mark.parametrize("nb", [False, True], ids=["lr", "nb"])
    def test_port_round_trip_keeps_fit_states(self, data, tmp_path, nb):
        from transmogrifai_tpu_torch.workflow.checkpoint import \
            encode_fit_state
        from transmogrifai_tpu_torch.workflow.persistence import _ArrayStore

        model = _chunked("port", data[0], nb=nb)
        assert model.fit_states
        path = str(tmp_path / "m")
        model.save(path)
        loaded = OpWorkflowModel.load(path, device="cpu")
        assert set(loaded.fit_states) == set(model.fit_states)
        a, b = _ArrayStore(), _ArrayStore()
        assert (_encoded(model.fit_states, encode_fit_state, a)
                == _encoded(loaded.fit_states, encode_fit_state, b))
        assert sorted(a.arrays) == sorted(b.arrays)
        for k in a.arrays:
            np.testing.assert_array_equal(a.arrays[k], b.arrays[k])
        with np.load(os.path.join(path, "arrays.npz")) as z:
            keys = [k for k in z.files if k.startswith("fitstate.")]
        assert sorted(keys) == sorted(a.arrays)

    @pytest.mark.parametrize("nb", [False, True], ids=["lr", "nb"])
    def test_jax_saved_fit_states_load_in_the_port(self, data, tmp_path,
                                                   nb):
        from transmogrifai_tpu.workflow.checkpoint import \
            encode_fit_state as jencode
        from transmogrifai_tpu.workflow.persistence import \
            _ArrayStore as JStore
        from transmogrifai_tpu_torch.workflow.checkpoint import \
            encode_fit_state
        from transmogrifai_tpu_torch.workflow.persistence import _ArrayStore

        jmodel = _chunked("jax", data[0], nb=nb)
        path = str(tmp_path / "m")
        jmodel.save(path)
        loaded = OpWorkflowModel.load(path, device="cpu")
        assert set(loaded.fit_states) == set(jmodel.fit_states)
        a, b = JStore(), _ArrayStore()
        assert (_encoded(jmodel.fit_states, jencode, a)
                == _encoded(loaded.fit_states, encode_fit_state, b))
        assert sorted(a.arrays) == sorted(b.arrays)
        for k in a.arrays:
            np.testing.assert_array_equal(a.arrays[k], b.arrays[k])
        # and the port's own chunked train writes the same keys
        port = _chunked("port", data[0], nb=nb)
        c = _ArrayStore()
        _encoded(port.fit_states, encode_fit_state, c)
        assert sorted(c.arrays) == sorted(a.arrays)

    @pytest.mark.parametrize("nb", [False, True], ids=["lr", "nb"])
    def test_port_saved_fit_states_load_in_jax(self, data, tmp_path, nb):
        from transmogrifai_tpu.workflow.checkpoint import \
            encode_fit_state as jencode
        from transmogrifai_tpu.workflow.persistence import \
            _ArrayStore as JStore
        from transmogrifai_tpu.workflow.persistence import \
            load_workflow_model as jload
        from transmogrifai_tpu_torch.workflow.checkpoint import \
            encode_fit_state
        from transmogrifai_tpu_torch.workflow.persistence import _ArrayStore

        model = _chunked("port", data[0], nb=nb)
        path = str(tmp_path / "m")
        model.save(path)
        jloaded = jload(path)
        assert set(jloaded.fit_states) == set(model.fit_states)
        a, b = _ArrayStore(), JStore()
        assert (_encoded(model.fit_states, encode_fit_state, a)
                == _encoded(jloaded.fit_states, jencode, b))
        for k in a.arrays:
            np.testing.assert_array_equal(a.arrays[k], b.arrays[k])

    def test_in_core_model_saves_no_fit_states(self, data, tmp_path):
        import json

        model, _ = _train("xgb", False, data[0])
        assert model.fit_states is None
        path = str(tmp_path / "m")
        model.save(path)
        with open(os.path.join(path, "op-model.json")) as fh:
            assert "fitStates" not in json.load(fh)
        assert OpWorkflowModel.load(path, device="cpu").fit_states is None
