"""ModelInsights, RecordInsightsLOCO and RecordInsightsCorr in the port
against the JAX package, on the CPU, and the persistence of their
artifacts (``rawFeatureFilterResults``, the insight stages) both ways.

Tolerances: ModelInsights' JSON equal with floats within 1e-3 absolute
(the LR winner's coefficients, ``tests/test_torch_linear.py``'s
tolerance; the checker's statistics and CV metrics are closer) and the
boosted winner's split-count contributions exact; LOCO runs one model
(the port's, loaded into the JAX package) on the same vectors, parsed
values within 1e-5 absolute (both score in float32) and each row's keys
equal as sets, in order up to exact ties of |change|; RecordInsightsCorr's
correlations and normalisation within 1e-9 relative, each row's kept
slots equal where no tie of |importance| sits at the top-K cut, values
within 1e-9."""
import itertools
import json

import numpy as np
import pandas as pd
import pytest
import torch

import transmogrifai_tpu.native
import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.insights import RecordInsightsCorr as JCorr
from transmogrifai_tpu.insights import RecordInsightsLOCO as JLOCO
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
from transmogrifai_tpu.models.trees import OpXGBoostClassifier as JXGB
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JChecker
from transmogrifai_tpu.selector.model_selector import \
    BinaryClassificationModelSelector as JBCMS
from transmogrifai_tpu.selector.model_selector import grid as jgrid
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.types.feature_types import OPVector as JOPVector
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu.workflow.workflow import OpWorkflowModel as JModel
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.insights import (NormType, RecordInsightsCorr,
                                              RecordInsightsLOCO,
                                              parse_insights)
from transmogrifai_tpu_torch.models.classification import \
    OpLogisticRegression
from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, grid)
from transmogrifai_tpu_torch.types.columns import FeatureColumn
from transmogrifai_tpu_torch.utils import uid as tuid
from transmogrifai_tpu_torch.workflow.workflow import (OpWorkflow,
                                                       OpWorkflowModel)

JAX = dict(fb=JFB, tm=jtransmogrify, checker=JChecker, sel=JBCMS, grid=jgrid,
           lr=JLR, xgb=JXGB, wf=JWorkflow, uid=juid)
PORT = dict(fb=FeatureBuilder, tm=transmogrify, checker=SanityChecker,
            sel=BinaryClassificationModelSelector, grid=grid,
            lr=OpLogisticRegression, xgb=OpXGBoostClassifier, wf=OpWorkflow,
            uid=tuid)


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frame(n=600, seed=5):
    rng = np.random.default_rng(seed)
    strong = rng.normal(size=n)
    weak = rng.normal(size=n)
    color = rng.choice(["red", "blue", "green"], n)
    count = rng.integers(0, 6, n).astype(float)
    z = 2.5 * strong + 1.2 * (color == "red") - 0.3 * count
    label = (1 / (1 + np.exp(-z)) > rng.random(n)).astype(float)
    return pd.DataFrame({"label": label, "strong": strong, "weak": weak,
                         "color": color, "count": count})


def _train(pkg, family, df):
    pkg["uid"]._counter = itertools.count(1)
    fb = pkg["fb"]
    label = fb.RealNN("label").as_response()
    preds = [fb.Real("strong").as_predictor(), fb.Real("weak").as_predictor(),
             fb.PickList("color").as_predictor(),
             fb.Integral("count").as_predictor()]
    checked = pkg["checker"]().set_input(
        label, pkg["tm"](preds)).get_output()
    if family == "lr":
        models = [(pkg["lr"](), pkg["grid"](reg_param=[0.01, 0.1],
                                            elastic_net_param=[0.0]))]
    else:
        models = [(pkg["xgb"](), pkg["grid"](num_round=[8], max_depth=[3],
                                             early_stopping_rounds=[0]))]
    sel = pkg["sel"].with_cross_validation(num_folds=3,
                                           models_and_parameters=models)
    pred = sel.set_input(label, checked).get_output()
    model = (pkg["wf"]().set_result_features(pred).set_input_data(df)
             .with_raw_feature_filter().train())
    return model, checked, pred


@pytest.fixture(scope="module")
def trained():
    """Both packages' trained workflows; the JAX package's histograms on
    its numpy path (its native backend bins differently)."""
    tt.set_device("cpu")
    df = _frame()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transmogrifai_tpu.native, "AVAILABLE", False)
        return {fam: (_train(JAX, fam, df), _train(PORT, fam, df), df)
                for fam in ("lr", "xgb")}


def _close(t, j, tol, path=""):
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _close(t[k], j[k], tol, f"{path}.{k}")
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _close(a, b, tol, f"{path}[{i}]")
    elif isinstance(j, float) and not isinstance(j, bool):
        if tol == 0 or np.isnan(j):
            assert t == j or (np.isnan(j) and np.isnan(t)), path
        else:
            assert t == pytest.approx(j, abs=tol, rel=tol), path
    else:
        assert t == j, path


def _strip_timing(doc):
    """The selector summary's wall seconds differ by run."""
    smi = doc.get("selectedModelInfo") or {}
    for k in [k for k in smi if "econds" in k or k.endswith("Secs")]:
        smi.pop(k)
    return doc


@pytest.mark.parametrize("family", ["lr", "xgb"])
def test_model_insights_equal(trained, family):
    (jm, _, _), (tm, _, _), _ = trained[family]
    jdoc = _strip_timing(json.loads(json.dumps(jm.model_insights().to_json(),
                                               default=str)))
    tdoc = _strip_timing(json.loads(json.dumps(tm.model_insights().to_json(),
                                               default=str)))
    assert set(tdoc) == set(jdoc)
    _close(tdoc["label"], jdoc["label"], 0)
    _close([s["stage"] for s in tdoc["stageInfo"]],
           [s["stage"] for s in jdoc["stageInfo"]], 0)
    _close(tdoc["rawFeatureFilterResults"], jdoc["rawFeatureFilterResults"],
           1e-12)
    assert ([f["featureName"] for f in tdoc["features"]]
            == [f["featureName"] for f in jdoc["features"]])
    tol = 1e-3 if family == "lr" else 0
    for tf_, jf_ in zip(tdoc["features"], jdoc["features"]):
        assert tf_["featureType"] == jf_["featureType"]
        for tc, jc in zip(tf_["derivedFeatures"], jf_["derivedFeatures"]):
            _close(tc["contribution"], jc["contribution"], tol)
            _close({k: v for k, v in tc.items() if k != "contribution"},
                   {k: v for k, v in jc.items() if k != "contribution"},
                   1e-5)
    _close(tdoc["selectedModelInfo"], jdoc["selectedModelInfo"], 1e-3)
    assert tm.model_insights().pretty_print().splitlines()[-1].split(":")[0] \
        == jm.model_insights().pretty_print().splitlines()[-1].split(":")[0]


def _loco_pair(trained, family, tmp_path, **kw):
    """LOCO of one model (the port's, saved and loaded into the JAX
    package) on the port's checked vectors, in both packages."""
    _, (tm, checked, _), _ = trained[family]
    tm.save(str(tmp_path / "m"))
    jm = JModel.load(str(tmp_path / "m"))
    col = tm.train_data[checked.name]
    X = col.values.numpy()
    jcol = JColumn(JOPVector, X, vmeta=col.vmeta)
    tsel = next(s for s in tm.stages if "model_selector_summary" in s.metadata)
    jsel = next(s for s in jm.stages if s.uid == tsel.uid)
    tout = RecordInsightsLOCO(tsel, **kw).transform_columns(col)
    jout = JLOCO(jsel, **kw).transform_columns(jcol)
    return tout.values, jout.values


def _assert_same_insights(tvals, jvals, tol=1e-5):
    for trow, jrow in zip(tvals, jvals):
        tp, jp = parse_insights(trow), parse_insights(jrow)
        assert set(tp) == set(jp)
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=tol)
        # order: by max |change| descending, ties in first-appearance order
        tkeys, jkeys = list(tp), list(jp)
        score = {k: max(abs(x) for x in jp[k]) for k in jp}
        for a, b in zip(tkeys, jkeys):
            if a != b:
                assert abs(score[a] - score[b]) <= 2 * tol


@pytest.mark.parametrize("family", ["lr", "xgb"])
@pytest.mark.parametrize("by_feature", [True, False])
def test_loco_equal(trained, family, by_feature, tmp_path):
    tvals, jvals = _loco_pair(trained, family, tmp_path, top_k=4,
                              aggregate_by_feature=by_feature)
    assert len(tvals) == len(jvals) == 600
    _assert_same_insights(tvals, jvals)
    assert all(len(r) <= 4 for r in tvals)


def test_loco_chunks_and_zero_slots(trained, monkeypatch, tmp_path):
    """Many chunks of zeroed-slot copies give the same result as one, and
    an all-zero slot is skipped."""
    from transmogrifai_tpu_torch.insights import record_insights as ri

    _, (tm, checked, _), _ = trained["lr"]
    col = tm.train_data[checked.name]
    X = col.values.clone()
    X[:, 0] = 0.0
    zcol = FeatureColumn(col.ftype, X, vmeta=col.vmeta)
    sel = next(s for s in tm.stages if "model_selector_summary" in s.metadata)
    one = RecordInsightsLOCO(sel, top_k=30)
    whole = one.transform_columns(zcol).values
    assert one.slots_scored == int((X != 0).any(dim=0).sum())
    monkeypatch.setattr(ri, "LOCO_CHUNK_ELEMS", X.numel() * 2)
    chunked = RecordInsightsLOCO(sel, top_k=30).transform_columns(zcol).values
    _assert_same_insights(chunked, whole, tol=1e-12)


@pytest.mark.parametrize("corr", ["pearson", "spearman"])
@pytest.mark.parametrize("norm", [NormType.MIN_MAX, NormType.Z_NORM,
                                  NormType.MIN_MAX_CENTERED])
def test_corr_equal(trained, corr, norm):
    _, (tm, checked, pred), _ = trained["lr"]
    col = tm.train_data[checked.name]
    pcol = tm.train_data[pred.name]
    X = col.values.numpy()
    jcol = JColumn(JOPVector, X, vmeta=col.vmeta)
    jpcol = JColumn(JOPVector, pcol.values.probability.numpy())
    k = 3
    tfit = RecordInsightsCorr(norm_type=norm, correlation_type=corr,
                              top_k=k).fit_columns(None, pcol, col)
    jfit = JCorr(norm_type=norm, correlation_type=corr,
                 top_k=k).fit_columns(None, jpcol, jcol)
    for a in ("score_corr", "shift", "scale"):
        np.testing.assert_allclose(getattr(tfit, a), getattr(jfit, a),
                                   rtol=1e-9, atol=1e-12)
    assert tfit.offset == jfit.offset
    tout = tfit.transform_columns(pcol, col).values
    jout = jfit.transform_columns(jpcol, jcol).values
    normed = np.where(jfit.scale == 0, 0.0, (X - jfit.shift) / jfit.scale) \
        - jfit.offset
    imp = np.abs(jfit.score_corr[None] * normed[:, None, :])
    names = col.vmeta.column_names()
    for i, (trow, jrow) in enumerate(zip(tout, jout)):
        tp, jp = parse_insights(trow), parse_insights(jrow)
        for c in range(imp.shape[1]):
            srt = np.sort(imp[i, c])[::-1]
            cut = srt[k - 1]
            tie_at_cut = k < len(srt) and np.isclose(srt[k], cut, rtol=1e-9)
            tk = {n for n, v in tp.items() if any(e[0] == c for e in v)}
            jk = {n for n, v in jp.items() if any(e[0] == c for e in v)}
            sure = {names[j] for j in np.flatnonzero(imp[i, c] > cut * (1 +
                                                                        1e-9))}
            assert sure <= tk and sure <= jk
            if not tie_at_cut:
                assert tk == jk
        for key in set(tp) & set(jp):
            te = {e[0]: e[1] for e in tp[key]}
            je = {e[0]: e[1] for e in jp[key]}
            for c in set(te) & set(je):
                assert te[c] == pytest.approx(je[c], rel=1e-9, abs=1e-12)


def test_rff_results_and_insight_stages_persist(trained, tmp_path):
    (jm, jchecked, jpred), (tm, checked, pred), df = trained["lr"]
    # port -> JAX
    tm.save(str(tmp_path / "port"))
    loaded_j = JModel.load(str(tmp_path / "port"))
    _close(loaded_j.raw_feature_filter_results,
           tm.raw_feature_filter_results.to_json(), 0)
    # JAX -> port
    jm.save(str(tmp_path / "jax"))
    loaded_t = OpWorkflowModel.load(str(tmp_path / "jax"), device="cpu")
    _close(loaded_t.raw_feature_filter_results,
           json.loads(json.dumps(jm.raw_feature_filter_results.to_json())), 0)
    # port -> port, and the loaded results feed ModelInsights
    again = OpWorkflowModel.load(str(tmp_path / "port"), device="cpu")
    _close(again.raw_feature_filter_results,
           tm.raw_feature_filter_results.to_json(), 0)
    # the insight stages cross both ways inside a workflow
    from transmogrifai_tpu_torch.workflow.persistence import (
        load_workflow_model)
    sel = next(s for s in tm.stages if "model_selector_summary" in s.metadata)
    col = tm.train_data[checked.name]
    pcol = tm.train_data[pred.name]
    loco = RecordInsightsLOCO(sel, top_k=3).set_input(checked)
    corr = RecordInsightsCorr(top_k=3).set_input(pred, checked)
    corr_model = corr.adopt_model(corr.fit_columns(None, pcol, col))
    wf_model = OpWorkflowModel(
        [loco.get_output(), corr_model.get_output()],
        list(tm.stages) + [loco, corr_model], tm.train_data)
    wf_model.save(str(tmp_path / "ins"))
    back = load_workflow_model(str(tmp_path / "ins"), device="cpu")
    jback = JModel.load(str(tmp_path / "ins"))
    for m in (back, jback):
        names = [type(s).__name__ for s in m.stages]
        assert "RecordInsightsLOCO" in names
        assert "RecordInsightsCorrModel" in names
    scored = back.score(df)
    jscored = jback.score(df)
    lname = loco.get_output().name
    _assert_same_insights(scored[lname].values, jscored[lname].values)
