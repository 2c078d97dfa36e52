"""The port's workflow-level CV (``OpWorkflow.with_workflow_cv``,
``workflow/dag.py::cut_dag_cv``, ``ModelSelector.find_best_estimator``)
against the JAX package's, on the CPU, with the Titanic demo's DAG
(``tests/test_torch_titanic.py``'s ``build_demo``, with a lighter grid)
on 400 rows of its frame.

* ``cut_dag_cv`` puts the same stage classes before and during the cut
  in both packages (SanityChecker during, the vectorizers before), and
  refuses a DAG of two selectors.
* A workflow-CV train gives the same winner in both packages, and the
  fold-refit results (``metadata["workflow_cv_results"]``, one a grid
  point) agree: RF within 1e-6 (the port draws the JAX package's bags),
  LR within 1e-4.  The winner is consumed by the final fit.
* The workflow-CV train's holdout AuPR is within 0.1 of a plain train's
  (the JAX package's ``test_cv_and_plain_train_agree_on_quality``).
"""
import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from test_torch_titanic import (JAX, PORT, _jax_bags, build_demo,
                                titanic_frame)
from transmogrifai_tpu.workflow.dag import compute_dag as jcompute_dag
from transmogrifai_tpu.workflow.dag import cut_dag_cv as jcut
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.workflow.dag import compute_dag, cut_dag_cv

N_TRAIN, N_HOLD = 400, 200
RF_TOL, LR_TOL = 1e-6, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frames():
    df = titanic_frame(N_TRAIN + N_HOLD, seed=5, label_seed=13)
    return (df.iloc[:N_TRAIN].reset_index(drop=True),
            df.iloc[N_TRAIN:].reset_index(drop=True))


def _classes(dag):
    return sorted(type(s).__name__ for s in dag.all_stages())


def test_cut_puts_the_same_stages_before_and_during():
    tpred, _, tsel = build_demo(PORT)
    jpred, _, jsel = build_demo(JAX)
    tcut = cut_dag_cv(compute_dag([tpred]))
    jcut_ = jcut(jcompute_dag([jpred]))
    assert tcut.selector is tsel and jcut_.selector is jsel
    assert _classes(tcut.during) == _classes(jcut_.during)
    assert "SanityChecker" in _classes(tcut.during)
    assert _classes(tcut.before) == _classes(jcut_.before)
    assert "SanityChecker" not in _classes(tcut.before)
    assert not tcut.after.layers and not jcut_.after.layers


def test_at_most_one_selector():
    pred1, checked, _ = build_demo(PORT)
    survived = checked.origin_stage.input_features[0]
    pred2 = PORT["selector"].with_cross_validation().set_input(
        survived, checked).get_output()
    with pytest.raises(ValueError, match="at most 1"):
        cut_dag_cv(compute_dag([pred1, pred2]))


def _train(pkg, train, hold, cv: bool):
    pred, _, sel = build_demo(pkg)
    # the demo's DAG with a lighter grid: LR 2 x 1 and 5-tree forests at
    # depths 3 and 6 (the demo's 50-tree depth-12 forests cost the JAX
    # package minutes of fits a fold)
    g = pkg["grid"]
    sel.models_and_params = [
        (pkg["lr"](), g(reg_param=[0.01, 0.1], elastic_net_param=[0.0])),
        (pkg["rf"](), g(num_trees=[5], max_depth=[3, 6],
                        min_info_gain=[0.001]))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMOG_COST_HISTORY", "0")
        mp.setattr(tk, "rf_bags_and_features", _jax_bags)
        wf = pkg["workflow"]().set_result_features(pred).set_input_data(
            train)
        model = (wf.with_workflow_cv() if cv else wf).train()
    _, metrics = model.score_and_evaluate(
        pkg["evaluators"].BinaryClassification.auPR(), data=hold)
    return sel, metrics


@pytest.fixture(scope="module")
def cv_runs(frames):
    train, hold = frames
    return (_train(JAX, train, hold, True), _train(PORT, train, hold, True))


def test_workflow_cv_matches_jax(cv_runs):
    (jsel, _), (tsel, _) = cv_runs
    assert tsel.best_estimator is None and jsel.best_estimator is None
    tr = tsel.metadata["workflow_cv_results"]
    jr = jsel.metadata["workflow_cv_results"]
    assert len(tr) == len(jr) == 4
    for a, b in zip(tr, jr):
        assert (a["modelType"], a["params"]) == (b["modelType"], b["params"])
        assert len(a["foldValues"]) == 3
        tol = RF_TOL if a["modelType"] == "OpRandomForestClassifier" \
            else LR_TOL
        np.testing.assert_allclose(a["foldValues"], b["foldValues"],
                                   rtol=0, atol=tol)
    ts = tsel.metadata["model_selector_summary"]
    js = jsel.metadata["model_selector_summary"]
    assert (ts["bestModelType"], ts["bestModelParams"]) == (
        js["bestModelType"], js["bestModelParams"])
    # the final fit reports the fold-refit results as its validation
    assert [r["foldValues"] for r in ts["validationResults"]] == \
        [r["foldValues"] for r in tr]


def test_cv_and_plain_train_agree_on_quality(frames, cv_runs):
    train, hold = frames
    _, plain = _train(PORT, train, hold, False)
    (_, _), (_, cv) = cv_runs
    assert abs(plain["AuPR"] - cv["AuPR"]) < 0.1, (plain, cv)
