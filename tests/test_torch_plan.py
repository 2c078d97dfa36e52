"""The port's execution plan (``workflow/plan.py``) on the CPU, mirroring
the liveness cases of ``tests/test_plan_executor.py``: a pruned transform
equals the unpruned one on the kept columns (bitwise: the same stages run
on the same inputs), the peak resident column count goes down, drops never
touch columns the plan does not know, the plan is memoized per (DAG,
keep), and ``required_input_columns`` names the raw inputs.
"""
import csv
import os

import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import ColumnarDataset, FeatureColumn
from transmogrifai_tpu_torch.workflow.dag import transform_dag
from transmogrifai_tpu_torch.workflow.plan import plan_for
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflowModel

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def model():
    tt.set_device("cpu")
    return OpWorkflowModel.load(os.path.join(FIXTURES, "model_v1"))


@pytest.fixture()
def data():
    with open(os.path.join(FIXTURES, "model_v1_input.csv")) as f:
        rows = list(csv.DictReader(f))
    return ColumnarDataset({
        "label": FeatureColumn.from_values(
            ft.RealNN, [float(r["label"]) for r in rows]),
        "x": FeatureColumn.from_values(ft.Real, [r["x"] for r in rows]),
        "cat": FeatureColumn.from_values(ft.PickList,
                                         [r["cat"] for r in rows])})


def _keep(model):
    return [model.result_features[0].name]


class TestLiveness:
    def test_pruned_transform_matches_unpruned_on_kept(self, model, data):
        dag = model._scoring_dag()
        full = transform_dag(dag, data)
        pruned = transform_dag(dag, data, keep=_keep(model))
        assert pruned.names() == _keep(model)
        name = _keep(model)[0]
        a, b = full[name].values, pruned[name].values
        assert torch.equal(a.probability, b.probability)
        assert torch.equal(a.raw_prediction, b.raw_prediction)
        assert torch.equal(a.prediction, b.prediction)

    def test_peak_resident_columns_go_down(self, model, data):
        dag = model._scoring_dag()
        full, pruned = plan_for(dag), plan_for(dag, keep=_keep(model))
        full.transform(data)
        pruned.transform(data)
        # raw 3 + 5 stage outputs unpruned; raw inputs and intermediates
        # retire after their last consumer layer when pruned
        assert full.peak_columns == 8
        assert pruned.peak_columns == 5

    def test_on_stage_sees_each_executed_stage_in_order(self, model, data):
        plan = plan_for(model._scoring_dag(), keep=_keep(model))
        seen = []
        transform_dag(model._scoring_dag(), data, keep=_keep(model),
                      on_stage=lambda s, dt: seen.append((s.uid, dt)))
        assert [uid for uid, _ in seen] == [
            s.uid for layer in plan.layers for s in layer
            if s.uid in plan.needed_uids]
        assert all(dt >= 0.0 for _, dt in seen)

    def test_drops_never_touch_unknown_columns(self, model, data):
        extra = data.with_columns({"key": FeatureColumn.from_values(
            ft.ID, [str(i) for i in range(len(data))])})
        out = transform_dag(model._scoring_dag(), extra, keep=_keep(model))
        assert sorted(out.names()) == sorted(["key"] + _keep(model))

    def test_required_input_columns(self, model):
        plan = plan_for(model._scoring_dag(), keep=_keep(model))
        assert plan.required_input_columns() == frozenset(
            {"label", "x", "cat"} | set(_keep(model)))

    def test_unneeded_stages_are_skipped(self, model, data):
        dag = model._scoring_dag()
        vec = next(s for s in model.stages
                   if type(s).__name__ == "VectorsCombiner")
        plan = plan_for(dag, keep=[vec.get_output().name])
        out = plan.transform(data)
        assert vec.get_output().name in out
        assert _keep(model)[0] not in out
        assert all(type(s).__name__ != "SelectedModel"
                   for layer in plan.layers for s in layer
                   if s.uid in plan.needed_uids)


class TestPlanReuse:
    def test_plan_memoized_per_dag_and_keep(self, model):
        dag = model._scoring_dag()
        p1 = plan_for(dag, keep=_keep(model))
        assert plan_for(dag, keep=list(_keep(model))) is p1
        assert plan_for(dag) is not p1
        assert plan_for(dag) is plan_for(dag, keep=None)

    def test_unfitted_estimator_raises(self, data):
        from transmogrifai_tpu_torch.features.builder import FeatureBuilder
        from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
        from transmogrifai_tpu_torch.workflow.dag import compute_dag

        vec = transmogrify([FeatureBuilder.Real("x").as_predictor()])
        with pytest.raises(RuntimeError, match="unfitted estimator"):
            transform_dag(compute_dag([vec]), data)

    def test_score_prunes_to_responses_and_results(self, model, data):
        scored = model.score(data)
        assert scored.names() == ["label"] + _keep(model)
        expected = np.load(os.path.join(FIXTURES, "model_v1_expected.npy"))
        np.testing.assert_allclose(
            scored[_keep(model)[0]].values.probability[:, 1].numpy(),
            expected, atol=1e-5)
