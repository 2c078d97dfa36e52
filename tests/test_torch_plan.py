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


def _pool_frame(n, seed=4):
    """n numpy-seeded rows of three Reals, two PickLists, a Text and a
    label: transmogrify makes several host vectorizers in one layer."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "label": (rng.random(n) > 0.5).astype(float),
        "a": rng.normal(size=n), "b": rng.normal(size=n),
        "c": np.where(rng.random(n) < 0.1, np.nan, rng.normal(size=n)),
        "p": rng.choice(["x", "y", "z"], n),
        "q": rng.choice(["u", "v"], n),
        "t": rng.choice(["red fox", "blue dog", "green cat"], n)})


def _pool_dag(pkg):
    """(result feature, DAG) of transmogrify -> SanityChecker -> LR in
    either package."""
    if pkg == "jax":
        from transmogrifai_tpu.features.builder import FeatureBuilder as fb
        from transmogrifai_tpu.models.classification import \
            OpLogisticRegression as lr
        from transmogrifai_tpu.ops.transmogrify import transmogrify as trans
        from transmogrifai_tpu.preparators.sanity_checker import \
            SanityChecker as checker
        from transmogrifai_tpu.utils.uid import reset_uids
        from transmogrifai_tpu.workflow.dag import compute_dag
    else:
        from transmogrifai_tpu_torch.features.builder import \
            FeatureBuilder as fb
        from transmogrifai_tpu_torch.models.classification import \
            OpLogisticRegression as lr
        from transmogrifai_tpu_torch.ops.transmogrify import \
            transmogrify as trans
        from transmogrifai_tpu_torch.preparators.sanity_checker import \
            SanityChecker as checker
        from transmogrifai_tpu_torch.utils.uid import reset_uids
        from transmogrifai_tpu_torch.workflow.dag import compute_dag
    reset_uids()
    label = fb.RealNN("label").as_response()
    feats = trans([fb.Real("a").as_predictor(), fb.Real("b").as_predictor(),
                   fb.Real("c").as_predictor(),
                   fb.PickList("p").as_predictor(),
                   fb.PickList("q").as_predictor(),
                   fb.Text("t").as_predictor()])
    checked = checker(max_correlation=0.99).set_input(label,
                                                      feats).get_output()
    pred = lr().set_input(label, checked).get_output()
    return pred, compute_dag([pred])


class TestLayerPool:
    """The fit path's layer pool (``ExecutionPlan.fit_and_transform``): a
    layer's host stages on threads where the host has cores and the data
    rows, the device-heavy ones serial; bitwise the serial run."""

    N = 5000

    def _fit(self, monkeypatch, pool: bool):
        from transmogrifai_tpu_torch.readers.base import reader_for
        from transmogrifai_tpu_torch.utils.profiling import PlanProfiler
        from transmogrifai_tpu_torch.workflow import plan as tplan

        monkeypatch.setenv("TMOG_PLAN_WORKERS", "4" if pool else "1")
        pred, dag = _pool_dag("port")
        raw = reader_for(_pool_frame(self.N)).generate_dataset(
            [f for f in pred.raw_features()])
        prof = PlanProfiler()
        fitted, out = tplan.ExecutionPlan(dag).fit_and_transform(
            raw, profiler=prof)
        return pred, fitted, out, prof

    def test_pool_and_serial_runs_are_bitwise_equal(self, monkeypatch):
        from transmogrifai_tpu_torch.workflow import plan as tplan

        calls = []
        real = tplan.ExecutionPlan._run_stage

        def spy(stage, data, subs, li, n_rows, prof, coll, serial):
            calls.append((type(stage).__name__, serial))
            return real(stage, data, subs, li, n_rows, prof, coll, serial)

        monkeypatch.setattr(tplan.ExecutionPlan, "_run_stage",
                            staticmethod(spy))
        _, _, serial, _ = self._fit(monkeypatch, pool=False)
        assert all(s for _, s in calls)
        calls.clear()
        pred, fitted, pooled, prof = self._fit(monkeypatch, pool=True)
        # the vectorizers went to the pool, the checker and the model not
        assert any(not s for _, s in calls)
        assert all(s for name, s in calls
                   if name in ("SanityChecker", "OpLogisticRegression"))
        assert pooled.names() == serial.names()
        for name in serial.names():
            a, b = serial[name].values, pooled[name].values
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), name
            elif hasattr(a, "probability"):
                assert torch.equal(a.probability, b.probability)
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert len(prof.stages) == len(fitted)

    def test_small_data_stays_serial(self, monkeypatch):
        from transmogrifai_tpu_torch.workflow import plan as tplan

        seen = []
        real = tplan.ExecutionPlan._run_stage

        def spy(stage, data, subs, li, n_rows, prof, coll, serial):
            seen.append(serial)
            return real(stage, data, subs, li, n_rows, prof, coll, serial)

        monkeypatch.setattr(tplan.ExecutionPlan, "_run_stage",
                            staticmethod(spy))
        monkeypatch.setenv("TMOG_PLAN_WORKERS", "4")
        pred, dag = _pool_dag("port")
        from transmogrifai_tpu_torch.readers.base import reader_for

        raw = reader_for(_pool_frame(200)).generate_dataset(
            list(pred.raw_features()))
        tplan.ExecutionPlan(dag).fit_and_transform(raw)
        assert seen and all(seen)

    def test_profile_and_explain_match_jax(self):
        """The stage profiles of one fit (op, kind, layer, rows, width,
        device-heavy) and the plan's text are the JAX package's."""
        from transmogrifai_tpu.readers.base import reader_for as jreader
        from transmogrifai_tpu.utils.profiling import \
            PlanProfiler as JProfiler
        from transmogrifai_tpu.workflow.plan import \
            ExecutionPlan as JPlan
        from transmogrifai_tpu_torch.readers.base import reader_for
        from transmogrifai_tpu_torch.utils.profiling import PlanProfiler
        from transmogrifai_tpu_torch.workflow.plan import ExecutionPlan

        df = _pool_frame(300)
        rows = []
        texts = []
        for pkg, reader, plan_cls, prof_cls in (
                ("port", reader_for, ExecutionPlan, PlanProfiler),
                ("jax", jreader, JPlan, JProfiler)):
            pred, dag = _pool_dag(pkg)
            raw = reader(df).generate_dataset(list(pred.raw_features()))
            prof = prof_cls()
            plan = plan_cls(dag)
            plan.fit_and_transform(raw, profiler=prof)
            rows.append(sorted((s.uid, s.op, s.kind, s.layer, s.rows, s.cols,
                                s.device_heavy, s.stage_kind, s.launches)
                               for s in prof.stages))
            texts.append(plan.explain())
        assert rows[0] == rows[1]
        assert texts[0] == texts[1]


def test_profiler_and_refresh_counters_under_many_threads():
    """The pool's threads record into one ``PlanProfiler`` and bump the
    process's refresh counters: no record or count is lost with more
    threads than cores and a short switch interval."""
    import sys
    import threading

    from transmogrifai_tpu_torch.utils.profiling import (
        PlanProfiler, StageProfile, count_refresh, refresh_snapshot)

    prof = PlanProfiler()
    before = refresh_snapshot()["merged"]
    n_threads, per = 4 * (os.cpu_count() or 2), 200

    def work(t):
        for i in range(per):
            prof.record_stage(StageProfile(
                uid=f"{t}.{i}", op="Op", output="o", layer=0, kind="fit",
                device_heavy=False, wall_s=1e-6, rows=1))
            prof.note_columns(i)
            count_refresh("merged")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(prof.stages) == n_threads * per
    assert len({s.uid for s in prof.stages}) == n_threads * per
    assert refresh_snapshot()["merged"] - before == n_threads * per
    assert prof.peak_columns == per - 1
