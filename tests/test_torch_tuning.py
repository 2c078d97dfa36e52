"""The port's tuning layer (``tuning/{planner,budget,costmodel}.py``,
``tuning.Tuner``), ``train(profile=True)``, ``train(tuner=)`` and the
selector's ``parallel="auto"`` against the JAX package's, on the CPU,
mirroring the planner, budget and tuner parts of ``tests/test_tuning.py``.

Advice (``PlanAdvice``/``MeshAdvice`` JSON), budget estimates and skip
reasons, the grid axis, the profiled stage set (uid, op, kind, layer,
rows, input width) and the winners must match exactly; the cost model's
predictions (one float64 ridge in both) within 1e-9 relative.  Backends
are named as the JAX package names them ("cpu" here).
"""
import json

import numpy as np
import pandas as pd
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu import tuning as jtuning
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.parallel.mesh import auto_grid_axis as jauto_grid
from transmogrifai_tpu.selector.model_selector import \
    BinaryClassificationModelSelector as JBCMS
from transmogrifai_tpu.selector.model_selector import grid as jgrid
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow.dag import compute_dag as jcompute_dag
from transmogrifai_tpu.workflow.plan import plan_for as jplan_for
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu_torch import tuning
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.models.classification import \
    OpLogisticRegression
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, grid)
from transmogrifai_tpu_torch.tuning.planner import auto_grid_axis
from transmogrifai_tpu_torch.utils import uid as tuid
from transmogrifai_tpu_torch.utils.profiling import backend_name
from transmogrifai_tpu_torch.workflow.dag import compute_dag
from transmogrifai_tpu_torch.workflow.plan import plan_for
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

JAX = dict(fb=JFB, transmogrify=jtransmogrify, lr=JLR, selector=JBCMS,
           grid=jgrid, workflow=JWorkflow, uid=juid, tuning=jtuning,
           dag=jcompute_dag, plan=jplan_for)
PORT = dict(fb=FeatureBuilder, transmogrify=transmogrify,
            lr=OpLogisticRegression, selector=BinaryClassificationModelSelector,
            grid=grid, workflow=OpWorkflow, uid=tuid, tuning=tuning,
            dag=compute_dag, plan=plan_for)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


def _obs(pkg, kind, rows, cols, wall, backend="cpu"):
    return pkg["tuning"].StageObservation(
        stage_kind=kind, rows=rows, cols=cols, dtype="float32",
        backend=backend, wall_s=wall)


class TestPlanner:
    @pytest.mark.parametrize("rows,cols,budget", [
        (10_000, 50, 1 << 30), (10_000_000, 500, 1 << 30),
        (1_000_000, 500, 1 << 30), (300_000, 570, 64 << 20),
        (5, 1, None)])
    def test_advice_is_the_jax_packages(self, rows, cols, budget):
        a = tuning.advise_plan(rows, cols, host_budget_bytes=budget)
        j = jtuning.advise_plan(rows, cols, host_budget_bytes=budget)
        assert a.to_json() == j.to_json()
        assert a.format() == j.format()

    def test_small_shape_stays_in_core(self):
        adv = tuning.advise_plan(10_000, 50, host_budget_bytes=1 << 30)
        assert adv.mode == "in-core" and adv.chunk_rows is None

    def test_big_shape_streams_with_geometry(self):
        adv = tuning.advise_plan(10_000_000, 500, host_budget_bytes=1 << 30)
        assert adv.mode == "stream"
        assert adv.chunk_rows and adv.chunk_rows >= 1024
        assert abs(adv.chunk_rows * 500 * 4 - (64 << 20)) < (8 << 20)
        assert adv.retain_mb >= 64
        assert adv.prefetch_chunks >= 2
        assert "exceeds" in " ".join(adv.reasons)

    def test_cost_model_predicted_wall_and_prefetch(self):
        """A fitted history: the predicted wall and the read-bound
        prefetch depth are the JAX package's."""
        shapes = [(4096 * k, 500, 0.4 * k) for k in (1, 2, 4, 8)]
        models = []
        for pkg in (PORT, JAX):
            obs = ([_obs(pkg, "Reader:read", r, c, w) for r, c, w in shapes]
                   + [_obs(pkg, "Vec:transform", r, c, w / 10)
                      for r, c, w in shapes])
            models.append(pkg["tuning"].CostModel().fit(obs))
        a = tuning.advise_plan(10_000_000, 500, host_budget_bytes=1 << 30,
                               cost_model=models[0], backend="cpu")
        j = jtuning.advise_plan(10_000_000, 500, host_budget_bytes=1 << 30,
                                cost_model=models[1], backend="cpu")
        assert a.prefetch_chunks == j.prefetch_chunks == 4
        assert a.predicted_wall_s == pytest.approx(j.predicted_wall_s,
                                                   rel=1e-9)
        assert a.reasons == j.reasons

    @pytest.mark.parametrize("n,q", [(1, 8), (2, 8), (4, 8), (8, 2),
                                     (8, 26), (16, 3), (6, 10)])
    def test_grid_axis_is_the_jax_packages(self, n, q):
        assert auto_grid_axis(n, q) == jauto_grid(n, q)

    @pytest.mark.parametrize("rows,cols,q,n", [
        (1000, 10, 8, 1), (1_000_000, 500, 26, 4), (1_000_000, 500, 3, 8),
        (50_000, 20, 8, 2)])
    def test_mesh_advice_is_the_jax_packages(self, rows, cols, q, n):
        a = tuning.advise_mesh(rows, cols, queue_width=q,
                               devices_available=n)
        j = jtuning.advise_mesh(rows, cols, queue_width=q,
                                devices_available=n)
        assert a.to_json() == j.to_json()

    def test_mesh_advice_from_scaling_history(self):
        obs_rows = [(10_000, 1, 2.0), (10_000, 2, 1.1), (10_000, 4, 0.7),
                    (20_000, 1, 4.0), (20_000, 2, 2.1), (20_000, 4, 1.2)]
        advs = []
        for pkg in (PORT, JAX):
            obs = [pkg["tuning"].StageObservation(
                "ModelSelector:fit", r, 50, "float32", "cpu", w,
                n_devices=nd) for r, nd, w in obs_rows]
            cm = pkg["tuning"].CostModel().fit(obs)
            advs.append(pkg["tuning"].advise_mesh(
                20_000, 50, queue_width=8, devices_available=4,
                cost_model=cm, backend="cpu"))
        assert advs[0].n_devices == advs[1].n_devices
        assert advs[0].reasons == advs[1].reasons

    def test_deterministic(self):
        a = tuning.advise_plan(1_000_000, 500, host_budget_bytes=1 << 30)
        b = tuning.advise_plan(1_000_000, 500, host_budget_bytes=1 << 30)
        assert a.to_json() == b.to_json()

    def test_plan_explain_carries_advice(self):
        texts = []
        for pkg in (PORT, JAX):
            pkg["uid"].reset_uids()
            rng = np.random.default_rng(0)
            df = pd.DataFrame({"label": (rng.random(50) > 0.5).astype(float),
                               "a": rng.normal(size=50)})
            label = pkg["fb"].RealNN("label").as_response()
            feats = pkg["transmogrify"]([pkg["fb"].Real("a").as_predictor()])
            pred = pkg["lr"]().set_input(label, feats).get_output()
            plan = pkg["plan"](pkg["dag"]([pred]), keep=[pred.name])
            advice = plan.advise(10_000_000, 500, host_budget_bytes=1 << 30,
                                 cost_model=pkg["tuning"].CostModel())
            text = plan.explain(advice=advice)
            assert "plan advice: stream" in text
            texts.append(text)
        assert texts[0] == texts[1]
        # the mesh line counts this process's cards (none here: one
        # device); the JAX package's tests run on 8 host devices
        advice = plan_for(compute_dag([pred]), keep=[pred.name]).advise(
            10_000_000, 500, host_budget_bytes=1 << 30,
            cost_model=tuning.CostModel(), queue_width=4)
        assert "mesh advice: 1 device(s) (data=1, grid=1)" in \
            advice.format()


class TestBenchBudgeter:
    def test_measured_history_wins(self, tmp_path):
        for pkg in (PORT, JAX):
            path = str(tmp_path / f"h{id(pkg)}.json")
            b = pkg["tuning"].BenchBudgeter(path, budget_s=1000)
            b.record("cfg", 123.0, cold=False, sig="10x2:light")
            assert b.estimate("cfg", 50.0, sig="10x2:light") == (
                123.0, "measured_history")
            assert b.estimate("cfg", 50.0, sig="other") == (50.0, "assumed")
        with open(tmp_path / f"h{id(PORT)}.json") as f:
            port = json.load(f)
        with open(tmp_path / f"h{id(JAX)}.json") as f:
            jax = json.load(f)
        for doc in (port, jax):
            doc["cfg"].pop("recorded_unix")
        assert port == jax

    def test_cost_model_tier_only_raises_estimates(self, tmp_path):
        ests = []
        for pkg in (PORT, JAX):
            path = str(tmp_path / f"h{id(pkg)}.json")
            pkg["tuning"].append_observations(
                path, [_obs(pkg, "Big:fit", 1_000_000, 500, 5000.0)] * 4)
            b = pkg["tuning"].BenchBudgeter(path, budget_s=10_000)
            est, src = b.estimate("cfg", 10.0, sig="1000000x500:default")
            assert src == "cost_model" and est > 10.0
            assert b.estimate("cfg", 1e9, sig="1000000x500:default") == (
                1e9, "assumed")
            ests.append(est)
        assert ests[0] == pytest.approx(ests[1], rel=1e-9)

    def test_skip_reason_and_reserve(self, tmp_path):
        out = []
        for pkg in (PORT, JAX):
            t = [0.0]
            b = pkg["tuning"].BenchBudgeter(
                str(tmp_path / f"h{id(pkg)}.json"), budget_s=100,
                clock=lambda: t[0])
            b.set_reserve(60.0)
            assert b.should_skip("cheap", 10.0) is None
            reason = b.should_skip("big", 50.0)
            assert reason and "exceeds remaining budget" in reason
            assert "reserving 60s" in reason
            t[0] = 95.0
            late = b.should_skip("cheap", 10.0)
            assert late is not None
            out.append((reason, late, b.to_json()))
        assert out[0] == out[1]

    def test_history_helpers(self, tmp_path):
        from transmogrifai_tpu.tuning.budget import \
            estimate_from_history as jest

        path = str(tmp_path / "h.json")
        tuning.record_measurement(path, "x", 12.34, cold=True, sig="s")
        assert tuning.estimate_from_history(path, "x", 1.0, "s") == \
            jest(path, "x", 1.0, "s") == (12.3, "measured_history")


def _selector_frame(n=600, seed=3):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "label": (rng.random(n) > 0.5).astype(float),
        "a": rng.normal(size=n), "b": rng.normal(size=n),
        "c": rng.normal(size=n)})


def _selector_wf(pkg, df, **sel_kw):
    pkg["uid"].reset_uids()
    fb = pkg["fb"]
    label = fb.RealNN("label").as_response()
    feats = pkg["transmogrify"]([fb.Real(c).as_predictor() for c in "abc"])
    sel = pkg["selector"].with_cross_validation(
        num_folds=2, models_and_parameters=[
            (pkg["lr"](), pkg["grid"](reg_param=[0.01, 0.1, 0.3]))],
        **sel_kw)
    pred = sel.set_input(label, feats).get_output()
    return (pkg["workflow"]().set_result_features(pred).set_input_data(df),
            sel)


class TestTuner:
    def test_tuner_strategy_applied_and_restored(self):
        df = _selector_frame()
        out = []
        for pkg in (PORT, JAX):
            wf, sel = _selector_wf(pkg, df)
            assert sel.strategy == "full"
            wf.train(tuner=pkg["tuning"].Tuner(
                strategy="halving", halving=pkg["tuning"].HalvingConfig(
                    min_rows=64, min_candidates=2)))
            assert sel.strategy == "full" and sel.halving is None
            assert "halving_schedule" in sel.metadata
            out.append((sel.metadata["halving_schedule"],
                        sel.metadata["model_selector_summary"][
                            "bestModelParams"]))
        assert out[0][1] == out[1][1]
        assert out[0][0]["survivors"] == out[1][0]["survivors"]
        assert [r["rows"] for r in out[0][0]["rungs"]] == [
            r["rows"] for r in out[1][0]["rungs"]]

    def test_auto_plan_streams_under_a_small_budget(self):
        """A host budget below the projected in-core peak: the planner
        streams, the train takes its chunk geometry, the selector's
        settings come back."""
        df = _selector_frame(n=2000, seed=5)
        out = []
        for pkg in (PORT, JAX):
            wf, sel = _selector_wf(pkg, df)
            model = wf.train(tuner=pkg["tuning"].Tuner(
                strategy="full", auto_plan=True, host_budget_bytes=4096,
                cost_model=pkg["tuning"].CostModel()))
            ip = model.ingest_profile
            assert ip is not None and model.fit_states
            out.append((ip.chunk_rows, [p.label for p in ip.passes],
                        sel.metadata["model_selector_summary"][
                            "bestModelParams"]))
        assert out[0] == out[1]
        # a 64 MB chunk holds every row: one chunk of the 2000
        assert out[0][0] == 2000

    def test_train_appends_observations(self, tmp_path, monkeypatch):
        path = str(tmp_path / "ch.json")
        monkeypatch.setenv("TMOG_COST_HISTORY", path)
        rng = np.random.default_rng(0)
        df = pd.DataFrame({"label": (rng.random(200) > 0.5).astype(float),
                           "a": rng.normal(size=200),
                           "b": rng.normal(size=200)})
        kinds = []
        for pkg in (PORT, JAX):
            pkg["uid"].reset_uids()
            label = pkg["fb"].RealNN("label").as_response()
            feats = pkg["transmogrify"]([pkg["fb"].Real(c).as_predictor()
                                         for c in "ab"])
            pred = pkg["lr"]().set_input(label, feats).get_output()
            n0 = len(pkg["tuning"].load_observations(path))
            pkg["workflow"]().set_result_features(pred).set_input_data(
                df).train()
            obs = pkg["tuning"].load_observations(path)[n0:]
            assert obs, "train() must append stage observations"
            assert all(o.rows == 200 for o in obs)
            assert any(":fit" in o.stage_kind for o in obs)
            assert all(o.backend == "cpu" for o in obs)
            kinds.append(sorted((o.stage_kind, o.cols) for o in obs))
        assert kinds[0] == kinds[1]

    def test_disabled_history_records_nothing(self, tmp_path, monkeypatch):
        from transmogrifai_tpu_torch.tuning.costmodel import \
            default_history_path

        for value in ("", "0"):
            monkeypatch.setenv("TMOG_COST_HISTORY", value)
            assert default_history_path() is None
        monkeypatch.delenv("TMOG_COST_HISTORY")
        assert default_history_path() is None
        assert not tuning.record_train_observations(object())


def _profile_rows(profiler):
    return sorted((s.uid, s.op, s.kind, s.layer, s.rows, s.cols,
                   s.device_heavy, s.stage_kind)
                  for s in profiler.stages)


class TestProfile:
    @pytest.mark.parametrize("chunk_rows", [None, 128])
    def test_stage_profile_set_is_the_jax_packages(self, chunk_rows):
        df = _selector_frame()
        profs = []
        for pkg in (PORT, JAX):
            wf, _ = _selector_wf(pkg, df)
            model = wf.train(profile=True, chunk_rows=chunk_rows)
            prof = model.train_profile
            assert prof is not None and prof.wall_s >= 0
            assert prof.lint is not None
            assert all(s.backend == "cpu" for s in prof.stages)
            assert "plan execution:" in prof.format()
            doc = prof.to_json()
            assert {"wallSecs", "peakColumns", "finalColumns", "layerDrops",
                    "stages"} <= set(doc)
            assert (doc.get("ingest") is not None) == (chunk_rows is not None)
            profs.append(prof)
        assert _profile_rows(profs[0]) == _profile_rows(profs[1])
        if chunk_rows is not None:
            # in core the port keeps every intermediate column (no
            # keep-set pruning in its train), so only the chunked peaks
            # are comparable
            assert profs[0].peak_columns == profs[1].peak_columns

    def test_no_profile_by_default(self):
        wf, _ = _selector_wf(PORT, _selector_frame())
        assert wf.train().train_profile is None
        assert backend_name("cpu") == "cpu"
        assert backend_name("cuda") == "gpu"


class TestParallelAuto:
    def test_auto_resolves_on_one_device(self):
        """``parallel="auto"`` at fit time: the advice over one card (here
        the CPU) keeps the single-card sweep and is recorded as the JAX
        package records it; the winner is the plain sweep's."""
        df = _selector_frame()
        out = []
        for pkg in (PORT, JAX):
            wf, sel = _selector_wf(pkg, df, parallel="auto")
            wf.train()
            out.append((sel.metadata["mesh_advice"],
                        sel.metadata["model_selector_summary"]))
        (adv, summ), (jadv, jsumm) = out
        assert adv == jadv
        assert adv["nDevices"] == 1
        assert summ["bestModelParams"] == jsumm["bestModelParams"]
        wf, sel = _selector_wf(PORT, df)
        wf.train()
        assert sel.metadata["model_selector_summary"]["bestModelParams"] \
            == summ["bestModelParams"]

    def test_advice_of_several_cards_names_item_6_7(self, monkeypatch):
        from transmogrifai_tpu_torch.selector.model_selector import \
            ModelSelector

        sel = BinaryClassificationModelSelector.with_cross_validation(
            parallel="auto")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        with pytest.raises(NotImplementedError, match="item 6.7"):
            ModelSelector._resolve_parallel(sel, 1_000_000, 500, 26,
                                            torch.device("cuda"))
        assert sel.metadata["mesh_advice"]["nDevices"] == 4
        ModelSelector._resolve_parallel(sel, 1_000_000, 500, 26, "cpu")
        assert sel.metadata["mesh_advice"]["nDevices"] == 1


class TestRunnerProfile:
    @pytest.mark.parametrize("chunk_rows", [None, 256])
    def test_custom_params_profile_puts_the_execution_profile(
            self, tmp_path, chunk_rows):
        """``custom_params.profile`` (and ``chunk_rows``) through each
        package's ``OpWorkflowRunner``: the train summary carries
        ``executionProfile`` with the same stages (and ``ingestProfile``
        when chunked)."""
        from transmogrifai_tpu.workflow import runner as jrunner
        from transmogrifai_tpu_torch.workflow import runner

        df = _selector_frame()
        custom = {"profile": True}
        if chunk_rows:
            custom["chunk_rows"] = chunk_rows
        out = []
        for pkg, mod in ((PORT, runner), (JAX, jrunner)):
            wf, _ = _selector_wf(pkg, df)
            params = mod.OpParams(model_location=str(
                tmp_path / f"m{id(pkg)}"), custom_params=custom)
            summary = mod.OpWorkflowRunner(wf).run(mod.RunType.Train,
                                                   params).summary
            prof = summary["executionProfile"]
            assert ("ingestProfile" in summary) == bool(chunk_rows)
            out.append(sorted((s["uid"], s["op"], s["kind"], s["layer"],
                               s["rows"], s["cols"], s["stageKind"])
                              for s in prof["stages"]))
        assert out[0] == out[1]
