"""The app entry points in the port (``workflow/runner.py``,
``readers/streaming.py``, ``utils/profiling.py``'s app metrics) against
the JAX package's, on the CPU: every run type, the streaming readers,
the application-end handlers and tags, ``OpApp``'s argv.

Tolerances, and why: the metrics JSON's keys and step names equal the
JAX runner's; the written scores CSV has the JAX runner's header and its
probabilities within 1e-6 of the JAX model's (the same LR grid fitted by
both: the port's float64 solve against the JAX package's); row counts
exact.
"""
import ast
import csv
import itertools
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import OpWorkflow as JWorkflow
from transmogrifai_tpu import transmogrify as jtransmogrify
from transmogrifai_tpu.evaluators import Evaluators as JEvaluators
from transmogrifai_tpu.models import OpLogisticRegression as JLR
from transmogrifai_tpu.selector import BinaryClassificationModelSelector \
    as JSelector
from transmogrifai_tpu.selector import grid as jgrid
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow import runner as jrunner
from transmogrifai_tpu_torch.evaluators import Evaluators
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.models import OpLogisticRegression
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.readers import (AsyncBatcher, StreamingReaders,
                                             FileStreamingReader)
from transmogrifai_tpu_torch.selector import (
    BinaryClassificationModelSelector, grid)
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                   FeatureColumn)
from transmogrifai_tpu_torch.utils import (MetricsCollector, OpStep,
                                           install_collector, uid as puid,
                                           with_job_group)
from transmogrifai_tpu_torch.workflow import (OpApp, OpParams, OpWorkflow,
                                              OpWorkflowRunner, RunType)
from transmogrifai_tpu_torch.workflow.runner import write_csv

N = 300


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_cols(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    y = (rng.random(n) < 1 / (1 + np.exp(-(1.2 * x1 - x2)))).astype(float)
    return {"label": y, "x1": x1, "x2": x2}


def dataset(cols, lo=0, hi=None):
    hi = len(cols["label"]) if hi is None else hi
    return ColumnarDataset({
        "label": FeatureColumn.from_values(ft.RealNN, cols["label"][lo:hi]),
        "x1": FeatureColumn.from_values(ft.Real, cols["x1"][lo:hi]),
        "x2": FeatureColumn.from_values(ft.Real, cols["x2"][lo:hi])})


def build(data=None):
    puid._counter = itertools.count(1)
    label = FeatureBuilder.RealNN("label").as_response()
    feats = transmogrify([FeatureBuilder.Real("x1").as_predictor(),
                          FeatureBuilder.Real("x2").as_predictor()])
    pred = BinaryClassificationModelSelector.with_train_validation_split(
        models_and_parameters=[(OpLogisticRegression(),
                                grid(reg_param=[0.01]))]
    ).set_input(label, feats).get_output()
    wf = OpWorkflow().set_result_features(pred)
    return wf.set_input_data(data) if data is not None else wf


def jbuild(df):
    juid._counter = itertools.count(1)
    label = JFB.RealNN("label").as_response()
    feats = jtransmogrify([JFB.Real("x1").as_predictor(),
                           JFB.Real("x2").as_predictor()])
    pred = JSelector.with_train_validation_split(
        models_and_parameters=[(JLR(), jgrid(reg_param=[0.01]))]
    ).set_input(label, feats).get_output()
    return JWorkflow().set_result_features(pred).set_input_data(df)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tt.set_device("cpu")
    tmp = tmp_path_factory.mktemp("runner")
    cols = make_cols()
    params = OpParams(model_location=str(tmp / "model"),
                      metrics_location=str(tmp / "metrics"))
    result = OpWorkflowRunner(build(dataset(cols))).run(RunType.Train, params)
    jparams = jrunner.OpParams(model_location=str(tmp / "jmodel"),
                               metrics_location=str(tmp / "jmetrics"))
    jresult = jrunner.OpWorkflowRunner(jbuild(pd.DataFrame(cols))).run(
        jrunner.RunType.Train, jparams)
    return tmp, cols, result, jresult


def _metrics(path):
    with open(os.path.join(path, "op_metrics.json")) as fh:
        return json.load(fh)


def _scores(path):
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    return rows[0], np.array([ast.literal_eval(r[1])["probability_1"]
                              for r in rows[1:]])


class TestRunTypes:
    def test_train_writes_the_model_and_the_jax_metrics_keys(self, trained):
        tmp, _, result, jresult = trained
        assert result.run_type == "train" and result.summary
        assert os.path.isdir(tmp / "model")
        doc, jdoc = _metrics(tmp / "metrics"), _metrics(tmp / "jmetrics")
        assert set(doc) == set(jdoc) and set(doc["app"]) == set(jdoc["app"])
        steps = {m["step"] for m in doc["app"]["stepMetrics"]}
        assert steps == {m["step"] for m in jdoc["app"]["stepMetrics"]}
        assert {"DataReadingAndFiltering", "FeatureEngineering",
                "ModelIO"} <= steps
        assert doc["runType"] == "train"

    def test_score_writes_the_jax_scores(self, trained, tmp_path):
        tmp, cols, _, _ = trained
        result = OpWorkflowRunner(build(), score_reader=dataset(cols)).run(
            RunType.Score, OpParams(model_location=str(tmp / "model"),
                                    write_location=str(tmp_path / "p")))
        jresult = jrunner.OpWorkflowRunner(
            jbuild(pd.DataFrame(cols)), score_reader=pd.DataFrame(cols)).run(
            jrunner.RunType.Score, jrunner.OpParams(
                model_location=str(tmp / "jmodel"),
                write_location=str(tmp_path / "j")))
        header, got = _scores(result.scores_location)
        jheader, want = _scores(jresult.scores_location)
        assert result.n_rows == N and header == jheader and len(got) == N
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    def test_evaluate(self, trained):
        tmp, cols, _, _ = trained
        result = OpWorkflowRunner(
            build(), evaluation_reader=dataset(cols),
            evaluator=Evaluators.BinaryClassification.auPR()).run(
            RunType.Evaluate, OpParams(model_location=str(tmp / "model")))
        jresult = jrunner.OpWorkflowRunner(
            jbuild(pd.DataFrame(cols)), evaluation_reader=pd.DataFrame(cols),
            evaluator=JEvaluators.BinaryClassification.auPR()).run(
            jrunner.RunType.Evaluate,
            jrunner.OpParams(model_location=str(tmp / "jmodel")))
        assert result.metrics["AuPR"] > 0.6
        assert abs(result.metrics["AuPR"] - jresult.metrics["AuPR"]) < 1e-6

    def test_streaming_score(self, trained, tmp_path):
        tmp, cols, _, _ = trained
        batches = [dataset(cols, 0, 100), dataset(cols, 100, 200),
                   dataset(cols, 200)]
        result = OpWorkflowRunner(
            build(),
            streaming_score_reader=StreamingReaders.Simple.iterator(batches)
        ).run(RunType.StreamingScore,
              OpParams(model_location=str(tmp / "model"),
                       write_location=str(tmp_path / "stream")))
        assert (result.n_batches, result.n_rows) == (3, N)
        assert sorted(os.listdir(tmp_path / "stream")) == [
            "scores_00000.csv", "scores_00001.csv", "scores_00002.csv"]
        with pytest.raises(ValueError, match="streaming score reader"):
            OpWorkflowRunner(build()).run(
                RunType.StreamingScore,
                OpParams(model_location=str(tmp / "model")))

    def test_features(self, trained, tmp_path):
        _, cols, _, _ = trained
        wf = build()
        result = OpWorkflowRunner(wf, train_reader=dataset(cols)).run(
            RunType.Features, OpParams(write_location=str(tmp_path / "f")))
        assert result.n_rows == N
        with open(result.scores_location) as fh:
            assert next(csv.reader(fh)) == ["label", "x1", "x2"]

    def test_stage_params_and_missing_inputs(self, trained):
        tmp, cols, _, _ = trained
        with pytest.raises(ValueError, match="model_location"):
            OpWorkflowRunner(build(), score_reader=dataset(cols)).run(
                RunType.Score)
        with pytest.raises(ValueError, match="evaluator"):
            OpWorkflowRunner(build()).run(RunType.Evaluate, OpParams(
                model_location=str(tmp / "model")))
        wf = build(dataset(cols))
        OpWorkflowRunner(wf).run(RunType.Train, OpParams(
            stage_params={"SanityChecker": {"max_correlation": 0.9}}))
        assert wf.parameters == {"SanityChecker": {"max_correlation": 0.9}}


class TestStreamingReaders:
    def _write(self, tmp_path, cols):
        watch = tmp_path / "incoming"
        watch.mkdir()
        write_csv(dataset(cols, 0, 150), str(watch / "a.csv"))
        with open(watch / "b.jsonl", "w") as fh:
            for i in range(150, 250):
                fh.write(json.dumps({k: float(v[i])
                                     for k, v in cols.items()}) + "\n")
        with open(watch / "c.json", "w") as fh:
            json.dump([{k: float(v[i]) for k, v in cols.items()}
                       for i in range(250, N)], fh)
        (watch / "_ignored.csv").write_text("label,x1,x2\n")
        return watch

    def test_file_streaming_reader_scores_every_file(self, trained,
                                                     tmp_path):
        tmp, cols, _, _ = trained
        watch = self._write(tmp_path, cols)
        result = OpWorkflowRunner(
            build(), streaming_score_reader=StreamingReaders.Simple.files(
                str(watch), max_polls=1)).run(
            RunType.StreamingScore,
            OpParams(model_location=str(tmp / "model")))
        assert (result.n_batches, result.n_rows) == (3, N)

    def test_new_files_only_and_stop(self, tmp_path):
        cols = make_cols(20)
        watch = self._write(tmp_path, {k: np.tile(v, 15)
                                       for k, v in cols.items()})
        reader = FileStreamingReader(str(watch), new_files_only=True,
                                     max_polls=2, poll_interval=0.0)
        feats = [FeatureBuilder.Real("x1").as_predictor()]
        assert list(reader.stream(feats)) == []
        reader = FileStreamingReader(str(watch), max_polls=None)
        reader.stop()
        assert list(reader.stream(feats)) == []
        with pytest.raises(NotImplementedError, match="6.3"):
            (watch / "d.parquet").write_text("")
            list(FileStreamingReader(str(watch)).stream(feats))

    def test_async_batcher_order_and_errors(self):
        assert list(AsyncBatcher(iter(range(20)), depth=3)) == list(range(20))

        def gen():
            yield 1
            raise RuntimeError("boom")

        it = iter(AsyncBatcher(gen()))
        assert next(it) == 1
        with pytest.raises(RuntimeError, match="boom"):
            list(it)


class TestAppMetrics:
    def test_handlers_and_tags(self, trained):
        tmp, cols, _, _ = trained
        seen = {}
        runner = OpWorkflowRunner(
            build(), evaluation_reader=dataset(cols),
            evaluator=Evaluators.BinaryClassification.auROC())
        runner.add_application_end_handler(
            lambda m: seen.setdefault("metrics", m))
        runner.add_application_end_handler(lambda m: 1 / 0)   # ignored
        runner.run(RunType.Evaluate, OpParams(
            model_location=str(tmp / "model"), custom_tag_name="team",
            custom_tag_value="ml"))
        m = seen["metrics"]
        assert m.custom_tags == {"team": "ml"} and m.app_duration > 0
        assert m.run_type == "evaluate" and "Scoring" in m.step_metrics
        assert set(m.to_json()) == set(jrunner.AppMetrics().to_json())

    def test_nested_job_groups_match_jax(self):
        from transmogrifai_tpu.utils import profiling as jprof

        out = []
        for prof in (jprof, None):
            coll = (prof.MetricsCollector() if prof else MetricsCollector())
            step = (prof.OpStep if prof else OpStep)
            group = (prof.with_job_group if prof else with_job_group)
            with group(step.Other, coll):
                with group(step.Scoring):
                    pass
                with group(step.Scoring):
                    pass
            m = coll.finish()
            out.append(({k: v.count for k, v in m.step_metrics.items()},
                        sorted(m.to_json()),
                        sorted(m.step_metrics["Scoring"].to_json())))
        assert out[0] == out[1]
        assert out[1][0] == {"Other": 1, "Scoring": 2}
        assert [s.name for s in OpStep] == [s.name for s in jprof.OpStep]
        coll = MetricsCollector()
        with install_collector(coll):
            with with_job_group(OpStep.ModelIO):
                pass
        assert list(coll.metrics.step_metrics) == ["ModelIO"]


class TestOpApp:
    def test_argv_and_param_file(self, trained, tmp_path):
        tmp, cols, _, _ = trained
        ran = {}

        class App(OpApp):
            def runner(self):
                ran["runner"] = True
                return OpWorkflowRunner(
                    build(), evaluation_reader=dataset(cols),
                    evaluator=Evaluators.BinaryClassification.auPR())

        result = App().main([
            "--run-type", "evaluate", "--model-location", str(tmp / "model"),
            "--metrics-location", str(tmp_path / "m")])
        assert ran and result.metrics["AuPR"] > 0.6
        assert os.path.exists(tmp_path / "m" / "op_metrics.json")
        pfile = tmp_path / "params.json"
        pfile.write_text(json.dumps({
            "modelLocation": str(tmp / "model"),
            "writeLocation": str(tmp_path / "w"),
            "customTagName": "k", "customTagValue": "v"}))
        params = OpParams.from_file(str(pfile))
        assert params.to_json() == jrunner.OpParams.from_file(
            str(pfile)).to_json()
        result = App().main(["--run-type", "evaluate", "--param-location",
                             str(pfile)])
        assert result.app_metrics.custom_tags == {"k": "v"}
        assert os.path.exists(tmp_path / "w" / "scores.csv")
        with pytest.raises(SystemExit):
            App().main(["--run-type", "nope"])
        with pytest.raises(NotImplementedError):
            OpApp().runner()
