"""The project generator and the CLI of the port (``cli/``,
``__main__.py``) against the JAX package's, on the CPU, on generated CSV
and JSON-lines samples (the Titanic columns of ``chip_smoke``, never a
file outside the repo).

Checked: the inferred schema (every column's feature type) and problem
kind equal ``transmogrifai_tpu.cli.ProblemSchema.from_file``'s (pandas'
typing) for headed, headerless and JSON-lines samples and with type
overrides; ``gen`` writes the same files under the same names; the
generated app trains, evaluates and scores on the CPU in-process;
``serve --score-jsonl`` scores rows as the local scorer does (within
1e-6); ``trace FILE`` prints the JAX package's summary of the same
file; ``lint`` and ``pod`` raise naming their ROADMAP items.
"""
import ast
import csv
import importlib.util
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pandas as pd
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu import cli as jcli
from transmogrifai_tpu_torch import cli as pcli
from transmogrifai_tpu_torch.cli import main as pmain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

ROWS = 300


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def titanic_cols(n=ROWS):
    cols, _ = chip_smoke.titanic_columns(n)
    rng = np.random.default_rng(3)
    return {"PassengerId": np.arange(1, n + 1), **cols,
            "Vip": np.where(rng.random(n) < 0.1, "True", "False"),
            "Flag": rng.integers(0, 2, n), "Deck": rng.integers(1, 8, n)}


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    cols = titanic_cols()
    headed = str(tmp / "titanic.csv")
    chip_smoke.write_ooc_csv(headed, cols, 0, ROWS)
    headerless = str(tmp / "titanic_nohead.csv")
    with open(headed) as src, open(headerless, "w") as dst:
        next(src)
        dst.writelines(src)
    jsonl = str(tmp / "titanic.jsonl")
    with open(jsonl, "w") as fh:
        for i in range(ROWS):
            fh.write(json.dumps({k: (None if (isinstance(v[i], float)
                                              and v[i] != v[i]) else
                                     (v[i].item() if hasattr(v[i], "item")
                                      else v[i]))
                                 for k, v in cols.items()}) + "\n")
    return {"headed": headed, "headerless": headerless, "jsonl": jsonl,
            "cols": list(cols), "tmp": tmp}


def _schema(mod, path, **kw):
    s = mod.ProblemSchema.from_file("Titanic", path, kw.pop("response",
                                                          "Survived"),
                                    kw.pop("id_field", "PassengerId"), **kw)
    return (s.kind.value, {k: t.__name__ for k, t in s.features.items()},
            s.feature_lines, s.columns)


@pytest.mark.parametrize("case", ["headed", "headerless", "jsonl",
                                  "overrides", "kind", "regression",
                                  "multiclass"])
def test_schema_and_kind_equal_jax(samples, case):
    kw = {}
    path = samples["headed"]
    if case == "headerless":
        path, kw["columns"] = samples["headerless"], samples["cols"]
    elif case == "jsonl":
        path = samples["jsonl"]
    elif case == "overrides":
        kw["overrides"] = {"Age": "text", "Fare": "Integral"}
    elif case == "kind":
        kw["kind"] = "Regression"
    elif case == "regression":
        kw["response"] = "Fare"
    elif case == "multiclass":
        kw["response"] = "Deck"
    assert _schema(pcli, path, **dict(kw)) == _schema(jcli, path, **kw)


def test_schema_types_every_column(samples):
    kind, types, _, _ = _schema(pcli, samples["headed"])
    assert kind == "BinaryClassification"
    assert types == {"Pclass": "Integral", "Name": "Text", "Sex": "PickList",
                     "Age": "Real", "SibSp": "Real", "Parch": "Real",
                     "Ticket": "Text", "Fare": "Real",
                     "Cabin": "Text", "Embarked": "PickList",
                     "Vip": "Binary", "Flag": "Binary", "Deck": "Integral"}
    with pytest.raises(ValueError, match="nope"):
        pcli.ProblemSchema.from_file("T", samples["headed"], "nope",
                                     "PassengerId")
    with pytest.raises(ValueError, match="unknown feature type"):
        pcli.ProblemSchema.from_file("T", samples["headed"], "Survived",
                                     "PassengerId",
                                     overrides={"Age": "Nope"})


@pytest.mark.parametrize("values", [
    [0, 1, 1, 0], [1, 2, 3] * 10, [1.5, 2.25, 3.75, 10.1], list("abcabcabd"),
    [1.0, 2.0, 3.0, 4.0], list(range(40)), [True, False, True],
    [1.0, None, 2.0, 3.0, 5.0], ["x", None, "y"]])
def test_problem_kind_equals_jax(values):
    assert pcli.infer_problem_kind(values).value == \
        jcli.infer_problem_kind(pd.Series(values)).value


def _rel_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if not f.endswith(".pyc") and "__pycache__" not in d)


def _load_project(root, name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_run", os.path.join(root, "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    return run, sys.modules[f"{os.path.basename(root)}.app"]


def test_gen_writes_the_jax_files_and_the_app_runs(samples, tmp_path,
                                                   monkeypatch):
    for mod, dest in ((jcli, "jax"), (pcli, "port")):
        schema = mod.ProblemSchema.from_file("Titanic", samples["headed"],
                                             "Survived", "PassengerId")
        mod.generate_project(schema, str(tmp_path / dest))
    root = str(tmp_path / "port" / "titanic")
    assert _rel_files(root) == _rel_files(str(tmp_path / "jax" / "titanic"))
    with open(os.path.join(root, "app.py")) as fh:
        app_src = fh.read()
    assert "transmogrifai_tpu_torch" in app_src
    assert "import transmogrifai_tpu\n" not in app_src
    with open(os.path.join(root, "run.py")) as fh:
        assert "pandas" not in fh.read()
    with pytest.raises(FileExistsError):
        pcli.generate_project(schema, str(tmp_path / "port"))

    monkeypatch.syspath_prepend(str(tmp_path / "port"))
    run, app = _load_project(root, "titanic")
    # the generated smoke test, in this process (it asks for the CPU)
    spec = importlib.util.spec_from_file_location(
        "titanic_test_app", os.path.join(root, "tests", "test_app.py"))
    gen_test = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen_test)
    gen_test.test_train_end_to_end()

    from transmogrifai_tpu_torch.models import OpLogisticRegression
    from transmogrifai_tpu_torch.selector import grid

    default = app.build_workflow
    monkeypatch.setattr(app, "build_workflow", lambda: default(
        models_and_parameters=[(OpLogisticRegression(),
                                grid(reg_param=[0.01, 0.1]))]))
    reader = run.make_reader(samples["headed"])
    model_dir = str(tmp_path / "model")
    trained = app.App(reader=reader).main(
        ["--run-type", "train", "--model-location", model_dir])
    assert any("model_selector_summary" in v
               for v in trained.summary.values())
    ev = app.App(reader=reader).main(
        ["--run-type", "evaluate", "--model-location", model_dir,
         "--write-location", str(tmp_path / "ev")])
    assert 0.5 < ev.metrics["AuPR"] <= 1.0
    sc = app.App(reader=run.make_reader(samples["headed"], limit=50)).main(
        ["--run-type", "score", "--model-location", model_dir,
         "--write-location", str(tmp_path / "sc")])
    with open(ev.scores_location) as a, open(sc.scores_location) as b:
        ra, rb = list(csv.reader(a))[1:51], list(csv.reader(b))[1:]
    # 50 rows score in another float32 matmul than 300: within 1e-6
    assert sc.n_rows == 50 and [r[0] for r in ra] == [r[0] for r in rb]
    np.testing.assert_allclose(
        [ast.literal_eval(r[1])["probability_1"] for r in rb],
        [ast.literal_eval(r[1])["probability_1"] for r in ra], rtol=0,
        atol=1e-6)

    # serve: offline over a JSONL file of rows, against the model's scores
    # a client sends a boolean as a boolean (the sample holds its text)
    rows = [{k: (v == "True" if k == "Vip" else v)
             for k, v in json.loads(line).items()
             if k not in ("Survived", "PassengerId")}
            for line in open(samples["jsonl"]).readlines()[:20]]
    rows_path = str(tmp_path / "rows.jsonl")
    with open(rows_path, "w") as fh:
        fh.writelines(json.dumps(r) + "\n" for r in rows)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert pmain(["serve", "--model", model_dir, "--device", "cpu",
                      "--score-jsonl", rows_path, "--max-batch", "8"]) == 0
    served = [json.loads(line) for line in buf.getvalue().splitlines()]
    want = [ast.literal_eval(r[1])["probability_1"] for r in ra[:20]]
    got = [next(iter(s.values()))["probability_1"] for s in served]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_text_response_is_recoded_by_the_generated_reader(samples, tmp_path,
                                                          monkeypatch):
    cols = titanic_cols(120)
    cols["Survived"] = np.where(cols["Survived"] > 0, "yes", "no")
    path = str(tmp_path / "text_label.csv")
    chip_smoke.write_ooc_csv(path, cols, 0, 120)
    schema = pcli.ProblemSchema.from_file("TextLabel", path, "Survived",
                                          "PassengerId")
    assert schema.kind.value == jcli.ProblemSchema.from_file(
        "TextLabel", path, "Survived", "PassengerId").kind.value
    assert schema.response_levels == ["no", "yes"] or \
        schema.response_levels == ["yes", "no"]
    pcli.generate_project(schema, str(tmp_path))
    monkeypatch.syspath_prepend(str(tmp_path))
    run, _ = _load_project(str(tmp_path / "text_label"), "text_label")
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder
    ds = run.make_reader(path, limit=30).generate_dataset(
        [FeatureBuilder.RealNN("Survived").as_response()])
    levels = {v: float(i) for i, v in enumerate(schema.response_levels)}
    assert ds["Survived"].to_list() == [levels[v]
                                        for v in cols["Survived"][:30]]


def test_regression_template_and_the_module_entry(samples, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "transmogrifai_tpu_torch", "gen", "Houses",
         "--input", samples["headed"], "--id", "PassengerId",
         "--response", "Fare", "--dest", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Regression project 'Houses': 6 files" in proc.stdout
    with open(tmp_path / "houses" / "app.py") as fh:
        assert "RegressionModelSelector" in fh.read()


@pytest.mark.parametrize("command,item", [("lint", "6.8"), ("pod", "6.7")])
def test_unported_subcommands_name_their_items(command, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        pmain([command, "anything"])
    with pytest.raises(SystemExit):
        pmain(["nope"])


def _trace_file(tmp_path) -> str:
    """A traced run's Chrome trace, written by the port's exporter."""
    from transmogrifai_tpu_torch import obs

    tracer = obs.start_trace("cli")
    try:
        with obs.span("workflow.train", cat="workflow"):
            for i in range(4):
                with obs.span(f"stage:S{i}", cat="stage", i=i):
                    obs.record_event("fault.fired", index=i)
    finally:
        obs.stop_trace()
    path = str(tmp_path / "trace.json")
    with open(path, "w") as fh:
        json.dump(obs.to_chrome_trace(tracer), fh)
    return path


@pytest.mark.parametrize("top", [None, 2])
def test_trace_prints_the_jax_summary(tmp_path, top):
    from transmogrifai_tpu.obs.export import summarize_file

    path = _trace_file(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "transmogrifai_tpu_torch", "trace", path]
    if top is not None:
        cmd += ["--top", str(top)]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    expected = summarize_file(path, top_k=15 if top is None else top)
    assert proc.stdout == expected + "\n"
    assert "workflow.train" in proc.stdout
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "?"}]}))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert pmain(["trace", str(bad)]) == 1
    assert buf.getvalue() == ""


def _typing_samples(tmp_path, n=80):
    """80 rows of a JSON-lines and a CSV sample whose columns pandas types
    in ways a plain parser would not: epoch-ms and ISO date columns under
    date-like names, padded integers, a True/1/0 mix, digits with
    underscores."""
    jsonl = str(tmp_path / "dates.jsonl")
    with open(jsonl, "w") as fh:
        for i in range(n):
            fh.write(json.dumps({
                "id": i, "y": i % 2,
                "signup_time": 1600000000000 + i * 86400000,
                "date": "2020-02-%02d" % (i % 28 + 1)}) + "\n")
    path = str(tmp_path / "cells.csv")
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["id", "y", "padded", "flag_mix", "code"])
        for i in range(n):
            w.writerow([i, i % 2, f" {i % 7}", ["True", "1", "0"][i % 3],
                        f"{i}_{i % 4}"])
    return {"signup_time": jsonl, "date": jsonl, "padded": path,
            "flag_mix": path, "code": path}


@pytest.mark.parametrize("column,expected", [
    ("signup_time", "DateTime"), ("date", "DateTime"),
    ("padded", "Integral"), ("flag_mix", "PickList"), ("code", "Text")])
def test_sample_columns_type_as_pandas_does(tmp_path, column, expected):
    """Each column of the repaired schema inference types as the JAX
    package's pandas reads type it, and the whole sample's schema is
    equal."""
    path = _typing_samples(tmp_path)[column]
    port = pcli.ProblemSchema.from_file("S", path, "y", "id").features
    jax = jcli.ProblemSchema.from_file("S", path, "y", "id").features
    assert port[column].__name__ == jax[column].__name__ == expected
    assert {k: t.__name__ for k, t in port.items()} == {
        k: t.__name__ for k, t in jax.items()}
