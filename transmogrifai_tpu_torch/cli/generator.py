"""Project codegen — renders the generated app's files (counterpart of
``transmogrifai_tpu.cli.generator``: the same files under the same
names, importing ``transmogrifai_tpu_torch``).

Reference: ``gen/ProjectGenerator.scala`` and its templates.  The project
is a Python package: ``features.py`` (typed feature declarations),
``app.py`` (an ``OpApp`` wiring transmogrify -> SanityChecker -> the
problem's ModelSelector), ``run.py`` (the entry point, reading the data
through the port's ``CSVReader``) and a smoke test that trains on the CPU.
"""
from __future__ import annotations

import os
import re
from typing import Dict

from .schema import ProblemKind, ProblemSchema

__all__ = ["generate_project"]

_SELECTORS = {
    ProblemKind.BinaryClassification: ("BinaryClassificationModelSelector",
                                       "Evaluators.BinaryClassification."
                                       "auPR()",
                                       "OpLogisticRegression"),
    ProblemKind.MultiClassification: ("MultiClassificationModelSelector",
                                      "Evaluators.MultiClassification.f1()",
                                      "OpLogisticRegression"),
    ProblemKind.Regression: ("RegressionModelSelector",
                             "Evaluators.Regression.rmse()",
                             "OpLinearRegression"),
}


def _snake(name: str) -> str:
    s = re.sub(r"[^0-9a-zA-Z]+", "_", name)
    s = re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", s).lower().strip("_")
    if not s or s[0].isdigit():
        raise ValueError(f"cannot derive a module name from {name!r}")
    return s


def generate_project(schema: ProblemSchema, dest: str,
                     overwrite: bool = False) -> Dict[str, str]:
    """Write the generated project under ``dest/<snake_name>``; returns
    {relative path: absolute path} of everything written."""
    pkg = _snake(schema.name)
    root = os.path.join(dest, pkg)
    if os.path.exists(root) and not overwrite:
        raise FileExistsError(f"{root} exists (pass --overwrite)")
    os.makedirs(os.path.join(root, "tests"), exist_ok=True)

    selector, evaluator, smoke_model = _SELECTORS[schema.kind]
    input_path = schema.input_path or f"{schema.name}.csv"
    files = {
        "features.py": _FEATURES_TPL.format(
            name=schema.name, response=schema.response,
            id_field=schema.id_field,
            feature_map="\n".join(schema.feature_lines),
            levels=repr(schema.response_levels)),
        "app.py": _APP_TPL.format(
            name=schema.name, pkg=pkg, selector=selector,
            evaluator=evaluator, kind=schema.kind.value),
        "run.py": _RUN_TPL.format(
            name=schema.name, pkg=pkg, columns=repr(schema.columns),
            input_path=input_path),
        "__init__.py": ('"""Generated by python -m transmogrifai_tpu_torch '
                        'gen."""\n'),
        os.path.join("tests", "test_app.py"): _TEST_TPL.format(
            name=schema.name, pkg=pkg, smoke_model=smoke_model,
            input_path=input_path),
        "README.md": _README_TPL.format(
            name=schema.name, pkg=pkg, kind=schema.kind.value,
            response=schema.response, id_field=schema.id_field,
            n_features=len(schema.features)),
    }
    written = {}
    for rel, content in files.items():
        path = os.path.join(root, rel)
        with open(path, "w") as fh:
            fh.write(content)
        written[rel] = path
    return written


_FEATURES_TPL = '''"""Typed feature declarations for {name} (generated).

Edit the semantic types below to refine what inference guessed — they drive
which vectorizer ``transmogrify`` picks for each column.
"""
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.types import feature_types as ft

RESPONSE = "{response}"
ID_FIELD = "{id_field}"
#: the response's levels when the sample held it as text (run.py recodes
#: level i to i); None when it is numeric
RESPONSE_LEVELS = {levels}

SCHEMA = {{
{feature_map}
}}


def build_features():
    """-> (response_feature, [predictor features])"""
    return FeatureBuilder.from_schema(
        dict(SCHEMA, **{{RESPONSE: ft.RealNN}}), RESPONSE, ft.RealNN)
'''

_APP_TPL = '''"""{name} — generated {kind} app."""
from transmogrifai_tpu_torch.evaluators import Evaluators
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.selector import {selector}
from transmogrifai_tpu_torch.workflow import OpWorkflow
from transmogrifai_tpu_torch.workflow.runner import OpApp, OpWorkflowRunner

from .features import build_features


def build_workflow(models_and_parameters=None):
    """-> (workflow, label feature, prediction feature).

    ``models_and_parameters`` overrides the default AutoML grid
    ([(estimator, [param dicts])], see selector.grid).
    """
    label, predictors = build_features()
    feature_vector = transmogrify(predictors)
    checked = SanityChecker().set_input(label, feature_vector).get_output()
    prediction = {selector}.with_cross_validation(
        models_and_parameters=models_and_parameters).set_input(
        label, checked).get_output()
    return OpWorkflow().set_result_features(prediction), label, prediction


class App(OpApp):
    app_name = "{name}"

    def __init__(self, reader=None):
        self.reader = reader

    def runner(self) -> OpWorkflowRunner:
        workflow, _, _ = build_workflow()
        if self.reader is not None:
            workflow.set_reader(self.reader)
        return OpWorkflowRunner(workflow, score_reader=self.reader,
                                evaluation_reader=self.reader,
                                evaluator={evaluator})
'''

_RUN_TPL = '''#!/usr/bin/env python
"""Entry point: python run.py --run-type train --model-location /tmp/{pkg}

``--input PATH`` reads another file of the sample's shape; ``--device cpu``
runs on the CPU (the default is the card).
"""
import os
import sys

# make the generated package importable when run.py is executed in place
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.readers import CSVReader, Reader
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import FeatureColumn

from {pkg}.app import App
from {pkg}.features import RESPONSE, RESPONSE_LEVELS

COLUMNS = {columns}


class SampleReader(Reader):
    """The CSV through the port's ``CSVReader``: its first ``limit`` rows
    (all for None), a text response recoded to its level's index."""

    def __init__(self, path: str, limit: int = None):
        self.path = path
        self.limit = limit
        self.csv = (CSVReader(path, column_names=COLUMNS, has_header=False)
                    if COLUMNS else CSVReader(path))

    def generate_dataset(self, raw_features):
        recode = RESPONSE_LEVELS is not None
        feats = [FeatureBuilder.Text(f.name).as_predictor()
                 if recode and f.name == RESPONSE else f
                 for f in raw_features]
        data = self.csv.generate_dataset(feats)
        if self.limit is not None:
            data = data.slice(0, min(self.limit, len(data)))
        if recode and RESPONSE in data:
            levels = {{v: float(i) for i, v in enumerate(RESPONSE_LEVELS)}}
            data = data.with_columns({{RESPONSE: FeatureColumn.from_values(
                ft.RealNN, [levels.get(v) for v in data[RESPONSE].values])}})
        return data


def make_reader(path: str, limit: int = None):
    return SampleReader(path, limit)


def _take(argv, flag):
    if flag not in argv:
        return None
    i = argv.index(flag)
    if i + 1 >= len(argv):
        raise SystemExit(f"{{flag}} requires a value")
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


if __name__ == "__main__":
    argv = list(sys.argv[1:])
    data = _take(argv, "--input") or r"{input_path}"
    device = _take(argv, "--device")
    if device:
        tt.set_device(device)
    result = App(reader=make_reader(data)).main(argv)
    print(result.summary or result.metrics)
'''

_TEST_TPL = '''"""Smoke test for the generated {name} app (generated); it trains on
the CPU."""
import os
import sys

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_here, os.pardir))          # run.py
sys.path.insert(0, os.path.join(_here, os.pardir, os.pardir))  # the package

import transmogrifai_tpu_torch as tt  # noqa: E402

from {pkg}.app import build_workflow  # noqa: E402


def test_train_end_to_end():
    from run import make_reader

    from transmogrifai_tpu_torch.models import {smoke_model}
    from transmogrifai_tpu_torch.selector import grid

    tt.set_device("cpu")
    # smoke subsample + one-model grid; run.py does the full sweep
    reader = make_reader(r"{input_path}", limit=200)
    workflow, _, prediction = build_workflow(
        models_and_parameters=[({smoke_model}(), grid(reg_param=[0.01]))])
    workflow.set_reader(reader)
    model = workflow.train()
    scores = model.score()
    assert len(scores[prediction.name]) == len(model.train_data)
'''

_README_TPL = '''# {name}

Generated by ``python -m transmogrifai_tpu_torch gen`` — a {kind} pipeline
predicting **{response}** (id column: {id_field}, {n_features} predictors).

```
python run.py --run-type train --model-location /tmp/{pkg}_model
python run.py --run-type score --model-location /tmp/{pkg}_model \\
    --write-location /tmp/{pkg}_scores
```

``--device cpu`` runs on the CPU; the default is the CUDA card.  Refine
the inferred semantic types in ``{pkg}/features.py``; the AutoML defaults
(transmogrify -> SanityChecker -> ModelSelector grids) live in
``{pkg}/app.py``.
'''
