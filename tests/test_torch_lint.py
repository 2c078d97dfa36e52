"""The DAG lint (rules TM001-TM006) and ``train(validate=True)`` in the port
against the JAX package, on the CPU.

Each case wires the same DAG in both packages and holds the findings to
the same rule ids, severities, stage positions and counts (uids are
numbered from 1 in both, so the messages are equal too, up to the class
locations).  ``train()`` refuses an erroring DAG before any data is read,
and a clean DAG trains with the same lint snapshot (rule counts and
warnings, up to the file paths of the locations).  ``# tmog: disable=``
suppression is checked on a file site in both packages."""
import itertools
import re

import numpy as np
import pandas as pd
import pytest

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.analysis import PipelineLintError as JLintError
from transmogrifai_tpu.analysis import linter as jlinter
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.features.feature import Feature as JFeature
from transmogrifai_tpu.ops.vectorizers import RealVectorizer as JRealVec
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JChecker
from transmogrifai_tpu.stages.base import UnaryTransformer as JUnary
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow.dag import StagesDAG as JDAG
from transmogrifai_tpu.workflow.dag import compute_dag as jcompute
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu_torch.analysis import PipelineLintError
from transmogrifai_tpu_torch.analysis import linter
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.features.feature import Feature
from transmogrifai_tpu_torch.ops.vectorizers import RealVectorizer
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.stages.base import UnaryTransformer
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import FeatureColumn
from transmogrifai_tpu_torch.utils import uid as tuid
from transmogrifai_tpu_torch.workflow.dag import StagesDAG, compute_dag
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


def _pass_through(unary, real, column):
    class _PassThrough(unary):
        def __init__(self, uid=None):
            super().__init__(operation_name="passthru", output_type=real,
                             uid=uid)

        def transform_columns(self, col):
            return column(real, np.array(col.values, copy=True),
                          np.array(col.mask, copy=True))

    class _FixedName(_PassThrough):
        def __init__(self, forced_name, uid=None):
            super().__init__(uid=uid)
            self.forced_name = forced_name

        def make_output_name(self):
            return self.forced_name

    return _PassThrough, _FixedName


_JPass, _JFixed = _pass_through(JUnary, jft.Real, JColumn)
_TPass, _TFixed = _pass_through(UnaryTransformer, ft.Real, FeatureColumn)

JAX = dict(fb=JFB, feature=JFeature, vec=JRealVec, checker=JChecker,
           dag=JDAG, compute=jcompute, workflow=JWorkflow, ft=jft,
           passthru=_JPass, fixed=_JFixed, uid=juid, lint=jlinter.lint_dag,
           error=JLintError, suppressed_at=jlinter._suppressed_at)
PORT = dict(fb=FeatureBuilder, feature=Feature, vec=RealVectorizer,
            checker=SanityChecker, dag=StagesDAG, compute=compute_dag,
            workflow=OpWorkflow, ft=ft, passthru=_TPass, fixed=_TFixed,
            uid=tuid, lint=linter.lint_dag, error=PipelineLintError,
            suppressed_at=linter._suppressed_at)


def _reals(pkg, *names, response=None):
    pkg["uid"]._counter = itertools.count(1)
    return [pkg["fb"].RealNN(n).as_response() if n == response
            else pkg["fb"].Real(n).as_predictor() for n in names]


def _gen(f):
    return f.origin_stage


# each case: pkg -> (dag, result features or None); the same wiring in both

def _tm001(p):
    a, b = _reals(p, "a", "b")
    s = p["passthru"]().set_input(b)
    return p["dag"]([[_gen(a)], [s]]), None


def _tm001_renamed(p):
    # an input whose name no stage produces (its origin lost by surgery)
    (a,) = _reals(p, "a")
    ghost = p["feature"](name="ghost", ftype=p["ft"].Real,
                         origin_stage=_gen(a), parents=[])
    s = p["passthru"]().set_input(ghost)
    return p["compute"]([s.get_output()]), [s.get_output()]


def _tm002(p):
    (a,) = _reals(p, "a")
    s = p["fixed"]("a").set_input(a)
    return p["dag"]([[_gen(a)], [s]]), None


def _tm003(p):
    (a,) = _reals(p, "a")
    s1 = p["fixed"]("dup").set_input(a)
    s2 = p["fixed"]("dup").set_input(a)
    return p["dag"]([[_gen(a)], [s1, s2]]), None


def _tm004(p):
    (a,) = _reals(p, "a")
    t = p["fb"].Text("t").as_predictor()
    vec = p["vec"]().set_input(a)
    vec.input_features = [t]
    return p["dag"]([[_gen(t)], [vec]]), None


def _tm005(p):
    a, b = _reals(p, "a", "b")
    sa = p["passthru"]().set_input(a)
    sb = p["passthru"]().set_input(b)
    return (p["compute"]([sa.get_output(), sb.get_output()]),
            [sa.get_output()])


def _tm006_featurizer(p):
    survived, age = _reals(p, "Survived", "Age", response="Survived")
    leaky = p["vec"]().set_input(survived, age)
    return p["compute"]([leaky.get_output()]), None


def _tm006_through_transform(p):
    (survived,) = _reals(p, "Survived", response="Survived")
    rescaled = p["passthru"]().set_input(survived)
    leaky = p["vec"]().set_input(rescaled.get_output())
    return p["compute"]([leaky.get_output()]), None


def _tm006_checker_predictor_slot(p):
    survived, age = _reals(p, "Survived", "Age", response="Survived")
    leaky_vec = p["vec"]().set_input(survived, age)
    checked = p["checker"]().set_input(survived, leaky_vec.get_output())
    return p["compute"]([checked.get_output()]), [checked.get_output()]


def _label_slot_absorbs(p):
    survived, age = _reals(p, "Survived", "Age", response="Survived")
    vec = p["vec"]().set_input(age)
    checked = p["checker"]().set_input(survived, vec.get_output())
    return p["compute"]([checked.get_output()]), [checked.get_output()]


def _many(p):
    """Several rules at once: a dead stage, a duplicate and a leak."""
    survived, a, b = _reals(p, "Survived", "a", "b", response="Survived")
    s1 = p["fixed"]("dup").set_input(a)
    s2 = p["fixed"]("dup").set_input(b)
    leaky = p["vec"]().set_input(survived, a)
    dead = p["passthru"]().set_input(b)
    dag = p["compute"]([s1.get_output(), s2.get_output(),
                        leaky.get_output(), dead.get_output()])
    return dag, [leaky.get_output(), s1.get_output()]


CASES = {
    "TM001": (_tm001, {"TM001": 1}),
    "TM001_renamed": (_tm001_renamed, {"TM001": 1}),
    "TM002": (_tm002, {"TM002": 1}),
    "TM003": (_tm003, {"TM003": 1}),
    "TM004": (_tm004, {"TM004": 1}),
    "TM005": (_tm005, {"TM005": 1}),
    "TM006_featurizer": (_tm006_featurizer, {"TM006": 1}),
    "TM006_through_transform": (_tm006_through_transform, {"TM006": 1}),
    "TM006_checker": (_tm006_checker_predictor_slot, {"TM006": 1}),
    "label_slot": (_label_slot_absorbs, {}),
    # s2 is dead too: "dup" resolves to s1
    "many": (_many, {"TM003": 1, "TM005": 2, "TM006": 1}),
}


def _summary(findings):
    """(rule, severity, stage's DAG layer and position, message without
    the class location) per finding."""
    return [(d.rule, d.severity, d.stage_uid, d.message) for d in findings]


def _uids_as_positions(dag, summary):
    pos = {s.uid: (li, si) for li, layer in enumerate(dag.layers)
           for si, s in enumerate(layer)}
    return [(r, sev, pos.get(uid), msg) for r, sev, uid, msg in summary]


@pytest.mark.parametrize("case", sorted(CASES))
def test_rules_agree(case):
    build, expected = CASES[case]
    jdag, jres = build(JAX)
    tdag, tres = build(PORT)
    jf = JAX["lint"](jdag, result_features=jres)
    tf = PORT["lint"](tdag, result_features=tres)
    assert (_uids_as_positions(tdag, _summary(tf))
            == _uids_as_positions(jdag, _summary(jf)))
    assert {r: len(tf.by_rule(r)) for r in tf.rules_fired()} == expected
    assert len(tf.errors) == len(jf.errors)
    assert len(tf.warnings) == len(jf.warnings)
    # the location names the port's class, by file and line
    for d in tf:
        assert d.location is None or "transmogrifai_tpu/" not in d.location


def test_suppress_argument():
    for pkg in (JAX, PORT):
        dag, _ = _tm001(pkg)
        assert len(pkg["lint"](dag, suppress=["TM001"])) == 0
        assert pkg["lint"](dag, suppress=["TM002"]).rules_fired() == [
            "TM001"]


def test_disable_comment(tmp_path):
    src = tmp_path / "site.py"
    src.write_text("x = 1\n"
                   "y = feature(  # tmog: disable=TM060, TM006\n"
                   "    2)\n"
                   "z = 3  # tmog: disable=TM001\n")
    for pkg in (JAX, PORT):
        at = pkg["suppressed_at"]
        assert at("TM060", f"{src}:2")
        assert at("TM006", f"{src}:2")
        assert at("TM001", f"{src}:4")
        assert not at("TM001", f"{src}:2")
        assert not at("TM060", f"{src}:1")
        assert not at("TM060", None)
        assert not at("TM060", f"{tmp_path}/missing.py:2")


def _frame():
    rng = np.random.default_rng(3)
    n = 200
    age = rng.normal(40, 10, n)
    return pd.DataFrame({"Survived": (rng.random(n) < 0.4).astype(float),
                         "Age": age, "Fare": rng.lognormal(3, 1, n)})


def test_train_refuses_before_reading(monkeypatch):
    for pkg in (JAX, PORT):
        survived, age = _reals(pkg, "Survived", "Age", response="Survived")
        leaky = pkg["vec"]().set_input(survived, age)
        wf = (pkg["workflow"]().set_result_features(leaky.get_output())
              .set_input_data(_frame()))
        with pytest.raises(pkg["error"]) as ei:
            wf.train()
        assert ei.value.findings.rules_fired() == ["TM006"]
    # the port's lint raises before any data is read
    survived, age = _reals(PORT, "Survived", "Age", response="Survived")
    leaky = RealVectorizer().set_input(survived, age)
    wf = OpWorkflow().set_result_features(leaky.get_output())
    wf.set_input_data(_frame())

    def no_read(*a, **k):
        raise AssertionError("data read before the lint")

    monkeypatch.setattr(wf.reader, "generate_dataset", no_read)
    with pytest.raises(PipelineLintError):
        wf.train()


def test_train_refuses_dangling_input():
    (a,) = _reals(PORT, "Age")
    ghost = Feature(name="ghost", ftype=ft.Real, origin_stage=_gen(a),
                    parents=[])
    vec = RealVectorizer().set_input(ghost)
    wf = OpWorkflow().set_result_features(vec.get_output())
    wf.set_input_data(_frame())
    with pytest.raises(PipelineLintError) as ei:
        wf.train()
    assert ei.value.findings.rules_fired() == ["TM001"]
    # validate=False opts out of the lint (and then fails on the data)
    with pytest.raises(KeyError):
        wf.train(validate=False)


def _clean_pipeline(pkg, extra_result):
    survived, age, fare = _reals(pkg, "Survived", "Age", "Fare",
                                 response="Survived")
    vec = pkg["vec"]().set_input(age, fare)
    checked = pkg["checker"]().set_input(survived, vec.get_output())
    results = [checked.get_output()]
    if extra_result:
        results.append(pkg["passthru"]().set_input(age).get_output())
    return results


@pytest.mark.parametrize("extra_result", [False, True])
def test_clean_train_snapshot(extra_result):
    snaps = []
    for pkg in (JAX, PORT):
        wf = (pkg["workflow"]().set_result_features(
            *_clean_pipeline(pkg, extra_result)).set_input_data(_frame()))
        model = wf.train()
        snap = model.lint_snapshot
        assert snap is not None and snap.wall_s >= 0
        snaps.append(snap)
    jsnap, tsnap = snaps
    assert tsnap.rule_counts == jsnap.rule_counts
    strip = [re.sub(r"^\S+: ", "", w) for w in tsnap.warnings]
    assert strip == [re.sub(r"^\S+: ", "", w) for w in jsnap.warnings]
    assert set(tsnap.to_json()) == set(jsnap.to_json())
    assert tsnap.format().startswith("dag lint: ")
