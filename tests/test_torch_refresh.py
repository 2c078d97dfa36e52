"""The port's warm-start refresh (``OpWorkflow.refresh``,
``workflow/refresh.py``) against the JAX package's, on the CPU, mirroring
``tests/test_refresh.py::TestRefresh``: a Titanic-shaped frame of 400
numpy-seeded rows (7 raw features) -> transmogrify -> SanityChecker ->
naive Bayes, trained chunked (64 rows), then refreshed from new windows.

Integers and structure match exactly: each refresh report (merged, refit,
invalidated, geometry changed, by uid), the vocabularies, the geometry
signatures and the passes.  Floats: the refreshed probabilities within
1e-5 of the JAX package's (naive Bayes sums a float32 product a chunk on
either side; ROADMAP "Streamed naive Bayes sums" holds the likelihoods
to 1e-5 and probabilities to 1e-4), the JAX test's 0.05 against a full
streaming train over old and new rows, a resumed refresh bitwise.  A
refresh leaves the base model's states as they were (the deep copy), so
two refreshes from one base agree bitwise; the RawFeatureFilter guard
and a loaded model's filter results (its JSON form) are tested last.
"""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models.classification import OpNaiveBayes as JNB
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JSanityChecker
from transmogrifai_tpu.utils import faults as jfaults
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow import checkpoint as jckpt
from transmogrifai_tpu.workflow import refresh as jrefresh
from transmogrifai_tpu.workflow.persistence import \
    load_workflow_model as jload
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.models.classification import OpNaiveBayes
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.utils import faults
from transmogrifai_tpu_torch.utils import uid as tuid
from transmogrifai_tpu_torch.utils.profiling import refresh_snapshot
from transmogrifai_tpu_torch.workflow import checkpoint as tckpt
from transmogrifai_tpu_torch.workflow import refresh as trefresh
from transmogrifai_tpu_torch.workflow.persistence import load_workflow_model
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

#: port against JAX package, refreshed probabilities
PKG_TOL = 1e-5
#: the JAX test's refresh-against-full-retrain bound
RETRAIN_TOL = 0.05

JAX = dict(fb=JFB, transmogrify=jtransmogrify, checker=JSanityChecker,
           nb=JNB, workflow=JWorkflow, uid=juid, faults=jfaults, ckpt=jckpt,
           load=jload, refresh=jrefresh)
PORT = dict(fb=FeatureBuilder, transmogrify=transmogrify,
            checker=SanityChecker, nb=OpNaiveBayes, workflow=OpWorkflow,
            uid=tuid, faults=faults, ckpt=tckpt, load=load_workflow_model,
            refresh=trefresh)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


def make_df(rows, seed=7, age_shift=0.0, male_p=0.65):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "Survived": (rng.random(rows) > 0.62).astype(float),
        "Pclass": rng.choice(["1", "2", "3"], rows, p=[0.24, 0.21, 0.55]),
        "Sex": rng.choice(["male", "female"], rows, p=[male_p, 1 - male_p]),
        "Age": rng.normal(30 + age_shift, 13, rows).clip(0.4, 95),
        "SibSp": rng.integers(0, 6, rows).astype(float),
        "Fare": rng.lognormal(3.0, 1.0, rows),
        "Embarked": rng.choice(["S", "C", "Q"], rows, p=[0.72, 0.19, 0.09]),
    })


def build_workflow(pkg):
    pkg["uid"].reset_uids()
    fb = pkg["fb"]
    survived = fb.RealNN("Survived").as_response()
    predictors = [fb.PickList("Pclass").as_predictor(),
                  fb.PickList("Sex").as_predictor(),
                  fb.Real("Age").as_predictor(),
                  fb.Integral("SibSp").as_predictor(),
                  fb.Real("Fare").as_predictor(),
                  fb.PickList("Embarked").as_predictor()]
    checked = pkg["checker"](max_correlation=0.99).set_input(
        survived, pkg["transmogrify"](predictors)).get_output()
    prediction = pkg["nb"]().set_input(survived, checked).get_output()
    return pkg["workflow"]().set_result_features(prediction)


def probs_of(model, df):
    scored = model.score(data=df)
    p = scored[model.result_features[0].name].values.probability
    return np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p)[:, 1]


@pytest.fixture(scope="module")
def base_df():
    return make_df(400, seed=7)


@pytest.fixture(scope="module")
def trained(base_df):
    """{pkg name: (workflow, chunked model)}, shared read-only bases."""
    out = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        wf = build_workflow(pkg)
        out[name] = (wf, wf.set_input_data(base_df).train(chunk_rows=64))
    return out


def _both(trained, fn):
    """``fn(pkg, workflow, model)`` for the port, then the JAX package."""
    return [fn(pkg, *trained[name])
            for name, pkg in (("port", PORT), ("jax", JAX))]


class TestRefresh:
    def test_refresh_matches_full_streaming_retrain(self, trained, base_df):
        new = make_df(200, seed=8)
        both = pd.concat([base_df, new], ignore_index=True)
        before = refresh_snapshot()

        def run(pkg, wf, model):
            refreshed = wf.refresh(model, data=new, chunk_rows=64)
            full = build_workflow(pkg).set_input_data(both).train(
                chunk_rows=64)
            return refreshed, full

        (r, f), (jr, jf) = _both(trained, run)
        rep = r.refresh_report
        assert rep == jr.refresh_report
        assert rep["refit"] == [] and rep["invalidated"] == []
        assert len(rep["merged"]) >= 5
        after = refresh_snapshot()
        assert after["merged"] - before["merged"] == len(rep["merged"])
        dp = np.abs(probs_of(r, both) - probs_of(f, both))
        assert dp.max() < RETRAIN_TOL
        np.testing.assert_allclose(probs_of(r, both), probs_of(jr, both),
                                   rtol=0, atol=PKG_TOL)
        assert [p.label for p in r.ingest_profile.passes] == [
            p.label for p in jr.ingest_profile.passes]

    def test_refresh_chains_and_persists_states(self, trained, tmp_path):
        def run(pkg, wf, model):
            r1 = wf.refresh(model, data=make_df(120, seed=9), chunk_rows=32)
            assert r1.fit_states
            r2 = wf.refresh(r1, data=make_df(120, seed=10), chunk_rows=32)
            assert r2.refresh_report["merged"]
            path = str(tmp_path / ("p" if pkg is PORT else "j"))
            r2.save(path)
            loaded = pkg["load"](path)
            assert set(loaded.fit_states) == set(r2.fit_states)
            r3 = wf.refresh(loaded, data=make_df(120, seed=11),
                            chunk_rows=32)
            assert r3.refresh_report["merged"]
            return r3

        r3, jr3 = _both(trained, run)
        assert r3.refresh_report == jr3.refresh_report
        df = make_df(50, seed=12)
        np.testing.assert_allclose(probs_of(r3, df), probs_of(jr3, df),
                                   rtol=0, atol=PKG_TOL)

    def test_refresh_without_states_refits_everything(self, base_df):
        reps = []
        for pkg in (PORT, JAX):
            wf = build_workflow(pkg)
            model = wf.set_input_data(base_df).train()
            assert model.fit_states is None
            refreshed = wf.refresh(model, data=make_df(200, seed=12),
                                   chunk_rows=64)
            reps.append(refreshed.refresh_report)
        assert reps[0] == reps[1]
        assert reps[0]["merged"] == []
        assert len(reps[0]["refit"]) >= 5

    def test_vocab_set_change_invalidates_downstream(self):
        old = pd.DataFrame({"y": [0.0, 1.0] * 60,
                            "cat": ["a"] * 60 + ["b"] * 60})
        new = pd.DataFrame({"y": [0.0, 1.0] * 60,
                            "cat": ["c"] * 100 + ["a"] * 20})
        reps = []
        for pkg in (PORT, JAX):
            pkg["uid"].reset_uids()
            y = pkg["fb"].RealNN("y").as_response()
            feats = pkg["transmogrify"](
                [pkg["fb"].PickList("cat").as_predictor()])
            pred = pkg["nb"]().set_input(y, feats).get_output()
            wf = pkg["workflow"]().set_result_features(pred)
            model = wf.set_input_data(old).train(chunk_rows=32)
            reps.append(wf.refresh(model, data=new,
                                   chunk_rows=32).refresh_report)
        assert reps[0] == reps[1]
        assert reps[0]["geometryChanged"], "vocab set change went unnoticed"
        assert reps[0]["invalidated"], \
            "downstream state survived a geometry change"

    def test_slot_rotation_alone_keeps_merge(self, trained):
        def run(pkg, wf, model):
            refreshed = wf.refresh(model, data=make_df(200, seed=8),
                                   chunk_rows=64)
            assert refreshed.refresh_report["invalidated"] == []
            old = next(s.vocabs for s in model.stages
                       if hasattr(s, "vocabs"))
            new = next(s.vocabs for s in refreshed.stages
                       if hasattr(s, "vocabs"))
            assert old == new
            return new, [pkg["refresh"].geometry_signature(s)
                         for s in refreshed.stages]

        (v, sigs), (jv, jsigs) = _both(trained, run)
        assert v == jv
        assert sigs == jsigs

    def test_refresh_checkpoint_resume(self, trained, tmp_path):
        new = make_df(256, seed=13)

        def run(pkg, wf, model):
            ckpt = str(tmp_path / ("p" if pkg is PORT else "j"))
            clean = wf.refresh(model, data=new, chunk_rows=32)
            f = pkg["faults"]
            with f.inject(f.FaultSpec(point="checkpoint.barrier",
                                      action="raise", at=1)):
                with pytest.raises(f.FaultError):
                    wf.refresh(model, data=new, chunk_rows=32,
                               checkpoint_dir=ckpt,
                               checkpoint_every_chunks=2)
            assert os.path.exists(os.path.join(ckpt, "checkpoint.json"))
            resumed = wf.refresh(model, data=new, chunk_rows=32,
                                 checkpoint_dir=ckpt,
                                 checkpoint_every_chunks=2)
            assert resumed.ingest_profile.resumed
            np.testing.assert_array_equal(probs_of(resumed, new),
                                          probs_of(clean, new))
            return [p.chunks_skipped for p in resumed.ingest_profile.passes]

        skips, jskips = _both(trained, run)
        assert skips == jskips and sum(skips) > 0

    def test_refresh_checkpoint_never_resumes_plain_train(self, trained,
                                                          tmp_path):
        new = make_df(256, seed=14)

        def run(pkg, wf, model):
            ckpt = str(tmp_path / ("p" if pkg is PORT else "j"))
            f = pkg["faults"]
            with f.inject(f.FaultSpec(point="checkpoint.barrier",
                                      action="raise", at=1)):
                with pytest.raises(f.FaultError):
                    wf.refresh(model, data=new, chunk_rows=32,
                               checkpoint_dir=ckpt,
                               checkpoint_every_chunks=2)
            with pytest.raises(pkg["ckpt"].CheckpointMismatchError,
                               match=r"refresh: saved="):
                wf.train(chunk_rows=32, checkpoint_dir=ckpt,
                         checkpoint_every_chunks=2)

        _both(trained, run)


def test_refresh_leaves_the_base_states_alone(trained):
    """The deep copy before the import: two refreshes from one base give
    bitwise the same probabilities, and the base's states are unchanged."""
    wf, model = trained["port"]
    before = {uid: repr(p) for uid, p in model.fit_states.items()}
    new = make_df(150, seed=15)
    a = probs_of(wf.refresh(model, data=new, chunk_rows=64), new)
    b = probs_of(wf.refresh(model, data=new, chunk_rows=64), new)
    np.testing.assert_array_equal(a, b)
    assert {uid: repr(p) for uid, p in model.fit_states.items()} == before


def test_geometry_signature_and_base_digest_match_jax(trained):
    (wf, model), (jwf, jmodel) = trained["port"], trained["jax"]
    sigs = [trefresh.geometry_signature(s) for s in model.stages]
    jsigs = [jrefresh.geometry_signature(s) for s in jmodel.stages]
    assert sigs == jsigs and any(s is not None for s in sigs)
    from transmogrifai_tpu.workflow.dag import compute_dag as jdag
    from transmogrifai_tpu_torch.workflow.dag import compute_dag

    d = trefresh.RefreshContext(model, compute_dag(wf.result_features))
    jd = jrefresh.RefreshContext(jmodel, jdag(jwf.result_features))
    assert d.base_digest() == jd.base_digest()


def test_refresh_with_a_filter_needs_its_results(base_df, tmp_path):
    """A refresh under RawFeatureFilter reuses the base model's recorded
    decisions: none recorded raises in both packages; a trained model's
    results serve in both; a loaded model's (their JSON form) serve in the
    port, where the JAX package raises AttributeError on the dict (ROADMAP
    Queue C, a defect of the reference)."""
    new = make_df(128, seed=16)
    out = []
    for pkg in (PORT, JAX):
        wf = build_workflow(pkg).with_raw_feature_filter()
        no_filter = build_workflow(pkg).set_input_data(base_df).train(
            chunk_rows=64)
        with pytest.raises(ValueError, match="recorded filter results"):
            wf.refresh(no_filter, data=new, chunk_rows=64)
        model = wf.set_input_data(base_df).train(chunk_rows=64)
        refreshed = wf.refresh(model, data=new, chunk_rows=64)
        path = str(tmp_path / ("p" if pkg is PORT else "j"))
        model.save(path)
        loaded = pkg["load"](path)
        assert isinstance(loaded.raw_feature_filter_results, dict)
        if pkg is JAX:
            with pytest.raises(AttributeError, match="dropped_features"):
                wf.refresh(loaded, data=new, chunk_rows=64)
        else:
            again = wf.refresh(loaded, data=new, chunk_rows=64)
            assert again.refresh_report == refreshed.refresh_report
            np.testing.assert_array_equal(probs_of(again, new),
                                          probs_of(refreshed, new))
        out.append((refreshed.refresh_report, probs_of(refreshed, new)))
    assert out[0][0] == out[1][0]
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=0, atol=PKG_TOL)
