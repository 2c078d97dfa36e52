"""The port's streaming workflow CV (``train(chunk_rows=k)`` under
``with_workflow_cv()``: ``workflow/streaming_cv.py``,
``ModelSelector.find_best_estimator_prefold``,
``OpCrossValidation.validate_prefold``) against the JAX package's, on the
CPU, mirroring ``tests/test_streaming_cv.py``: the transmogrified
(x1, x2, cat) frame of 400 numpy-seeded rows -> SanityChecker -> a
binary selector of two LR grid points.

* Fold ids per global row are the JAX package's exactly (one seeded
  numpy draw in both), and the chunked CV train gives the in-core CV
  train's winner in both packages, its fold metrics within 1e-4 of the
  in-core ones (the JAX test's tolerance) and within 1e-5 of the JAX
  package's chunked ones (the LR solves agree to that), at chunk_rows 7,
  64 and 400.
* The train/validation split variant, a refresh under workflow CV, the
  ``cv.fold`` fault point, the mid-fold and mid-sweep kills and resumes
  (bitwise), the fold-geometry and plain-train refusals (with the
  key-level diff), the model's full-state-only ``fit_states`` and the
  named refusal of a during-DAG estimator that cannot stream: each as
  the JAX package behaves.
"""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JSanityChecker
from transmogrifai_tpu.selector.model_selector import \
    BinaryClassificationModelSelector as JBCMS
from transmogrifai_tpu.selector.model_selector import grid as jgrid
from transmogrifai_tpu.utils import faults as jfaults
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow import checkpoint as jckpt
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.models.classification import \
    OpLogisticRegression
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, grid)
from transmogrifai_tpu_torch.utils import faults
from transmogrifai_tpu_torch.utils import uid as tuid
from transmogrifai_tpu_torch.workflow import checkpoint as tckpt
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

N_ROWS = 400
#: the JAX test's in-core-to-streamed fold metric tolerance
STREAM_TOL = 1e-4
#: port against JAX package on the same streamed fold matrices
PKG_TOL = 1e-5

JAX = dict(fb=JFB, transmogrify=jtransmogrify, checker=JSanityChecker,
           selector=JBCMS, grid=jgrid, lr=JLR, workflow=JWorkflow, uid=juid,
           faults=jfaults, ckpt=jckpt)
PORT = dict(fb=FeatureBuilder, transmogrify=transmogrify,
            checker=SanityChecker, selector=BinaryClassificationModelSelector,
            grid=grid, lr=OpLogisticRegression, workflow=OpWorkflow,
            uid=tuid, faults=faults, ckpt=tckpt)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


def synthetic_binary(n=N_ROWS, seed=0):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    cat = rng.choice(["a", "b", "c"], size=n)
    logits = 1.5 * x1 - 1.0 * x2 + (cat == "a") * 0.8
    y = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(float)
    return pd.DataFrame({"label": y, "x1": x1, "x2": x2, "cat": cat})


def build_dag(pkg, num_folds=3, validator="cv", spearman=False):
    pkg["uid"].reset_uids()
    fb = pkg["fb"]
    label = fb.RealNN("label").as_response()
    feats = pkg["transmogrify"]([fb.Real("x1").as_predictor(),
                                 fb.Real("x2").as_predictor(),
                                 fb.PickList("cat").as_predictor()])
    checker = pkg["checker"](
        max_correlation=0.99,
        correlation_type="spearman" if spearman else "pearson")
    checked = checker.set_input(label, feats).get_output()
    factory = (pkg["selector"].with_cross_validation if validator == "cv"
               else pkg["selector"].with_train_validation_split)
    kwargs = ({"num_folds": num_folds} if validator == "cv"
              else {"train_ratio": 0.75})
    selector = factory(models_and_parameters=[
        (pkg["lr"](), pkg["grid"](reg_param=[0.01, 0.1]))], **kwargs)
    prediction = selector.set_input(label, checked).get_output()
    return prediction, selector, checker


def _probs(model, df):
    scored = model.score(data=df)
    name = model.result_features[0].name
    p = scored[name].values.probability
    return np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p)[:, 1]


def _results(selector):
    return selector.metadata["workflow_cv_results"]


def _wf(pkg, df, **kw):
    prediction, selector, checker = build_dag(pkg, **kw)
    wf = (pkg["workflow"]().set_result_features(prediction)
          .set_input_data(df).with_workflow_cv())
    return wf, selector, checker


@pytest.fixture(scope="module")
def df():
    return synthetic_binary()


@pytest.fixture(scope="module")
def incore_cv(df):
    wf, selector, _ = _wf(PORT, df)
    model = wf.train()
    return (model, _probs(model, df), _results(selector),
            selector.metadata["model_selector_summary"])


class TestStreamingCVParity:
    @pytest.mark.parametrize("chunk_rows", [7, 64, N_ROWS])
    def test_matches_incore_fold_refit(self, df, incore_cv, chunk_rows):
        _, p0, results0, summ0 = incore_cv
        wf, selector, _ = _wf(PORT, df)
        model = wf.train(chunk_rows=chunk_rows)
        jwf, jsel, _ = _wf(JAX, df)
        jmodel = jwf.train(chunk_rows=chunk_rows)
        results, jresults = _results(selector), _results(jsel)
        summ = selector.metadata["model_selector_summary"]
        assert summ["bestModelParams"] == summ0["bestModelParams"] == \
            jsel.metadata["model_selector_summary"]["bestModelParams"]
        assert len(results) == len(results0) == len(jresults)
        for a, b, j in zip(results0, results, jresults):
            assert a["params"] == b["params"] == j["params"]
            assert len(b["foldValues"]) == 3
            assert b["metricValue"] == pytest.approx(a["metricValue"],
                                                     abs=STREAM_TOL)
            np.testing.assert_allclose(b["foldValues"], j["foldValues"],
                                       rtol=0, atol=PKG_TOL)
        assert selector.best_estimator is None
        np.testing.assert_allclose(_probs(model, df), p0, rtol=0, atol=1e-3)
        np.testing.assert_allclose(_probs(model, df), _probs(jmodel, df),
                                   rtol=0, atol=PKG_TOL)
        # the passes are the JAX package's
        assert [p.label for p in model.ingest_profile.passes] == [
            p.label for p in jmodel.ingest_profile.passes]

    def test_fold_ids_are_the_jax_packages(self, df):
        from transmogrifai_tpu.workflow.dag import compute_dag as jdag
        from transmogrifai_tpu.workflow.dag import cut_dag_cv as jcut
        from transmogrifai_tpu.workflow.streaming_cv import \
            StreamingCVContext as JCtx
        from transmogrifai_tpu_torch.workflow.dag import (compute_dag,
                                                          cut_dag_cv)
        from transmogrifai_tpu_torch.workflow.streaming_cv import \
            StreamingCVContext

        ctxs = []
        for pkg, dag_fn, cut_fn, ctx_cls in (
                (PORT, compute_dag, cut_dag_cv, StreamingCVContext),
                (JAX, jdag, jcut, JCtx)):
            pred, _, _ = build_dag(pkg, num_folds=5)
            cut = cut_fn(dag_fn([pred]))
            ctx = ctx_cls(cut.selector, cut.during, {})
            ctx.begin_label_pass()
            for lo in range(0, N_ROWS, 64):
                ctx.collect_labels({"label": _Col(df["label"].values[
                    lo:lo + 64])})
            ctx.finish_label_pass(N_ROWS)
            ctx.assign_folds()
            ctxs.append(ctx)
        np.testing.assert_array_equal(ctxs[0]._global_folds,
                                      ctxs[1]._global_folds)
        assert ctxs[0].fingerprint() == ctxs[1].fingerprint()
        assert ctxs[0].fold_contexts() == ctxs[1].fold_contexts()
        assert ctxs[0].extra_columns == ctxs[1].extra_columns

    def test_train_validation_split_variant(self, df):
        wf0, sel0, _ = _wf(PORT, df, validator="tvs")
        wf0.train()
        wf1, sel1, _ = _wf(PORT, df, validator="tvs")
        wf1.train(chunk_rows=64)
        jwf, jsel, _ = _wf(JAX, df, validator="tvs")
        jwf.train(chunk_rows=64)
        r0, r1, rj = _results(sel0), _results(sel1), _results(jsel)
        assert [len(r["foldValues"]) for r in r1] == [1, 1]
        for a, b, j in zip(r0, r1, rj):
            assert b["metricValue"] == pytest.approx(a["metricValue"],
                                                     abs=STREAM_TOL)
            assert b["metricValue"] == pytest.approx(j["metricValue"],
                                                     abs=PKG_TOL)

    def test_refresh_composes_with_workflow_cv(self, df):
        window = synthetic_binary(n=200, seed=9)
        out = []
        for pkg in (PORT, JAX):
            wf, selector, _ = _wf(pkg, df)
            model = wf.train(chunk_rows=64)
            refreshed = wf.refresh(model, data=window, chunk_rows=64)
            assert refreshed.refresh_report["merged"]
            assert _results(selector)
            out.append((refreshed.refresh_report, _probs(refreshed, window),
                        _results(selector)))
        (rep, p, res), (jrep, jp, jres) = out
        assert rep == jrep
        assert len(p) == 200
        np.testing.assert_allclose(p, jp, rtol=0, atol=PKG_TOL)
        for a, j in zip(res, jres):
            np.testing.assert_allclose(a["foldValues"], j["foldValues"],
                                       rtol=0, atol=PKG_TOL)

    @pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
    def test_cv_fold_fault_point_fires(self, df, pkg):
        wf, _, _ = _wf(pkg, df)
        f = pkg["faults"]
        with f.inject(f.FaultSpec(point="cv.fold", action="raise", at=1)):
            with pytest.raises(f.FaultError, match=r"cv\.fold\[1\]"):
                wf.train(chunk_rows=64)


class _Col:
    """A column stand-in for ``collect_labels`` (``.values`` only)."""

    def __init__(self, values):
        self.values = values


class TestStreamingCVCheckpoint:
    def _train(self, pkg, df, ckdir, fault=None, num_folds=3):
        wf, selector, _ = _wf(pkg, df, num_folds=num_folds)
        if fault is None:
            model = wf.train(chunk_rows=32, checkpoint_dir=ckdir,
                             checkpoint_every_chunks=2)
            return model, selector
        f = pkg["faults"]
        with f.inject(fault):
            with pytest.raises(f.FaultError):
                wf.train(chunk_rows=32, checkpoint_dir=ckdir,
                         checkpoint_every_chunks=2)
        return None, None

    def test_mid_fold_resume_is_bit_exact(self, df, tmp_path):
        """A kill in the fold-tagged SanityChecker pass: the fold states
        come back from the mid-pass cursor and the resumed train's scores
        are the uninterrupted train's, bitwise; the JAX package's passes
        and skips are the same."""
        out = []
        for pkg in (PORT, JAX):
            tag = "p" if pkg is PORT else "j"
            ref, _ = self._train(pkg, df, str(tmp_path / f"{tag}a"))
            ck = str(tmp_path / f"{tag}b")
            self._train(pkg, df, ck, fault=pkg["faults"].FaultSpec(
                point="checkpoint.barrier", action="raise", at=3))
            assert os.path.exists(os.path.join(ck, "checkpoint.json"))
            resumed, _ = self._train(pkg, df, ck)
            ip = resumed.ingest_profile
            assert ip.resumed
            assert np.array_equal(_probs(resumed, df), _probs(ref, df))
            out.append(([p.label for p in ip.passes],
                        [p.chunks_skipped for p in ip.passes]))
        assert out[0] == out[1]
        assert sum(out[0][1]) > 0

    def test_mid_cv_sweep_resume_is_bit_exact(self, df, tmp_path):
        """A kill at the CV sweep's cursor save: the fold states come back
        from the pass record, the sweep resumes at its unit cursor, and
        the scores and fold metrics are the uninterrupted train's."""
        ref, sel_ref = self._train(PORT, df, str(tmp_path / "a"))
        ck = str(tmp_path / "b")
        self._train(PORT, df, ck, fault=faults.FaultSpec(
            point="sweep.checkpoint", action="raise", at=1))
        assert os.path.exists(os.path.join(ck, "sweep", "sweep.json"))
        resumed, selector = self._train(PORT, df, ck)
        assert resumed.ingest_profile.resumed
        assert np.array_equal(_probs(resumed, df), _probs(ref, df))
        assert ([r["metricValue"] for r in _results(selector)]
                == [r["metricValue"] for r in _results(sel_ref)])

    @pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
    def test_fold_geometry_mismatch_refuses_with_key_diff(self, df,
                                                          tmp_path, pkg):
        ck = str(tmp_path / "ck")
        self._train(pkg, df, ck, fault=pkg["faults"].FaultSpec(
            point="checkpoint.barrier", action="raise", at=1))
        wf, _, _ = _wf(pkg, df, num_folds=5)
        with pytest.raises(pkg["ckpt"].CheckpointMismatchError,
                           match=r"cv\.numFolds: saved=3 current=5"):
            wf.train(chunk_rows=32, checkpoint_dir=ck)

    @pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
    def test_cv_checkpoint_refuses_plain_train(self, df, tmp_path, pkg):
        ck = str(tmp_path / "ck")
        self._train(pkg, df, ck, fault=pkg["faults"].FaultSpec(
            point="checkpoint.barrier", action="raise", at=1))
        prediction, _, _ = build_dag(pkg)
        wf = pkg["workflow"]().set_result_features(prediction) \
            .set_input_data(df)
        with pytest.raises(pkg["ckpt"].CheckpointMismatchError,
                           match=r"cv: saved="):
            wf.train(chunk_rows=32, checkpoint_dir=ck)


class TestFoldTaggedStates:
    def test_fold_states_export_full_only_onto_model(self, df):
        """``fit_states`` carries the full-data state, equal to the JAX
        package's, never the fold scaffolding."""
        payloads = []
        for pkg in (PORT, JAX):
            wf, _, checker = _wf(pkg, df)
            model = wf.train(chunk_rows=64)
            payload = model.fit_states[checker.uid]
            assert not (isinstance(payload, dict)
                        and payload.get("__fold_tagged__"))
            payloads.append(payload)
        port, jax = payloads
        assert sorted(port) == sorted(jax)
        assert port["d"] == jax["d"]
        np.testing.assert_allclose(port["pearson"].x.mean,
                                   jax["pearson"].x.mean, rtol=0,
                                   atol=1e-12)

    @pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
    def test_non_streamable_during_est_raises_named(self, df, pkg):
        wf, _, checker = _wf(pkg, df, spearman=True)
        with pytest.raises(ValueError, match=checker.uid):
            wf.train(chunk_rows=64)
        model = wf.train()
        assert len(_probs(model, df)) == N_ROWS
