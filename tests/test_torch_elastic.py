"""The port's elastic sweep ladder on one device against the JAX
package's (``tests/test_elastic.py``'s TestClassifier,
TestDeviceLossRecovery and TestWatchdog), on the CPU.

Device losses and stragglers are injected through the ``device.loss`` and
``unit.slow`` fault points, the same plan in both packages.  Neither runs
a mesh here (one device), so a loss retries the unit on the same device:
the counters must read the same in both (retries, quarantines, watchdog
fires; no mesh shrink), the winners must agree, and the fold metrics
within the selector test's tolerances (RF 1e-6: the port draws the JAX
package's bags; LR 1e-4; the group-loss case's forests 1e-4, for the
reason stated there).  The port's ladder has no CPU rung: where every
candidate is quarantined, the sweep raises.
"""
import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.models import gbdt_kernels as jg
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
from transmogrifai_tpu.models.trees import OpRandomForestClassifier as JRF
from transmogrifai_tpu.parallel import elastic as jel
from transmogrifai_tpu.selector.model_selector import ModelSelector as JMS
from transmogrifai_tpu.selector.model_selector import grid as jgrid
from transmogrifai_tpu.selector.validators import \
    OpCrossValidation as JCV
from transmogrifai_tpu.utils import faults as jfaults
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.models.classification import \
    OpLogisticRegression
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.parallel import elastic as tel
from transmogrifai_tpu_torch.selector.model_selector import (ModelSelector,
                                                             grid)
from transmogrifai_tpu_torch.selector.validators import OpCrossValidation
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import FeatureColumn
from transmogrifai_tpu_torch.utils import faults as tfaults

RF_TOL, LR_TOL = 1e-6, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _jax_bags(monkeypatch):
    def bags(seed, n_trees, n, d, msub, subsample_rate, device):
        bw, idx = jg.rf_bags_and_features(seed, n_trees, n, d, msub,
                                          subsample_rate)
        return (torch.from_numpy(np.array(bw)).to(device),
                torch.from_numpy(np.array(idx)).long().to(device))

    monkeypatch.setattr(tk, "rf_bags_and_features", bags)
    tfaults.install_faults(None)
    yield
    tfaults.install_faults(None)


def _toy(n=300, d=12, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    beta = rng.normal(size=d) * (rng.random(d) < 0.6)
    y = (1 / (1 + np.exp(-(X @ beta))) > rng.random(n)).astype(np.float32)
    return X, y


def _selector(port: bool, with_rf: bool = True, watchdog=None):
    lr, rf, ms, cv, g = ((OpLogisticRegression, OpRandomForestClassifier,
                          ModelSelector, OpCrossValidation, grid) if port
                         else (JLR, JRF, JMS, JCV, jgrid))
    models = [(lr(), g(reg_param=[0.001, 0.01, 0.1, 1.0],
                       elastic_net_param=[0.0]))]
    if with_rf:
        models.append((rf(num_trees=6, seed=3),
                       [{"max_depth": 3}, {"max_depth": 5}]))
    return ms(models_and_params=models, problem_type="binary",
              validator=cv(num_folds=2, stratify=True), watchdog=watchdog)


def _validate(sel, X, y, port: bool, elastic=None, with_groups=True,
              candidates=None):
    w = np.ones(len(y), np.float32)
    Xv = torch.from_numpy(X) if port else X
    cands = candidates or sel._candidates(with_groups=with_groups)
    return sel.validator.validate(
        cands, Xv, y, w, eval_fn=sel._metric,
        metric_name=sel.validation_metric,
        larger_better=sel.larger_better, elastic=elastic)


def _counters(ctx):
    c = ctx.counters
    return (c.device_losses, c.retries, c.quarantined, c.watchdog_fires,
            c.mesh_shrinks)


def _assert_results_agree(tres, jres, rf_tol=RF_TOL):
    for a, b in zip(tres, jres):
        assert (a.model_name, a.params) == (b.model_name, b.params)
        assert (a.error is None) == (b.error is None)
        if a.error is None:
            tol = rf_tol if "Forest" in a.model_name else LR_TOL
            np.testing.assert_allclose(a.fold_values, b.fold_values,
                                       rtol=0, atol=tol)


class TestClassifier:
    def test_recognizes_card_loss_shapes(self):
        for msg in ("CUDA error: CUDA-capable device(s) is/are busy or "
                    "unavailable",
                    "RuntimeError: no CUDA-capable device is detected",
                    "CUDA error: uncorrectable ECC error encountered",
                    "the device is lost"):
            assert tel.is_device_loss(RuntimeError(msg)), msg
            assert tel.classify_sweep_error(RuntimeError(msg)) == \
                "device_loss"

    def test_injected_form_and_workload_errors(self):
        """The injected form is a loss in both packages; workload errors
        (out of memory included) are workload failures in both."""
        assert tel.is_device_loss(tfaults.DeviceLossError("anything"))
        assert jel.is_device_loss(jfaults.DeviceLossError("anything"))
        for msg in ("shape mismatch", "nan loss", "injected fault",
                    "CUDA out of memory. Tried to allocate 2.00 GiB",
                    "RESOURCE_EXHAUSTED: out of memory"):
            assert tel.classify_sweep_error(RuntimeError(msg)) == "workload"
            assert jel.classify_sweep_error(RuntimeError(msg)) == "workload"
        assert tel.classify_sweep_error(tfaults.FaultError("x")) == \
            "workload"

    def test_counters_json_keys_match_jax(self):
        assert tel.ElasticCounters().to_json() == \
            jel.ElasticCounters().to_json()
        c = tel.ElasticCounters()
        c.count("retries", 2)
        assert c.to_json()["retries"] == 2

    def test_single_device_mesh_helpers(self):
        assert tel.mesh_device_count(None) == 1
        assert tel.shrink_mesh(None) is None
        assert jel.shrink_mesh(None) is None


class TestDeviceLossRecovery:
    def test_loss_retries_on_the_same_device_same_winner(self):
        X, y = _toy()
        jbest0, jres0 = _validate(_selector(False), X, y, False,
                                  with_groups=False)
        jsel = _selector(False)
        jctx = jsel._elastic_context(len(y), X.shape[1], 6)
        with jfaults.inject(jfaults.FaultSpec(
                point="device.loss", action="device_loss", at=4, times=1)):
            jbest, jres = _validate(jsel, X, y, False, elastic=jctx,
                                    with_groups=False)
        tsel = _selector(True)
        tctx = tsel._elastic_context(len(y), X.shape[1], 6, "cpu")
        with tfaults.inject(tfaults.FaultSpec(
                point="device.loss", action="device_loss", at=4, times=1)):
            tbest, tres = _validate(tsel, X, y, True, elastic=tctx,
                                    with_groups=False)
        assert all(r.error is None for r in tres)
        assert _counters(tctx) == _counters(jctx) == (1, 1, 0, 0, 0)
        assert tbest == jbest == jbest0
        _assert_results_agree(tres, jres)
        _assert_results_agree(tres, jres0)

    def test_persistent_loss_quarantines_candidate_not_sweep(self):
        X, y = _toy()
        out = {}
        for port, fl in ((False, jfaults), (True, tfaults)):
            sel = _selector(port)
            ctx = (sel._elastic_context(len(y), X.shape[1], 6, "cpu")
                   if port else sel._elastic_context(len(y), X.shape[1], 6))
            with fl.inject(fl.FaultSpec(point="device.loss",
                                        action="device_loss", at=4,
                                        times=None)):
                best, res = _validate(sel, X, y, port, elastic=ctx,
                                      with_groups=False)
            assert res[4].error.startswith("failed: device_loss")
            assert sum(r.error is not None for r in res) == 1
            # the retry budget: the first attempt + max_unit_retries
            assert ctx.counters.device_losses == sel.elastic_max_retries + 1
            out[port] = (best, res, _counters(ctx))
        assert out[True][0] == out[False][0]
        assert out[True][2] == out[False][2] == (3, 2, 1, 0, 0)
        _assert_results_agree(out[True][1], out[False][1])

    def test_every_candidate_quarantined_raises(self):
        """No CPU rung: a loss on every attempt of every unit quarantines
        them all, and the sweep raises."""
        X, y = _toy(n=120, d=4)
        sel = _selector(True, with_rf=False)
        ctx = sel._elastic_context(len(y), X.shape[1], 4, "cpu")
        with tfaults.inject(tfaults.FaultSpec(
                point="device.loss", action="device_loss", every=1,
                times=None)):
            with pytest.raises(RuntimeError, match="every candidate"):
                _validate(sel, X, y, True, elastic=ctx, with_groups=False)
        assert ctx.counters.quarantined == 4

    def test_group_device_loss_strips_to_sequential(self):
        """A loss inside the batched LR group strips it: its members fit
        one by one on the same device, and the sweep ends as without the
        fault (JAX: the same on one device, with its own message)."""
        X, y = _toy(n=420, d=10)
        out = {}
        for port, msg in ((False, "UNAVAILABLE: TPU backend setup/compile "
                                  "error"),
                          (True, "CUDA error: CUDA-capable device(s) "
                                 "is/are busy or unavailable")):
            best0, res0 = _validate(_selector(port), X, y, port)
            sel = _selector(port)
            ctx = (sel._elastic_context(len(y), X.shape[1], 6, "cpu")
                   if port else sel._elastic_context(len(y), X.shape[1], 6))
            cands = sel._candidates()
            assert cands[0][3] is not None
            orig_run = cands[0][3].run
            calls = {"n": 0}

            def dying_run(*a, _orig=orig_run, _calls=calls, _msg=msg, **k):
                _calls["n"] += 1
                if _calls["n"] == 1:
                    raise RuntimeError(_msg)
                return _orig(*a, **k)

            cands[0][3].run = dying_run
            with pytest.warns(RuntimeWarning, match="falling back"):
                best, res = _validate(sel, X, y, port, elastic=ctx,
                                      candidates=cands)
            assert all(r.error is None for r in res)
            assert best == best0
            # the stripped members' sequential fits give the group's
            # numbers (bitwise in the port)
            if port:
                assert [r.fold_values for r in res] == \
                    [r.fold_values for r in res0]
            out[port] = (best, res, _counters(ctx))
        assert out[True][2] == out[False][2] == (1, 1, 0, 0, 0)
        assert out[True][0] == out[False][0]
        # 1e-4 for the forests here: at 420 rows the depth-3 forest of 6
        # trees scores many rows in exact ties, and its float32 sum over
        # trees, an ulp apart between the packages, splits one of them
        # (7.4e-5 on one fold, grouped or not; the selector tests' 1e-6
        # holds at 3 000 rows)
        _assert_results_agree(out[True][1], out[False][1], rf_tol=1e-4)

    def test_elastic_counters_land_in_selector_metadata(self):
        from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
        from transmogrifai_tpu.types.feature_types import OPVector, RealNN

        X, y = _toy(n=240, d=8)
        jsel = _selector(False)
        jsel.fit_columns(None, JColumn(RealNN, y.astype(np.float64)),
                         JColumn(OPVector, X))
        tsel = _selector(True)
        tsel.fit_columns(None, FeatureColumn.from_values(
            ft.RealNN, y.astype(np.float64)),
            FeatureColumn(ft.OPVector, torch.from_numpy(X)))
        assert tsel.metadata["elastic"] == jsel.metadata["elastic"] == {
            "retries": 0, "meshShrinks": 0, "meshRepacks": 0,
            "quarantined": 0, "watchdogFires": 0, "deviceLosses": 0}


class TestWatchdog:
    """Deadlines of seconds against injected sleeps of seconds: the
    toy fits take milliseconds (the JAX package's after a warm-up)."""

    def _run(self, port: bool, deadline: float, times: int, delay: float):
        X, y = _toy(n=200, d=8, seed=7)
        fl = tfaults if port else jfaults
        if not port:   # compile the JAX fits before the deadline counts
            _validate(_selector(False, with_rf=False), X, y, False,
                      with_groups=False)
        sel = _selector(port, with_rf=False)
        ctx = (tel if port else jel).ElasticContext(unit_deadline_s=deadline)
        with fl.inject(fl.FaultSpec(point="unit.slow", action="slow", at=2,
                                    times=times, delay_s=delay)):
            best, res = _validate(sel, X, y, port, elastic=ctx,
                                  with_groups=False)
        return best, res, ctx

    def test_overrun_degrades_then_succeeds(self):
        out = {port: self._run(port, 2.0, 1, 4.0) for port in (False, True)}
        for best, res, ctx in out.values():
            assert all(r.error is None for r in res)
            assert ctx.counters.watchdog_fires == 1
            assert ctx.counters.retries == 1
            assert not ctx.abandoned          # drained at the sweep's end
        assert out[True][0] == out[False][0]
        _assert_results_agree(out[True][1], out[False][1])

    def test_repeat_overrun_quarantines_straggler(self):
        out = {port: self._run(port, 1.0, 2, 3.5) for port in (False, True)}
        for best, res, ctx in out.values():
            assert res[2].error.startswith("failed: straggler")
            assert ctx.counters.watchdog_fires == 2
            assert ctx.counters.quarantined == 1
            assert not ctx.abandoned
        assert out[True][0] == out[False][0]
        _assert_results_agree(out[True][1], out[False][1])

    def test_cold_cost_tier_keeps_watchdog_off(self):
        from transmogrifai_tpu.tuning.costmodel import CostModel as JCM
        from transmogrifai_tpu_torch.tuning.costmodel import CostModel

        tsel = _selector(True).with_watchdog(3.0, cost_model=CostModel())
        jsel = _selector(False).with_watchdog(3.0, cost_model=JCM())
        assert tsel._watchdog_deadline(200, 8, 6, "cpu") is None
        assert jsel._watchdog_deadline(200, 8, 6) is None

    def test_fitted_tier_arms_per_unit_deadline(self):
        """The same observations give the same deadline in both packages
        (1e-9: the same float64 ridge)."""
        from transmogrifai_tpu.tuning.costmodel import CostModel as JCM
        from transmogrifai_tpu.tuning.costmodel import \
            StageObservation as JObs
        from transmogrifai_tpu_torch.tuning.costmodel import (
            CostModel, StageObservation)

        shapes = [(r, 0.5 + r / 1e5) for r in (1000, 2000, 4000, 8000)]
        tobs = [StageObservation("ModelSelector:fit", r, 8, "float32",
                                 "cpu", w) for r, w in shapes]
        jobs = [JObs("ModelSelector:fit", r, 8, "float32", "cpu", w)
                for r, w in shapes]
        tsel = _selector(True).with_watchdog(
            3.0, cost_model=CostModel().fit(tobs))
        jsel = _selector(False).with_watchdog(
            3.0, cost_model=JCM().fit(jobs))
        d = tsel._watchdog_deadline(2000, 8, 6, "cpu")
        assert d is not None and d > 0
        assert d == pytest.approx(jsel._watchdog_deadline(2000, 8, 6),
                                  rel=1e-9)
        # another backend's tier answers through the kind-level bucket
        assert tsel._watchdog_deadline(2000, 8, 6, "cuda") == \
            pytest.approx(d, rel=1e-9)

    def test_run_with_deadline_reraises_worker_errors(self):
        def boom():
            raise ValueError("worker error")

        for mod in (tel, jel):
            with pytest.raises(ValueError, match="worker error"):
                mod.run_with_deadline(boom, 5.0)
            assert mod.run_with_deadline(lambda: 42, 5.0) == (42, False)
