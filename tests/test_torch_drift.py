"""The serving drift monitor (``serving/drift.py``) in the port against
the JAX package's, on the CPU, on the same baselines and traffic: the
baselines of a model trained on 3 000 Titanic-shaped rows, a 1 000-row
window of holdout rows unchanged and then one with Fare x 3 and Sex
flipped.  The monitors' host arithmetic is the
same, so each window's PSI and z agree within 1e-12 (the JAX side's
native histogram patched off) and the same features drift.  A model the
JAX package saves loads in the port with its baselines bit for bit, and a
``ModelServer`` with a monitor puts the monitor's snapshot into its own
(``/metrics``)."""
import os
import sys

import numpy as np
import pytest
import torch

import transmogrifai_tpu.native
import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.serving import drift as jdrift
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu_torch.serving import ModelServer
from transmogrifai_tpu_torch.serving import drift as tdrift
from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                   FeatureColumn)
from transmogrifai_tpu_torch.workflow.workflow import (OpWorkflow,
                                                       OpWorkflowModel)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_out_of_core import (JAX, PORT, _bench_ingest_dag,  # noqa
                                    _datasets)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

N_TRAIN, N_HOLD = 3000, 2000


@pytest.fixture(autouse=True)
def _cpu_numpy_histograms(monkeypatch):
    tt.set_device("cpu")
    monkeypatch.setattr(transmogrifai_tpu.native, "AVAILABLE", False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained():
    tt.set_device("cpu")
    cols, _ = chip_smoke.titanic_columns(N_TRAIN + N_HOLD)
    train = ColumnarDataset({
        k: FeatureColumn.from_values(t, cols[k][:N_TRAIN])
        for k, t in chip_smoke.TITANIC_SCHEMA.items()})
    pred = _bench_ingest_dag(PORT)
    model = OpWorkflow().set_result_features(pred).set_input_data(
        train).train(chunk_rows=500)
    return model, cols


def _rows(cols, lo, hi, shift=False):
    out = []
    for i in range(lo, hi):
        r = {}
        for k, v in cols.items():
            x = v[i]
            if isinstance(x, (float, np.floating)):
                r[k] = None if np.isnan(x) else float(x)
            else:
                r[k] = None if x is None else str(x)
        if shift:
            r["Fare"] = r["Fare"] * 3
            r["Sex"] = {"male": "female", "female": "male"}[r["Sex"]]
        out.append(r)
    return out


def _run(mod, baselines, batches, config):
    mon = mod.DriftMonitor(baselines, config=config)
    evals = []
    for rows in batches:
        mon.observe_rows(rows)
        if mon.last_evaluation is not None and (
                not evals or mon.last_evaluation is not evals[-1]):
            evals.append(mon.last_evaluation)
    return mon, evals


@pytest.mark.parametrize("sample_rate", [1.0, 0.7])
def test_monitor_matches_jax(trained, sample_rate):
    model, cols = trained
    baselines = tdrift.export_drift_baselines(model)
    assert {"Fare", "Age", "Sex", "Pclass"} <= set(baselines)
    assert "Name" not in baselines        # hashed text has no baseline
    clean = _rows(cols, N_TRAIN, N_TRAIN + 1000)
    shifted = _rows(cols, N_TRAIN + 1000, N_TRAIN + N_HOLD, shift=True)
    batches = [clean[i:i + 50] for i in range(0, 1000, 50)] + \
        [shifted[i:i + 50] for i in range(0, 1000, 50)]
    kw = dict(sample_rate=sample_rate, min_rows=int(1000 * sample_rate),
              seed=3)
    pmon, pevals = _run(tdrift, baselines, batches, tdrift.DriftConfig(**kw))
    jmon, jevals = _run(jdrift, baselines, batches, jdrift.DriftConfig(**kw))
    assert len(pevals) == len(jevals) >= 2
    for p, j in zip(pevals, jevals):
        assert p["driftedFeatures"] == j["driftedFeatures"]
        assert p["windowRows"] == j["windowRows"]
        assert list(p["features"]) == list(j["features"])
        for name, rec in p["features"].items():
            jr = j["features"][name]
            assert rec["drifted"] == jr["drifted"]
            assert abs(rec["psi"] - jr["psi"]) <= 1e-12
            if rec["kind"] == "numeric":
                assert abs(rec["z"] - jr["z"]) <= 1e-12
                assert rec["windowMean"] == jr["windowMean"]
    assert pmon.refresh_triggered == jmon.refresh_triggered
    snap = pmon.snapshot()
    assert snap["windowsEvaluated"] == jmon.snapshot()["windowsEvaluated"]


def test_whole_windows_quiet_then_drift(trained):
    """A window observed in one batch: the clean rows stay quiet but for
    Cabin (147 cabins on 23% of the rows: the 3 000-row baseline's top
    counts and the window's ~230 cabins leave many categories empty or
    off, which PSI reads as a shift); the shifted rows drift on Fare and
    Sex.  (Observed in small batches, the integral columns drift on clean
    rows too, in both packages: the window histogram keeps a centroid per
    batch for each repeated value, which bends its interpolated CDF.)"""
    model, cols = trained
    mon = tdrift.DriftMonitor.from_model(model,
                                         tdrift.DriftConfig(min_rows=1000))
    mon.observe_rows(_rows(cols, N_TRAIN, N_TRAIN + 1000))
    assert mon.last_evaluation["driftedFeatures"] == ["Cabin"]
    mon.observe_rows(_rows(cols, N_TRAIN + 1000, N_TRAIN + N_HOLD,
                           shift=True))
    assert {"Fare", "Sex"} <= set(mon.last_evaluation["driftedFeatures"])
    assert mon.refresh_triggered


def test_psi_and_on_drift():
    assert tdrift.psi_from_counts([10, 20, 30], [10, 20, 30]) == 0.0
    for e, o in (([1, 0, 3], [0, 5, 1]), ([5, 5], [9, 1])):
        assert tdrift.psi_from_counts(e, o) == jdrift.psi_from_counts(e, o)
    fired = []
    base = {"x": {"kind": "categorical", "n": 100.0, "values": ["a", "b"],
                  "counts": np.array([50.0, 50.0])}}
    mon = tdrift.DriftMonitor(base, tdrift.DriftConfig(min_rows=10),
                              on_drift=fired.append)
    mon.observe_rows([{"x": "c"}] * 10)
    assert fired and fired[0]["driftedFeatures"] == ["x"]
    mon.observe_rows([{"x": "c"}] * 10)
    assert len(fired) == 1 and mon.drift_fires == 2
    mon.clear_refresh_trigger()
    assert not mon.refresh_triggered


def test_jax_saved_baselines_load_bitwise(trained, tmp_path):
    _, cols = trained
    train, _ = _datasets(JAX, cols)   # the first 600 rows
    pred = _bench_ingest_dag(JAX)
    jmodel = JWorkflow().set_result_features(pred).set_input_data(
        train).train()
    jmodel.save(str(tmp_path / "m"))
    loaded = OpWorkflowModel.load(str(tmp_path / "m"), device="cpu")
    got = tdrift.export_drift_baselines(loaded)
    want = jdrift.export_drift_baselines(jmodel)
    assert list(got) == list(want)
    for name, rec in want.items():
        for k, v in rec.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[name][k], v)
                assert got[name][k].dtype == v.dtype
            else:
                assert got[name][k] == v
    (vec,) = [s.metadata["drift_baseline_vector"] for s in loaded.stages
              if "drift_baseline_vector" in s.metadata]
    (jvec,) = [s.metadata["drift_baseline_vector"] for s in jmodel.stages
               if "drift_baseline_vector" in s.metadata]
    np.testing.assert_array_equal(vec["mean"], jvec["mean"])
    assert vec["names"] == jvec["names"]


def test_port_saved_baselines_round_trip(trained, tmp_path):
    model, _ = trained
    model.save(str(tmp_path / "p"))
    loaded = OpWorkflowModel.load(str(tmp_path / "p"), device="cpu")
    got, want = (tdrift.export_drift_baselines(m) for m in (loaded, model))
    for name, rec in want.items():
        for k, v in rec.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[name][k], v)
            else:
                assert got[name][k] == v


def test_server_snapshot_holds_drift(trained, tmp_path):
    model, cols = trained
    model.save(str(tmp_path / "s"))
    srv = ModelServer.from_path(str(tmp_path / "s"), name="m", device="cpu")
    mon = tdrift.DriftMonitor.from_model(
        srv.registry.get("m").model, tdrift.DriftConfig(min_rows=40))
    with srv.with_drift_monitor(mon):
        for r in _rows(cols, N_TRAIN, N_TRAIN + 50):
            srv.score([r])
    snap = srv.snapshot()
    assert snap["drift"]["rowsObserved"] == 50
    assert snap["drift"]["windowsEvaluated"] == 1
    assert snap["drift"]["lastEvaluation"]["windowRows"] >= 40
    assert snap["drift"] == mon.snapshot()
