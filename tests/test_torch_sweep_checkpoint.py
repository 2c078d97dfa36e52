"""The port's sweep checkpoints (``workflow/checkpoint.py``, the
selector's ``with_sweep_checkpoint``) on the CPU.

* The fingerprint's ``logical`` half equals the JAX package's for the
  same grid (the default binary selector's 26 candidates).
* A child process killed at the ``sweep.checkpoint`` fault point leaves a
  cursor; the resumed sweep restores those units, fits only the rest
  (the restored group never runs) and gives the uninterrupted
  synchronous sweep's winner and fold metrics (within 1e-6; the JSON
  floats round-trip exactly, so they are bitwise equal here).
* A checkpoint of another grid raises ``CheckpointMismatchError`` naming
  the differing keys.
* A halving sweep stopped inside its second rung resumes at that rung
  and gives the uninterrupted ladder's results.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.selector.model_selector import \
    BinaryClassificationModelSelector as JBCMS
from transmogrifai_tpu_torch.models.classification import \
    OpLogisticRegression
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, ModelSelector, grid)
from transmogrifai_tpu_torch.selector.splitters import DataSplitter
from transmogrifai_tpu_torch.selector.validators import OpCrossValidation
from transmogrifai_tpu_torch.tuning.halving import HalvingConfig
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import FeatureColumn
from transmogrifai_tpu_torch.utils import faults
from transmogrifai_tpu_torch.workflow import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_port_faults():
    faults.install_faults(None)
    yield
    faults.install_faults(None)


def _data(n=800, d=8, seed=21):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, 0] - 0.8 * X[:, 1] + rng.normal(scale=0.8, size=n) > 0
         ).astype(np.float32)
    return X, y


def _selector(strategy="full", lr_regs=(0.001, 0.01, 0.1)):
    return ModelSelector(
        [(OpLogisticRegression(), grid(reg_param=list(lr_regs))),
         (OpRandomForestClassifier(num_trees=4, seed=5),
          grid(max_depth=[3, 5]))],
        problem_type="binary",
        validator=OpCrossValidation(num_folds=3, stratify=True),
        splitter=DataSplitter(reserve_test_fraction=0.1), strategy=strategy,
        halving=HalvingConfig(min_rows=64) if strategy == "halving" else None)


def _fit(sel, X, y):
    sel.fit_columns(None, FeatureColumn.from_values(
        ft.RealNN, y.astype(np.float64)),
        FeatureColumn(ft.OPVector, torch.from_numpy(X)))
    summ = sel.metadata["model_selector_summary"]
    return (summ["bestModelType"], summ["bestModelParams"],
            [(r["foldValues"], r.get("error"))
             for r in summ["validationResults"]])


_CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import torch
import transmogrifai_tpu_torch as tt
torch.set_num_threads(1)
tt.set_device("cpu")
from test_torch_sweep_checkpoint import _data, _fit, _selector
X, y = _data()
_fit(_selector().with_sweep_checkpoint({ckpt!r}), X, y)
print("finished without the kill")
"""


def test_fingerprint_logical_half_matches_jax(tmp_path):
    t = BinaryClassificationModelSelector.with_cross_validation()
    j = JBCMS.with_cross_validation()
    t.with_sweep_checkpoint(str(tmp_path / "t"))
    j.with_sweep_checkpoint(str(tmp_path / "j"))
    tm = t._sweep_checkpoint(t._candidates(), 123_456)
    jm = j._sweep_checkpoint(j._candidates(), 123_456)
    assert len(tm.fingerprint["logical"]["candidates"]) == 26
    assert tm.fingerprint["logical"] == jm.fingerprint["logical"]
    assert tm.fingerprint["mesh"] is None and jm.fingerprint["mesh"] is None
    th, jh = (BinaryClassificationModelSelector.with_cross_validation(
        strategy="halving"), JBCMS.with_cross_validation(strategy="halving"))
    th.with_sweep_checkpoint(str(tmp_path / "th"))
    jh.with_sweep_checkpoint(str(tmp_path / "jh"))
    assert (th._sweep_checkpoint(th._candidates(with_groups=False), 99)
            .fingerprint["logical"]
            == jh._sweep_checkpoint(jh._candidates(with_groups=False), 99)
            .fingerprint["logical"])


def test_kill_then_resume_matches_the_uninterrupted_sync_sweep(
        tmp_path, monkeypatch):
    ckpt = str(tmp_path / "sweep")
    env = dict(os.environ, TMOG_FAULTS=json.dumps({"faults": [{
        "point": "sweep.checkpoint", "action": "kill", "at": 2}]}))
    env.pop("TMOG_SYNC_SWEEP", None)
    child = subprocess.run(
        [sys.executable, "-c", _CHILD.format(
            repo=REPO, tests=os.path.join(REPO, "tests"), ckpt=ckpt)],
        env=env, capture_output=True, text=True, timeout=300)
    assert child.returncode == -9, child.stdout + child.stderr
    doc = json.load(open(os.path.join(ckpt, ck.SWEEP_CHECKPOINT_JSON)))
    assert sorted(doc["units"]) == ["0", "1", "2"]   # the LR group's rows

    X, y = _data()
    sel = _selector().with_sweep_checkpoint(ckpt)
    resumed = _fit(sel, X, y)
    assert sel.metadata["sweep_checkpoint"]["restoredUnits"] == 3
    # the restored group never ran; only the forests were fitted
    assert set(sel.metadata["sweep_seconds"]) == {"RFGridGroup", "rest"}
    assert not os.path.exists(os.path.join(ckpt, ck.SWEEP_CHECKPOINT_JSON))

    monkeypatch.setenv("TMOG_SYNC_SWEEP", "1")
    reference = _fit(_selector(), X, y)
    assert resumed[:2] == reference[:2]
    for (a, ea), (b, eb) in zip(resumed[2], reference[2]):
        assert ea is None and eb is None
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert resumed == reference


def test_logical_mismatch_raises_with_the_key_diff(tmp_path):
    X, y = _data()
    ckpt = str(tmp_path / "sweep")
    with faults.inject(faults.FaultSpec(point="sweep.checkpoint",
                                        action="raise", at=0)):
        with pytest.raises(faults.FaultError):
            _fit(_selector().with_sweep_checkpoint(ckpt), X, y)
    other = _selector(lr_regs=(0.001, 0.01, 0.2)).with_sweep_checkpoint(ckpt)
    with pytest.raises(ck.CheckpointMismatchError) as ei:
        _fit(other, X, y)
    msg = str(ei.value)
    assert "candidates[2][1]" in msg and "0.1" in msg and "0.2" in msg
    diff = msg.split("differing keys:")[1]
    assert "validator" not in diff and "nRows" not in diff
    lines = ck.fingerprint_diff({str(i): i for i in range(40)},
                                {str(i): i + 1 for i in range(40)})
    assert lines[-1] == "... (diff truncated)" and len(lines) == 13


def test_halving_rung_state_resumes(tmp_path):
    """Rung 0's 5 unit records and its state are saves 0-5, rung 1's
    first unit save 6: a fault raised after save 6 stops the sweep inside
    rung 1; the resume starts at rung 1 with that unit restored."""
    X, y = _data(n=1500)
    clean = _fit(_selector("halving"), X, y)
    ckpt = str(tmp_path / "halving")
    with faults.inject(faults.FaultSpec(point="sweep.checkpoint",
                                        action="raise", at=6)):
        with pytest.raises(faults.FaultError):
            _fit(_selector("halving").with_sweep_checkpoint(ckpt), X, y)
    doc = json.load(open(os.path.join(ckpt, ck.SWEEP_CHECKPOINT_JSON)))
    assert doc["rung"]["nextRung"] == 1
    assert [k for k in doc["units"] if k.startswith("rung1:")] == ["rung1:0"]
    sel = _selector("halving").with_sweep_checkpoint(ckpt)
    resumed = _fit(sel, X, y)
    assert sel.metadata["sweep_checkpoint"]["restoredRung"] == 1
    assert resumed == clean
    rungs = sel.metadata["halving_schedule"]["rungs"]
    assert [r["survivorsIn"] for r in rungs] == [5, 2, 1]
