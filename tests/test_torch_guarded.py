"""The port's guarded swap (``serving/guarded.py``) against the JAX
package's, on the CPU, over the committed ``model_v1`` artifact.

The same candidate, replay rows and gate configuration through both
packages give the same ``accepted`` and ``reasons`` and the same checks
within 1e-6: the candidate as it is (accepted), with its coefficients
negated (rejected by the prediction gate), and with the label on the
replay rows (the metric gate: its log losses in the checks; the negated
candidate's regresses).  The latency gate is left out of the comparison
(a wall clock is no parity quantity: a huge ``p99_factor`` and its
reasons and checks dropped).  Both packages sample the same replay rows
(the seeded host RNG).  Also: the pinned swap, a rollback through the
``swap.bake`` fault point, a rejection through ``swap.shadow``, a bake
that ends clean, ``probe_digest`` equal across two loads of one artifact,
and a guard behind a ``ModelServer`` (shared metrics, live traffic in the
replay window, the snapshot's ``guardedSwap`` and ``generations``).
"""
import csv
import os

import numpy as np
import pytest

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.local import load_model_local as jload
from transmogrifai_tpu.serving import GuardedSwap as JGuard
from transmogrifai_tpu.serving import ModelRegistry as JRegistry
from transmogrifai_tpu.serving import SwapGateConfig as JGate
from transmogrifai_tpu.serving.aot import find_predictor as jfind
from transmogrifai_tpu_torch.local import load_model_local
from transmogrifai_tpu_torch.local.scorer import score_function_batch
from transmogrifai_tpu_torch.serving import (GuardedSwap, ModelRegistry,
                                             ModelServer, SwapGateConfig)
from transmogrifai_tpu_torch.serving.aot import find_predictor
from transmogrifai_tpu_torch.serving.guarded import probe_digest
from transmogrifai_tpu_torch.utils.faults import FaultSpec, inject

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MODEL_V1 = os.path.join(FIXTURES, "model_v1")
#: checks that read a wall clock (the latency gate's)
_CLOCKED = {"candP99Ms", "liveP99Ms"}


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


@pytest.fixture(scope="module")
def rows():
    with open(os.path.join(FIXTURES, "model_v1_input.csv")) as f:
        return [{"label": float(r["label"]), "x": float(r["x"]),
                 "cat": r["cat"]} for r in csv.DictReader(f)]


def _negate_port(model):
    lr = find_predictor(model).inner
    lr.coef = -lr.coef
    lr.intercept = -lr.intercept
    return model


def _negate_jax(model):
    lr = jfind(model).inner
    lr.coef = [-c for c in lr.coef]
    lr.intercept = -lr.intercept
    return model


def _gate(pkg_gate, label: bool):
    return pkg_gate(p99_factor=1e9, label_name="label" if label else None)


def _propose(pkg: str, negate: bool, label: bool, rows):
    if pkg == "jax":
        reg = JRegistry()
        reg.load("m", MODEL_V1)
        guard = JGuard(reg, "m", gate=_gate(JGate, label))
        cand = jload(MODEL_V1)
        if negate:
            _negate_jax(cand)
    else:
        reg = ModelRegistry()
        reg.load("m", MODEL_V1, device="cpu")
        guard = GuardedSwap(reg, "m", gate=_gate(SwapGateConfig, label))
        cand = load_model_local(MODEL_V1)
        if negate:
            _negate_port(cand)
    decision = guard.propose(cand, replay=rows)
    return decision, reg, guard


@pytest.mark.parametrize("negate", [False, True], ids=["same", "negated"])
@pytest.mark.parametrize("label", [False, True], ids=["unlabelled", "label"])
def test_decision_equals_jax(negate, label, rows):
    got, reg, guard = _propose("port", negate, label, rows)
    want, _, _ = _propose("jax", negate, label, rows)
    assert got.accepted == want.accepted == (not negate)
    assert got.reasons == want.reasons
    assert set(got.checks) == set(want.checks)
    for key, value in got.checks.items():
        if key not in _CLOCKED:
            assert abs(value - want.checks[key]) <= 1e-6, key
    if negate:
        assert any(r.startswith("pred_distance:") for r in got.reasons)
        assert any(r.startswith("pred_psi:") for r in got.reasons)
        assert reg.get("m").version == 1   # the live model is unchanged
        assert guard.metrics.swaps_rejected == 1
    if label:
        assert {"candLogLoss", "liveLogLoss"} <= set(got.checks)
        assert any(r.startswith("metric_parity:")
                   for r in got.reasons) == negate


def test_replay_window_samples_as_jax(rows):
    guards = [GuardedSwap(ModelRegistry(), "m", sample_rate=0.5, seed=3,
                          gate=SwapGateConfig(replay_capacity=12)),
              JGuard(JRegistry(), "m", sample_rate=0.5, seed=3,
                     gate=JGate(replay_capacity=12))]
    for g in guards:
        for i in range(0, len(rows), 2):
            g.record_traffic(rows[i:i + 2])
    got, want = (g.replay_rows() for g in guards)
    assert got == want and 0 < len(got) <= 12


def test_pinned_swap_and_clean_bake(rows):
    reg = ModelRegistry()
    reg.load("m", MODEL_V1, device="cpu")
    guard = GuardedSwap(reg, "m", gate=SwapGateConfig(
        p99_factor=1e9, bake_rows=8, probe_every=4, golden_rows=4))
    decision = guard.propose(load_model_local(MODEL_V1), replay=rows)
    assert decision.accepted and decision.version == 2
    assert reg.get("m").version == 2 and reg.pinned("m").version == 1
    assert guard.baking
    guard.record_traffic(rows[:4])   # a probe, clean
    guard.record_traffic(rows[4:8])  # the bake window passes
    assert not guard.baking and guard.metrics.rollbacks == 0
    snap = guard.snapshot()
    assert snap["proposals"] == 1 and snap["probes"] == 2
    assert snap["lastDecision"]["accepted"]


def test_rollback_through_swap_bake(rows):
    reg = ModelRegistry()
    reg.load("m", MODEL_V1, device="cpu")
    guard = GuardedSwap(reg, "m", gate=SwapGateConfig(p99_factor=1e9))
    assert guard.propose(load_model_local(MODEL_V1), replay=rows).accepted
    with inject(FaultSpec(point="swap.bake", action="raise", at=0)):
        reason = guard.bake_probe()
    assert reason == "probe_error:FaultError"
    assert reg.get("m").version == 1   # the pinned generation
    snap = guard.metrics.snapshot()
    assert snap["rollbacks"] == 1
    assert snap["lastRollbackReason"] == "probe_error:FaultError"
    assert not guard.baking


def test_golden_mismatch_rolls_back(rows):
    reg = ModelRegistry()
    reg.load("m", MODEL_V1, device="cpu")
    guard = GuardedSwap(reg, "m", gate=SwapGateConfig(p99_factor=1e9))
    assert guard.propose(load_model_local(MODEL_V1), replay=rows).accepted
    _negate_port(reg.get("m").model)   # corrupted after the swap
    reason = guard.bake_probe()
    assert reason.startswith("probe_mismatch:")
    assert reg.get("m").version == 1


def test_swap_shadow_fault_rejects(rows):
    reg = ModelRegistry()
    reg.load("m", MODEL_V1, device="cpu")
    guard = GuardedSwap(reg, "m")
    with inject(FaultSpec(point="swap.shadow", action="raise", at=0)):
        decision = guard.propose(load_model_local(MODEL_V1), replay=rows)
    assert not decision.accepted
    assert decision.reasons == ["shadow_error:FaultError"]
    assert reg.get("m").version == 1


def test_too_few_replay_rows_rejects(rows):
    reg = ModelRegistry()
    reg.load("m", MODEL_V1, device="cpu")
    decision = GuardedSwap(reg, "m").propose(load_model_local(MODEL_V1),
                                             replay=rows[:3])
    assert decision.reasons == ["insufficient_replay:3<16"]


def test_probe_digest_equal_across_loads(rows):
    a = score_function_batch(load_model_local(MODEL_V1))
    b = score_function_batch(load_model_local(MODEL_V1))
    assert probe_digest(a, rows) == probe_digest(b, rows) is not None
    assert probe_digest(a, []) is None
    other = score_function_batch(_negate_port(load_model_local(MODEL_V1)))
    assert probe_digest(other, rows) != probe_digest(a, rows)


def test_guard_behind_a_server(rows):
    srv = ModelServer.from_path(MODEL_V1, name="g", max_batch=4,
                                max_latency_ms=1.0, device="cpu",
                                warmup_row=dict(rows[0]))
    guard = GuardedSwap(srv.registry, "g",
                        gate=SwapGateConfig(p99_factor=1e9))
    assert srv.with_guard(guard) is srv and guard.metrics is srv.metrics
    with srv:
        for i in range(0, len(rows), 4):
            srv.score(rows[i:i + 4])
        assert len(guard.replay_rows()) == len(rows)
        decision = guard.propose(_negate_port(load_model_local(MODEL_V1)))
        assert not decision.accepted
        snap = srv.snapshot()
        assert snap["swapsRejected"] == 1
        assert snap["guardedSwap"]["replayRows"] == len(rows)
        assert [g["version"] for g in snap["generations"]] == [1]
        decision = guard.propose(load_model_local(MODEL_V1))
        assert decision.accepted
        snap = srv.snapshot()
        assert snap["swapsAccepted"] == 1 and snap["hotSwaps"] == 1
        gens = {g["version"]: g for g in snap["generations"]}
        assert gens[1]["pinned"] and gens[2]["current"]
        expected = score_function_batch(load_model_local(MODEL_V1))(rows)
        assert srv.score(rows[:4]) == expected[:4]
    assert np.isfinite(snap["guardedSwap"]["gate"]["predDistanceMax"])
