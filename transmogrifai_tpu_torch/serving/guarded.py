"""Guarded hot swap — shadow validation, a pinned rollback target and a
bake window (counterpart of ``transmogrifai_tpu.serving.guarded``).

``ModelRegistry.register`` installs any model unconditionally; in a
refreshing deployment that is the dangerous step.  ``GuardedSwap`` makes
rollout guarded and reversible:

1. **Shadow validation** (``propose``): the candidate and the live model
   score a held replay window (live rows the guard sampled, or rows the
   caller gives) on the server's device, and the candidate must pass
   three gates: *prediction parity* (mean absolute score distance and the
   scores' PSI within bounds), *metric parity* (where replay rows carry
   the label, its log loss may not regress past ``metric_tol``) and
   *latency* (its p99 per-batch wall within ``p99_factor`` of the live
   model's, and under ``p99_bound_ms`` when set).  Each batch's wall ends
   once its results are on the host, as the server's latencies do.
2. **Pinned swap**: only on a pass does the registry swap, after pinning
   the outgoing generation as last-known-good, so that the rollback
   target cannot be evicted.
3. **Bake window and automatic rollback**: at the swap the guard keeps
   golden queries (replay rows and the candidate's answers); during the
   bake window probes re-score them on the current entry, and a
   divergence past ``golden_tol``, a probe error or an error-rate
   regression rolls back to the pinned generation, with the reason in
   the serving metrics (``lastRollbackReason``); the breaker is not
   touched.

The replay window samples with the JAX package's seeded host RNG
(``numpy.random.default_rng(seed)``), so both packages hold the same
replay rows.  The ``swap.shadow`` and ``swap.bake`` fault points
(``utils/faults.py``) fire at each shadow evaluation and each bake probe.
"""
from __future__ import annotations

import hashlib
import json
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..obs.flight import record_event
from ..utils import faults
from .drift import psi_from_counts
from .metrics import ServingMetrics
from .registry import ModelEntry, ModelRegistry

__all__ = ["SwapGateConfig", "SwapDecision", "GuardedSwap",
           "probe_digest"]


class SwapGateConfig:
    """Acceptance gates + bake-window knobs for a GuardedSwap."""

    def __init__(self,
                 pred_distance_max: float = 0.15,
                 pred_psi_max: float = 0.5,
                 metric_tol: float = 0.05,
                 p99_factor: float = 3.0,
                 p99_bound_ms: Optional[float] = None,
                 min_replay_rows: int = 16,
                 replay_capacity: int = 512,
                 shadow_batch: int = 16,
                 label_name: Optional[str] = None,
                 golden_rows: int = 16,
                 golden_tol: float = 1e-3,
                 bake_rows: int = 256,
                 probe_every: int = 64,
                 error_rate_max: float = 0.05):
        self.pred_distance_max = float(pred_distance_max)
        self.pred_psi_max = float(pred_psi_max)
        self.metric_tol = float(metric_tol)
        self.p99_factor = float(p99_factor)
        self.p99_bound_ms = p99_bound_ms
        self.min_replay_rows = int(min_replay_rows)
        self.replay_capacity = int(replay_capacity)
        self.shadow_batch = int(shadow_batch)
        self.label_name = label_name
        self.golden_rows = int(golden_rows)
        self.golden_tol = float(golden_tol)
        self.bake_rows = int(bake_rows)
        self.probe_every = int(probe_every)
        self.error_rate_max = float(error_rate_max)

    def to_json(self) -> Dict[str, Any]:
        return {"predDistanceMax": self.pred_distance_max,
                "predPsiMax": self.pred_psi_max,
                "metricTol": self.metric_tol,
                "p99Factor": self.p99_factor,
                "p99BoundMs": self.p99_bound_ms,
                "minReplayRows": self.min_replay_rows,
                "goldenTol": self.golden_tol,
                "bakeRows": self.bake_rows}


class SwapDecision:
    """Structured outcome of one guarded-swap proposal."""

    def __init__(self, accepted: bool, reasons: List[str],
                 checks: Dict[str, Any], version: Optional[int] = None):
        self.accepted = accepted
        self.reasons = reasons
        self.checks = checks
        self.version = version
        self.at = time.time()

    def to_json(self) -> Dict[str, Any]:
        return {"accepted": self.accepted, "reasons": list(self.reasons),
                "checks": dict(self.checks), "version": self.version,
                "at": self.at}


def _score_of(out: Any) -> float:
    """One comparable scalar per scored row: positive-class probability
    when the result carries one, else the raw prediction value."""
    if isinstance(out, dict):
        for key in ("probability_1", "prediction"):
            v = out.get(key)
            if isinstance(v, (int, float)):
                return float(v)
        for v in out.values():
            if isinstance(v, (int, float)):
                return float(v)
    if isinstance(out, (int, float)):
        return float(out)
    return 0.0


def _first_result(row_out: Dict[str, Any]) -> Any:
    """The first result feature's value of one scored row map."""
    for v in row_out.values():
        return v
    return None


def probe_digest(scorer, rows: Sequence[Dict[str, Any]],
                 decimals: int = 9) -> Optional[str]:
    """Content digest of a scorer's answers on probe ``rows`` (rounded to
    ``decimals`` so float formatting noise cannot diverge it): replicas
    that loaded the same artifact answer the same probe alike, so
    divergent digests mean divergent artifacts (the fleet swap's check,
    ROADMAP Queue A item 6.6.6)."""
    if not rows:
        return None
    out = scorer(list(rows))
    scores = [round(_score_of(_first_result(o)), decimals) for o in out]
    return hashlib.sha256(
        json.dumps(scores, sort_keys=True).encode()).hexdigest()


def _shadow_score(scorer, rows: Sequence[Dict[str, Any]],
                  batch: int) -> Dict[str, Any]:
    """Score ``rows`` in fixed micro-batches, collecting the comparable
    scalar per row plus per-batch wall times (the p99 source)."""
    scores: List[float] = []
    walls: List[float] = []
    for i in range(0, len(rows), batch):
        chunk = list(rows[i:i + batch])
        t0 = time.perf_counter()
        out = scorer(chunk)
        walls.append(time.perf_counter() - t0)
        scores.extend(_score_of(_first_result(r)) for r in out)
    walls.sort()
    p99 = walls[min(len(walls) - 1,
                    max(0, int(math.ceil(0.99 * len(walls))) - 1))]
    return {"scores": np.asarray(scores, np.float64),
            "p99_s": p99, "batches": len(walls)}


def _log_loss(labels: np.ndarray, probs: np.ndarray) -> float:
    p = np.clip(probs, 1e-7, 1 - 1e-7)
    return float(-(labels * np.log(p) + (1 - labels) * np.log1p(-p)).mean())


class GuardedSwap:
    """Guarded rollout controller for ONE registry name.

    Wire it behind a server with ``ModelServer.with_guard`` (live traffic
    then feeds the replay window and drives bake probes automatically),
    or drive it directly: ``record_traffic`` → ``propose`` →
    ``bake_probe``.
    """

    def __init__(self, registry: ModelRegistry, name: str,
                 gate: Optional[SwapGateConfig] = None,
                 metrics: Optional[ServingMetrics] = None,
                 sample_rate: float = 1.0, seed: int = 11):
        self.registry = registry
        self.name = name
        self.gate = gate or SwapGateConfig()
        self.metrics = metrics or ServingMetrics()
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(seed)
        self._sample_rate = float(sample_rate)
        self._replay: List[Dict[str, Any]] = []
        self._replay_pos = 0
        self._proposals = 0
        self._probes = 0
        #: bake state after an accepted swap: golden rows + expected
        #: scores, error counters at swap time, rows left to bake
        self._bake: Optional[Dict[str, Any]] = None
        self.last_decision: Optional[SwapDecision] = None

    # -- replay window -------------------------------------------------------

    def record_traffic(self, rows: Sequence[Dict[str, Any]]) -> None:
        """Sample live rows into the bounded replay ring; during a bake
        window, also advance the bake budget and run due probes."""
        probe_due = False
        with self._lock:
            if rows and (self._sample_rate >= 1.0
                         or self._rng.random() < self._sample_rate):
                for r in rows:
                    if not isinstance(r, dict):
                        continue
                    if len(self._replay) < self.gate.replay_capacity:
                        self._replay.append(dict(r))
                    else:
                        self._replay[self._replay_pos] = dict(r)
                        self._replay_pos = ((self._replay_pos + 1)
                                            % self.gate.replay_capacity)
            if self._bake is not None and rows:
                self._bake["rows_seen"] += len(rows)
                if (self._bake["rows_seen"] - self._bake["last_probe_rows"]
                        >= self.gate.probe_every):
                    self._bake["last_probe_rows"] = self._bake["rows_seen"]
                    probe_due = True
        if probe_due:
            self.bake_probe()

    def replay_rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._replay)

    # -- shadow gate ---------------------------------------------------------

    def propose(self, model, path: Optional[str] = None,
                replay: Optional[Sequence[Dict[str, Any]]] = None,
                scorer: Optional[Callable] = None) -> SwapDecision:
        """Shadow-validate ``model`` against the live entry; swap only on
        pass.  ``replay`` overrides/extends the sampled window;
        ``scorer`` overrides the candidate's score function (tests)."""
        from ..local.scorer import score_function_batch

        live = self.registry.get(self.name)
        rows = list(replay) if replay is not None else self.replay_rows()
        reasons: List[str] = []
        checks: Dict[str, Any] = {"rows": len(rows)}
        self._proposals += 1
        try:
            faults.fire("swap.shadow", index=self._proposals - 1)
            if len(rows) < self.gate.min_replay_rows:
                reasons.append(
                    f"insufficient_replay:{len(rows)}"
                    f"<{self.gate.min_replay_rows}")
            else:
                cand_scorer = scorer or score_function_batch(model)
                cand = _shadow_score(cand_scorer, rows,
                                     self.gate.shadow_batch)
                ref = _shadow_score(live.scorer, rows,
                                    self.gate.shadow_batch)
                self._gate_predictions(cand, ref, rows, reasons, checks)
                self._gate_latency(cand, ref, reasons, checks)
        except Exception as exc:
            reasons.append(f"shadow_error:{type(exc).__name__}")
        decision = self._conclude(model, path, rows, reasons, checks)
        return decision

    def _gate_predictions(self, cand, ref, rows, reasons, checks) -> None:
        a, b = cand["scores"], ref["scores"]
        dist = float(np.abs(a - b).mean()) if len(a) else 0.0
        checks["predDistance"] = round(dist, 5)
        if dist > self.gate.pred_distance_max:
            reasons.append(
                f"pred_distance:{dist:.4f}>{self.gate.pred_distance_max}")
        # distribution shift of the scores themselves (catches a
        # collapsed-to-constant candidate that small mean distance hides)
        grid = np.linspace(0.0, 1.0, 11)
        psi = psi_from_counts(np.histogram(b, bins=grid)[0],
                              np.histogram(a, bins=grid)[0])
        checks["predPsi"] = round(psi, 4)
        if psi > self.gate.pred_psi_max:
            reasons.append(f"pred_psi:{psi:.3f}>{self.gate.pred_psi_max}")
        label = self.gate.label_name
        if label is not None:
            labeled = [(i, r[label]) for i, r in enumerate(rows)
                       if isinstance(r.get(label), (int, float))]
            if labeled:
                idx = np.asarray([i for i, _ in labeled])
                y = np.asarray([v for _, v in labeled], np.float64)
                cand_ll = _log_loss(y, a[idx])
                live_ll = _log_loss(y, b[idx])
                checks["candLogLoss"] = round(cand_ll, 5)
                checks["liveLogLoss"] = round(live_ll, 5)
                if cand_ll > live_ll + self.gate.metric_tol:
                    reasons.append(
                        f"metric_parity:logloss {cand_ll:.4f} > "
                        f"{live_ll:.4f}+{self.gate.metric_tol}")

    def _gate_latency(self, cand, ref, reasons, checks) -> None:
        cand_ms = cand["p99_s"] * 1000.0
        ref_ms = ref["p99_s"] * 1000.0
        checks["candP99Ms"] = round(cand_ms, 3)
        checks["liveP99Ms"] = round(ref_ms, 3)
        if cand_ms > max(ref_ms * self.gate.p99_factor, 1.0):
            reasons.append(
                f"latency:p99 {cand_ms:.1f}ms > "
                f"{self.gate.p99_factor}x live ({ref_ms:.1f}ms)")
        if (self.gate.p99_bound_ms is not None
                and cand_ms > self.gate.p99_bound_ms):
            reasons.append(
                f"latency:p99 {cand_ms:.1f}ms > bound "
                f"{self.gate.p99_bound_ms}ms")

    def _conclude(self, model, path, rows, reasons, checks) -> SwapDecision:
        if reasons:
            decision = SwapDecision(False, reasons, checks)
            self.last_decision = decision
            self.metrics.record_swap_decision(decision.to_json())
            record_event("swap.reject", reasons=list(reasons),
                         replay_rows=len(rows))
            return decision
        # PASS: pin the outgoing generation first — the rollback target
        # must exist before the new generation can take traffic
        self.registry.pin(self.name)
        entry = self.registry.register(self.name, model, path=path)
        golden = self._capture_golden(entry, rows)
        snap = self.metrics.snapshot()
        with self._lock:
            self._bake = {
                "version": entry.version,
                "golden": golden,
                "rows_seen": 0,
                "last_probe_rows": 0,
                "errors_at_swap": (snap["deviceErrors"]
                                   + snap["hostFallbacks"]),
                "requests_at_swap": snap["requests"],
            }
        decision = SwapDecision(True, [], checks, version=entry.version)
        self.last_decision = decision
        self.metrics.record_swap_decision(decision.to_json())
        record_event("swap.accept", version=entry.version,
                     replay_rows=len(rows))
        return decision

    def _capture_golden(self, entry: ModelEntry, rows) -> List[Dict[str, Any]]:
        """Golden queries = replay rows + the accepted candidate's own
        answers at decision time; bake probes assert the SERVED model
        still answers them (catches post-swap corruption/regression)."""
        take = list(rows[: self.gate.golden_rows])
        if not take:
            return []
        out = entry.scorer(take)
        return [{"row": r, "score": _score_of(_first_result(o))}
                for r, o in zip(take, out)]

    # -- bake window + rollback ----------------------------------------------

    @property
    def baking(self) -> bool:
        with self._lock:
            return self._bake is not None

    def bake_probe(self) -> Optional[str]:
        """Probe the CURRENT entry against the golden queries; returns the
        rollback reason when one fired (None otherwise).  Ends the bake
        window once ``bake_rows`` of traffic passed without incident."""
        with self._lock:
            bake = self._bake
        if bake is None:
            return None
        self._probes += 1
        reason: Optional[str] = None
        try:
            faults.fire("swap.bake", index=self._probes - 1)
            entry = self.registry.get(self.name)
            if entry.version != bake["version"]:
                # someone else swapped/rolled back under us: stop baking
                with self._lock:
                    self._bake = None
                return None
            golden = bake["golden"]
            if golden:
                out = entry.scorer([g["row"] for g in golden])
                got = np.asarray(
                    [_score_of(_first_result(o)) for o in out], np.float64)
                want = np.asarray([g["score"] for g in golden], np.float64)
                bad = int((np.abs(got - want) > self.gate.golden_tol).sum())
                if bad:
                    reason = f"probe_mismatch:{bad}/{len(golden)}"
            if reason is None:
                snap = self.metrics.snapshot()
                d_req = max(snap["requests"] - bake["requests_at_swap"], 1)
                d_err = ((snap["deviceErrors"] + snap["hostFallbacks"])
                         - bake["errors_at_swap"])
                rate = d_err / d_req
                if rate > self.gate.error_rate_max:
                    reason = f"error_rate:{rate:.3f}>{self.gate.error_rate_max}"
        except Exception as exc:
            reason = f"probe_error:{type(exc).__name__}"
        record_event("swap.bake_probe", probe=self._probes - 1,
                     ok=reason is None, reason=reason)
        if reason is not None:
            self.rollback(reason)
            return reason
        with self._lock:
            if (self._bake is bake
                    and bake["rows_seen"] >= self.gate.bake_rows):
                self._bake = None  # baked clean: the swap is final
        return None

    def rollback(self, reason: str) -> ModelEntry:
        """Reinstate the pinned last-known-good generation and record the
        structured reason (visible as ``lastRollbackReason`` in
        /metrics).  The circuit-breaker path is untouched — rollback is a
        model-quality action, not a device-health one."""
        entry = self.registry.rollback(self.name)
        self.metrics.record_rollback(reason)
        record_event("swap.rollback", reason=reason,
                     version=entry.version)
        with self._lock:
            self._bake = None
        return entry

    # -- reading -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            bake = None
            if self._bake is not None:
                bake = {"version": self._bake["version"],
                        "rowsSeen": self._bake["rows_seen"],
                        "goldenRows": len(self._bake["golden"])}
            return {
                "gate": self.gate.to_json(),
                "replayRows": len(self._replay),
                "proposals": self._proposals,
                "probes": self._probes,
                "baking": bake,
                "lastDecision": (self.last_decision.to_json()
                                 if self.last_decision else None),
            }
