"""BenchBudgeter — budget decisions from measured history and the cost
model (counterpart of ``transmogrifai_tpu.tuning.budget``).

An estimate comes from, in order: (1) the measured history of the same
config and workload signature, (2) the learned cost model's
whole-pipeline prediction at the ``<rows>x<cols>`` shape the signature
encodes, (3) the caller's stated assumption; the source is reported next
to the number.  History writes are atomic (a temp file, then
``os.replace``) and keep every other key of the file.
"""
from __future__ import annotations

import re
import time
from typing import Dict, Optional, Tuple

from .costmodel import CostModel

__all__ = ["BenchBudgeter", "estimate_from_history", "record_measurement"]

_SIG_SHAPE = re.compile(r"^(\d+)x(\d+)")


def _load_history(path: Optional[str]) -> dict:
    from ..utils.jsonio import read_json_tolerant

    if not path:
        return {}
    hist = read_json_tolerant(path, {})
    return hist if isinstance(hist, dict) else {}


def estimate_from_history(path: Optional[str], name: str,
                          fallback_s: float,
                          sig: str = "") -> Tuple[float, str]:
    """(estimate_s, source): the measured history of the same config and
    the same workload signature if present, else the stated fallback."""
    h = _load_history(path).get(name)
    if isinstance(h, dict) and "measured_s" in h and h.get("sig", "") == sig:
        return float(h["measured_s"]), "measured_history"
    return fallback_s, "assumed"


def record_measurement(path: Optional[str], name: str, measured_s: float,
                       cold: bool, sig: str = "") -> None:
    """Record a measured wall for the next run's estimates, atomically,
    keeping every other key (the cost model's ``stage_observations``
    too)."""
    from ..utils.jsonio import write_json_atomic

    if not path:
        return
    hist = _load_history(path)
    hist[name] = {"measured_s": round(measured_s, 1), "cold": cold,
                  "sig": sig, "recorded_unix": int(time.time())}
    try:
        write_json_atomic(path, hist, indent=2, sort_keys=True)
    except OSError:
        pass


class BenchBudgeter:
    """Wall-clock budget arbiter for a bench suite.

    One instance per run: it owns the clock, the reserve for a config
    that must run last, the estimate sources and the skip bookkeeping.
    """

    def __init__(self, history_path: Optional[str], budget_s: float,
                 clock=time.perf_counter,
                 cost_model: Optional[CostModel] = None,
                 t0: Optional[float] = None):
        self.history_path = history_path
        self.budget_s = float(budget_s)
        self._clock = clock
        self._t0 = clock() if t0 is None else t0
        self.reserve_s = 0.0
        #: lazily fitted from the shared history when first needed
        self._cost_model = cost_model
        self.decisions: Dict[str, dict] = {}

    # -- clock ---------------------------------------------------------------

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def remaining(self) -> float:
        return max(0.0, self.budget_s - self.reserve_s - self.elapsed())

    def set_reserve(self, seconds: float) -> None:
        """Reserve budget for an unconditional config that runs last."""
        self.reserve_s = max(0.0, float(seconds))

    # -- estimates -----------------------------------------------------------

    def cost_model(self) -> CostModel:
        if self._cost_model is None:
            self._cost_model = CostModel.from_history(self.history_path)
        return self._cost_model

    def estimate(self, name: str, fallback_s: float,
                 sig: str = "") -> Tuple[float, str]:
        """(estimate_s, source): measured_history > cost_model > assumed.

        The cost-model tier engages only when the signature encodes a
        ``<rows>x<cols>`` shape and the model has fitted stage kinds; its
        whole-pipeline sum is a floor (it knows per-stage walls, not grid
        width), so it is only trusted when it EXCEEDS the fallback —
        predicting "bigger than you assumed" is the useful direction for
        a budgeter, "smaller" may just be missing stages.
        """
        est, src = estimate_from_history(self.history_path, name,
                                         fallback_s, sig)
        if src == "measured_history":
            return est, src
        m = _SIG_SHAPE.match(sig or "")
        if m:
            rows, cols = int(m.group(1)), int(m.group(2))
            pred = self.cost_model().predict_total(rows, cols)
            if pred > fallback_s:
                return pred, "cost_model"
        return fallback_s, "assumed"

    def record(self, name: str, measured_s: float, cold: bool,
               sig: str = "") -> None:
        record_measurement(self.history_path, name, measured_s, cold, sig)

    # -- decisions -----------------------------------------------------------

    def should_skip(self, name: str, fallback_s: float,
                    sig: str = "") -> Optional[str]:
        """Skip reason when the estimate no longer fits the remaining
        budget (after the reserve), else None.  Every decision — run or
        skip — is kept in ``decisions`` for the emitted JSON."""
        est, src = self.estimate(name, fallback_s, sig)
        remaining = self.remaining()
        decision = {"estimate_s": round(est, 1), "source": src,
                    "remaining_s": round(remaining, 1)}
        if est > remaining:
            reason = (f"estimated {est:.0f}s ({src}) exceeds remaining "
                      f"budget ({remaining:.0f}s of {self.budget_s:.0f}s"
                      + (f" after reserving {self.reserve_s:.0f}s for the "
                         f"unconditional 1M default-grid headline)"
                         if self.reserve_s else ")"))
            decision["skipped"] = reason
            self.decisions[name] = decision
            return reason
        self.decisions[name] = decision
        return None

    def to_json(self) -> dict:
        return {"budgetSecs": self.budget_s,
                "reserveSecs": round(self.reserve_s, 1),
                "elapsedSecs": round(self.elapsed(), 1),
                "decisions": dict(self.decisions)}
