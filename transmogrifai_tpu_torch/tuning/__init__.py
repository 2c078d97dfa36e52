"""Adaptive model selection and plan choices (counterpart of
``transmogrifai_tpu.tuning``): the fitted cost model (``costmodel``) that
every train's stage observations feed and the straggler watchdog reads,
successive halving over the selector's grid (``halving``), the
``BenchBudgeter`` (``budget``), the cost planner's stream-or-in-core and
mesh advice (``planner``) and ``Tuner``, the handle of
``OpWorkflow.train(tuner=)``.

Everything is opt-in: ``train(tuner=None)`` and the selector's
``strategy="full"`` keep the default paths as they are.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .budget import BenchBudgeter, estimate_from_history, record_measurement
from .costmodel import (CostModel, StageObservation, append_observations,
                        default_history_path, load_observations,
                        observations_from_profiler,
                        record_train_observations)
from .halving import (HalvingConfig, Rung, halving_validate,
                      nested_subsample_order, rung_schedule)
from .planner import (MeshAdvice, PlanAdvice, advise_mesh, advise_plan,
                      default_host_budget_bytes)

__all__ = ["Tuner", "CostModel", "StageObservation", "append_observations",
           "default_history_path", "load_observations",
           "observations_from_profiler", "record_train_observations",
           "HalvingConfig", "Rung", "halving_validate",
           "nested_subsample_order", "rung_schedule", "BenchBudgeter",
           "estimate_from_history", "record_measurement", "PlanAdvice",
           "advise_plan", "MeshAdvice", "advise_mesh",
           "default_host_budget_bytes"]


@dataclass
class Tuner:
    """The ``OpWorkflow.train(tuner=...)`` handle: one object that opts a
    train into the adaptive machinery.

    ``strategy`` (and ``halving``, where given) is set on every
    ModelSelector of the DAG for this train only; the stages' own
    settings are restored afterwards.  ``auto_plan=True`` asks the cost
    planner to choose stream or in-core and the chunk geometry when the
    caller passed no ``chunk_rows`` and the reader can estimate its
    rows (``host_budget_bytes``: the budget it plans against, else
    ``default_host_budget_bytes()``)."""

    strategy: str = "halving"          # "halving" | "full"
    halving: Optional[HalvingConfig] = None
    auto_plan: bool = False
    cost_model: Optional[CostModel] = None
    host_budget_bytes: Optional[int] = None

    def resolved_cost_model(self) -> CostModel:
        """The given cost model, else one fitted from the history at
        ``TMOG_COST_HISTORY`` (cold without one)."""
        if self.cost_model is None:
            self.cost_model = CostModel.from_history()
        return self.cost_model
