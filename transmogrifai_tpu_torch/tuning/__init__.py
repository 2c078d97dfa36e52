"""Adaptive model selection (counterpart of ``transmogrifai_tpu.tuning``):
the fitted cost model the straggler watchdog reads, and successive
halving over the selector's grid.  The budgeter, the planner and
``train(tuner=)`` are ROADMAP Queue A item 6.5."""
from .costmodel import (  # noqa: F401
    CostModel, StageObservation, append_observations, default_history_path,
    load_observations)
from .halving import (  # noqa: F401
    HalvingConfig, Rung, halving_validate, nested_subsample_order,
    rung_schedule)

__all__ = ["CostModel", "StageObservation", "append_observations",
           "default_history_path", "load_observations", "HalvingConfig",
           "Rung", "halving_validate", "nested_subsample_order",
           "rung_schedule"]
