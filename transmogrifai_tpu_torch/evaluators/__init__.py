"""Evaluators and metrics (counterpart of ``transmogrifai_tpu.evaluators``)."""
from .evaluators import (  # noqa: F401
    Evaluators, OpBinaryClassificationEvaluator,
    OpMultiClassificationEvaluator, OpRegressionEvaluator,
    OpForecastEvaluator, OpBinScoreEvaluator,
)
from . import metrics  # noqa: F401
