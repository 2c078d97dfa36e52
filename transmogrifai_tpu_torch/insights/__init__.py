"""Model and record insights (counterpart of
``transmogrifai_tpu.insights``)."""
from .model_insights import (FeatureInsight, ModelInsights,
                             extract_model_insights, feature_importances)
from .record_insights import (NormType, RecordInsightsCorr,
                              RecordInsightsCorrModel, RecordInsightsLOCO,
                              parse_insights)

__all__ = ["ModelInsights", "FeatureInsight", "extract_model_insights",
           "feature_importances", "RecordInsightsLOCO", "RecordInsightsCorr",
           "RecordInsightsCorrModel", "NormType", "parse_insights"]
