"""Raw-feature QA filters (counterpart of ``transmogrifai_tpu.filters``)."""
from .feature_distribution import FeatureDistribution, profile_column
from .raw_feature_filter import (ExclusionReasons, RawFeatureFilter,
                                 RawFeatureFilterResults)

__all__ = ["FeatureDistribution", "profile_column", "RawFeatureFilter",
           "RawFeatureFilterResults", "ExclusionReasons"]
