"""Test infrastructure (counterpart of ``transmogrifai_tpu.testkit``): the
test feature builder and the random typed generators."""
from .builder import TestFeatureBuilder
from .generators import (
    RandomBinary, RandomIntegral, RandomList, RandomMap, RandomPickList,
    RandomReal, RandomSet, RandomText, RandomVector,
)

__all__ = ["TestFeatureBuilder", "RandomReal", "RandomIntegral",
           "RandomBinary", "RandomText", "RandomPickList", "RandomList",
           "RandomSet", "RandomMap", "RandomVector"]
