"""Time-based monoid aggregation of event records into feature values
(counterpart of ``transmogrifai_tpu.aggregators``: host code, the same
semantics and the same reduce order).

Reference: ``features/aggregators/`` (SURVEY §2.4) —
``Event(date, value)`` (aggregators/Event.scala:44), ``FeatureAggregator.
extract`` filtering events by response/predictor cutoff windows then
monoid-reducing (aggregators/FeatureAggregator.scala:48-108), per-type
defaults in ``MonoidAggregatorDefaults.aggregatorOf``
(aggregators/MonoidAggregatorDefaults.scala:52): sums for numerics, concat
for lists/sets, multiset-style union for maps, min/max time for dates;
``CutOffTime`` spec (aggregators/CutOffTime.scala), first/last-K
``TimeBasedAggregator`` (aggregators/TimeBasedAggregator.scala), and the
``CustomMonoidAggregator`` escape hatch.
"""
from .aggregators import (
    AGGREGATOR_REGISTRY, CustomMonoidAggregator, CutOffTime, Event,
    FeatureAggregator, MonoidAggregator, TimeBasedAggregator,
    default_aggregator, register_aggregator,
)

__all__ = [
    "Event", "CutOffTime", "MonoidAggregator", "CustomMonoidAggregator",
    "TimeBasedAggregator", "FeatureAggregator", "default_aggregator",
    "register_aggregator", "AGGREGATOR_REGISTRY",
]
