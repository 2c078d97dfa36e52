"""Monoid aggregators and event-window extraction (see the package's
docstring)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Type

from ..types.feature_types import (
    Binary, Date, DateList, DateTime, FeatureType, OPList, OPMap, OPNumeric,
    OPSet, Text, TextList,
)

__all__ = [
    "Event", "CutOffTime", "MonoidAggregator", "CustomMonoidAggregator",
    "TimeBasedAggregator", "FeatureAggregator", "default_aggregator",
    "register_aggregator", "AGGREGATOR_REGISTRY",
]


@dataclasses.dataclass(frozen=True)
class Event:
    """One timestamped raw value (Event.scala:44)."""
    time_ms: int
    value: Any


class CutOffTime:
    """Reference-record cutoff spec (CutOffTime.scala).

    ``kind``: 'unix' (absolute ms), 'no_cutoff', or 'function'
    (record -> ms, the DayOfWeek/Age analogues collapse to this).
    """

    def __init__(self, kind: str = "no_cutoff",
                 time_ms: Optional[int] = None,
                 fn: Optional[Callable[[Any], int]] = None):
        self.kind = kind
        self.time_ms = time_ms
        self.fn = fn

    @staticmethod
    def unix(time_ms: int) -> "CutOffTime":
        return CutOffTime("unix", time_ms=time_ms)

    @staticmethod
    def no_cutoff() -> "CutOffTime":
        return CutOffTime("no_cutoff")

    @staticmethod
    def function(fn: Callable[[Any], int]) -> "CutOffTime":
        return CutOffTime("function", fn=fn)

    def cutoff_for(self, record: Any) -> Optional[int]:
        if self.kind == "unix":
            return self.time_ms
        if self.kind == "function":
            return self.fn(record)
        return None


class MonoidAggregator:
    """prepare -> monoid plus -> present (Algebird MonoidAggregator shape)."""

    name = "base"

    def zero(self) -> Any:
        return None

    def prepare(self, value: Any) -> Any:
        return value

    def plus(self, a: Any, b: Any) -> Any:
        raise NotImplementedError

    def present(self, agg: Any) -> Any:
        return agg

    def reduce(self, values: Sequence[Any]) -> Any:
        acc = self.zero()
        for v in values:
            if v is None:
                continue
            acc = self.plus(acc, self.prepare(v)) if acc is not None \
                else self.prepare(v)
        return self.present(acc)


class _SumNumeric(MonoidAggregator):
    name = "sumNumeric"

    def plus(self, a, b):
        return a + b


class _MaxBoolean(MonoidAggregator):
    name = "maxBoolean"

    def plus(self, a, b):
        return bool(a) or bool(b)


class _MinTime(MonoidAggregator):
    name = "minTime"

    def plus(self, a, b):
        return min(a, b)


class _MaxTime(MonoidAggregator):
    name = "maxTime"

    def plus(self, a, b):
        return max(a, b)


class _ConcatText(MonoidAggregator):
    name = "concatText"

    def plus(self, a, b):
        return f"{a} {b}"


class _ConcatList(MonoidAggregator):
    name = "concatList"

    def prepare(self, value):
        return list(value) if isinstance(value, (list, tuple, set, frozenset)) \
            else [value]

    def plus(self, a, b):
        return list(a) + list(b)


class _UnionSet(MonoidAggregator):
    name = "unionSet"

    def prepare(self, value):
        return frozenset(value) if isinstance(
            value, (list, tuple, set, frozenset)) else frozenset([value])

    def plus(self, a, b):
        return a | b


class _UnionMapSum(MonoidAggregator):
    """Map union with numeric value-sum / non-numeric last-wins
    (ExtendedMultiset-style union, MonoidAggregatorDefaults maps)."""

    name = "unionMap"

    def plus(self, a, b):
        out = dict(a)
        for k, v in b.items():
            if k in out and isinstance(v, (int, float)) \
                    and not isinstance(v, bool):
                out[k] = out[k] + v
            else:
                out[k] = v
        return out


class CustomMonoidAggregator(MonoidAggregator):
    """Escape hatch (CustomMonoidAggregator.scala)."""

    name = "custom"

    def __init__(self, zero: Any, plus: Callable[[Any, Any], Any],
                 prepare: Optional[Callable[[Any], Any]] = None,
                 present: Optional[Callable[[Any], Any]] = None):
        self._zero = zero
        self._plus = plus
        self._prepare = prepare
        self._present = present

    def zero(self):
        return self._zero

    def prepare(self, value):
        return self._prepare(value) if self._prepare else value

    def plus(self, a, b):
        return self._plus(a, b)

    def present(self, agg):
        return self._present(agg) if self._present else agg


class TimeBasedAggregator(MonoidAggregator):
    """First/last K values by event time (TimeBasedAggregator.scala)."""

    def __init__(self, k: int = 1, last: bool = True):
        self.k = k
        self.last = last
        self.name = ("last" if last else "first") + f"K{k}"

    def prepare(self, value):
        return [value]  # events arrive time-ordered from FeatureAggregator

    def plus(self, a, b):
        merged = list(a) + list(b)
        return merged[-self.k:] if self.last else merged[: self.k]

    def present(self, agg):
        if agg is None:
            return None
        return agg if self.k > 1 else agg[0]


AGGREGATOR_REGISTRY: Dict[str, MonoidAggregator] = {}


def register_aggregator(agg: MonoidAggregator) -> MonoidAggregator:
    AGGREGATOR_REGISTRY[agg.name] = agg
    return agg


for _a in (_SumNumeric(), _MaxBoolean(), _MinTime(), _MaxTime(),
           _ConcatText(), _ConcatList(), _UnionSet(), _UnionMapSum()):
    register_aggregator(_a)


def default_aggregator(ftype: Type[FeatureType]) -> MonoidAggregator:
    """Per-type default (MonoidAggregatorDefaults.aggregatorOf :52)."""
    if issubclass(ftype, Binary):
        return AGGREGATOR_REGISTRY["maxBoolean"]
    if issubclass(ftype, (Date, DateTime)):
        return AGGREGATOR_REGISTRY["maxTime"]
    if issubclass(ftype, OPNumeric):
        return AGGREGATOR_REGISTRY["sumNumeric"]
    if issubclass(ftype, OPMap):
        return AGGREGATOR_REGISTRY["unionMap"]
    if issubclass(ftype, OPSet):
        return AGGREGATOR_REGISTRY["unionSet"]
    if issubclass(ftype, (OPList, DateList, TextList)):
        return AGGREGATOR_REGISTRY["concatList"]
    if issubclass(ftype, Text):
        return AGGREGATOR_REGISTRY["concatText"]
    return AGGREGATOR_REGISTRY["sumNumeric"]


class FeatureAggregator:
    """Window-filter + reduce one feature's events
    (FeatureAggregator.extract :48-108).

    Predictors aggregate events strictly *before* the cutoff (within
    ``predictor_window_ms`` when given); responses aggregate events *at or
    after* the cutoff (within ``response_window_ms``) — the leakage-safe
    split that lets one event log produce both sides of a training row.
    """

    def __init__(self, ftype: Type[FeatureType], is_response: bool,
                 aggregator: Optional[MonoidAggregator] = None,
                 predictor_window_ms: Optional[int] = None,
                 response_window_ms: Optional[int] = None):
        self.ftype = ftype
        self.is_response = is_response
        self.aggregator = aggregator or default_aggregator(ftype)
        self.predictor_window_ms = predictor_window_ms
        self.response_window_ms = response_window_ms

    def extract(self, events: Sequence[Event],
                cutoff_ms: Optional[int]) -> Any:
        events = sorted(events, key=lambda e: e.time_ms)
        if cutoff_ms is None:
            keep = events
        elif self.is_response:
            hi = (cutoff_ms + self.response_window_ms
                  if self.response_window_ms is not None else None)
            keep = [e for e in events if e.time_ms >= cutoff_ms
                    and (hi is None or e.time_ms < hi)]
        else:
            lo = (cutoff_ms - self.predictor_window_ms
                  if self.predictor_window_ms is not None else None)
            keep = [e for e in events if e.time_ms < cutoff_ms
                    and (lo is None or e.time_ms >= lo)]
        vals = [e.value for e in keep if e.value is not None]
        if not vals:
            return None
        return self.aggregator.reduce(vals)
