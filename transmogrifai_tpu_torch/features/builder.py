"""FeatureBuilder — typed construction of raw features.

    age = FeatureBuilder.Real("age").as_predictor()
    label = FeatureBuilder.RealNN("label").as_response()
    visits = (FeatureBuilder.Integral("n_events").extract(lambda r: 1)
              .aggregate("sumNumeric").window(7 * DAY).as_predictor())
    label, predictors = FeatureBuilder.from_schema(
        {"age": Real, "y": RealNN}, response="y")

``aggregate``/``window``/``extract(event_field=)`` configure the feature
for the event readers (readers/aggregates.py, readers/events.py).
``from_dataframe`` (pandas schema inference) is not ported: the CLI types
its sample file itself (``cli/schema.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Type

from ..stages.generator import FeatureGeneratorStage
from ..types import feature_types as ft
from ..types.feature_types import FeatureType
from .feature import Feature

__all__ = ["FeatureBuilder"]


class _TypedFeatureBuilder:
    def __init__(self, ftype: Type[FeatureType], name: str):
        self.ftype = ftype
        self.name = name
        self._extract_fn: Optional[Callable[[Any], Any]] = None
        self._aggregator: Optional[str] = None
        self._window_ms: Optional[int] = None
        self._event_field: Optional[str] = None

    def extract(self, fn: Callable[[Any], Any],
                event_field: Optional[str] = None
                ) -> "_TypedFeatureBuilder":
        """Set the record->value extractor; ``event_field`` declares which
        event-record field it reads (for the TM060 lint)."""
        self._extract_fn = fn
        self._event_field = event_field
        return self

    def aggregate(self, aggregator: str) -> "_TypedFeatureBuilder":
        """A registered monoid aggregator's name (FeatureBuilder.aggregate)."""
        self._aggregator = aggregator
        return self

    def window(self, window_ms: int) -> "_TypedFeatureBuilder":
        """This feature's own aggregation window, in ms."""
        self._window_ms = window_ms
        return self

    def _build(self, is_response: bool) -> Feature:
        stage = FeatureGeneratorStage(
            name=self.name, output_type=self.ftype,
            extract_fn=self._extract_fn, is_response=is_response,
            aggregator=self._aggregator,
            aggregate_window_ms=self._window_ms,
            event_field=self._event_field)
        return stage.get_output()

    def as_predictor(self) -> Feature:
        return self._build(is_response=False)

    def as_response(self) -> Feature:
        if not issubclass(self.ftype, (ft.SingleResponse, ft.MultiResponse)):
            raise TypeError(
                f"{self.ftype.type_name()} cannot be a response feature")
        return self._build(is_response=True)


class _FeatureBuilderMeta(type):
    """Provides ``FeatureBuilder.Real("x")`` etc. for every registered type."""

    def __getattr__(cls, type_name: str):
        try:
            ftype = ft.type_by_name(type_name)
        except KeyError as e:
            raise AttributeError(type_name) from e

        def make(name: str) -> _TypedFeatureBuilder:
            return _TypedFeatureBuilder(ftype, name)

        return make


class FeatureBuilder(metaclass=_FeatureBuilderMeta):
    """Entry point: ``FeatureBuilder.<TypeName>(name)`` or ``from_schema``."""

    @staticmethod
    def of(ftype: Type[FeatureType], name: str) -> _TypedFeatureBuilder:
        return _TypedFeatureBuilder(ftype, name)

    @staticmethod
    def from_schema(schema: Dict[str, Type[FeatureType]], response: str,
                    response_type: Type[FeatureType] = ft.RealNN
                    ) -> Tuple[Feature, List[Feature]]:
        """(response, predictors) from {name: type}, in the schema's order
        (FeatureBuilder.fromSchema, features/FeatureBuilder.scala:193-246)."""
        if response not in schema:
            raise ValueError(f"response column {response!r} not in schema")
        resp = _TypedFeatureBuilder(response_type, response).as_response()
        preds = [_TypedFeatureBuilder(t, n).as_predictor()
                 for n, t in schema.items() if n != response]
        return resp, preds
