"""FeatureBuilder — typed construction of raw features.

    age = FeatureBuilder.Real("age").as_predictor()
    label = FeatureBuilder.RealNN("label").as_response()

``from_dataframe`` (pandas schema inference) is not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Type

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

    def extract(self, fn: Callable[[Any], Any]) -> "_TypedFeatureBuilder":
        """Set the record->value extractor."""
        self._extract_fn = fn
        return self

    def _build(self, is_response: bool) -> Feature:
        stage = FeatureGeneratorStage(name=self.name, output_type=self.ftype,
                                      extract_fn=self._extract_fn,
                                      is_response=is_response)
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
    """Entry point: ``FeatureBuilder.<TypeName>(name)``."""

    @staticmethod
    def of(ftype: Type[FeatureType], name: str) -> _TypedFeatureBuilder:
        return _TypedFeatureBuilder(ftype, name)
