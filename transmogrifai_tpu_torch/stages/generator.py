"""Raw feature generation — stage #0 of every feature.

``extract_fn(record) -> value`` runs on the host over a reader's records;
when the reader yields ready-made columns the stage simply names the
column.  Event aggregation and its time windows are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Type

from ..features.feature import Feature
from ..types.columns import FeatureColumn
from ..types.feature_types import FeatureType
from .base import PipelineStage

__all__ = ["FeatureGeneratorStage"]


class FeatureGeneratorStage(PipelineStage):
    """Generates one raw feature column from raw records."""

    input_arity = (0, 0)

    def __init__(self, name: str, output_type: Type[FeatureType],
                 extract_fn: Optional[Callable[[Any], Any]] = None,
                 is_response: bool = False, uid: Optional[str] = None):
        super().__init__(operation_name="FeatureGenerator",
                         output_type=output_type, uid=uid)
        self.name = name
        self.extract_fn = extract_fn
        self.is_response = is_response
        self._output_feature = Feature(name=name, ftype=output_type,
                                       is_response=is_response,
                                       origin_stage=self, parents=[])

    def make_output_name(self) -> str:
        return self.name

    def output_is_response(self) -> bool:
        return self.is_response

    def extract_column(self, records: Sequence[Any]) -> FeatureColumn:
        fn = self.extract_fn or (
            lambda r: r.get(self.name) if isinstance(r, dict)
            else getattr(r, self.name))
        return FeatureColumn.from_values(self.output_type,
                                         [fn(r) for r in records])
