"""Raw feature generation — stage #0 of every feature (counterpart of
``transmogrifai_tpu.stages.generator``).

``extract_fn(record) -> value`` runs on the host over a reader's records;
when the reader yields ready-made columns the stage simply names the
column.  For the event readers (readers/aggregates.py, readers/events.py)
the stage also carries the feature's monoid aggregator (a registered
name; None is the type's default), its own aggregation window, the event
field it reads (``event_field``, what the TM060 lint tracks) and where
the user declared it (``source_location``, where TM060's findings point
and ``# tmog: disable=TM060`` suppresses).
"""
from __future__ import annotations

import os
import sys
from typing import Any, Callable, Optional, Sequence, Type

from ..features.feature import Feature
from ..types.columns import FeatureColumn
from ..types.feature_types import FeatureType
from .base import PipelineStage

__all__ = ["FeatureGeneratorStage"]

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _construction_site() -> Optional[str]:
    """``file:line`` of the first caller frame outside this package: where
    the user declared the feature."""
    try:
        f = sys._getframe(2)
    except ValueError:
        return None
    while f is not None:
        fn = f.f_code.co_filename
        if not os.path.abspath(fn).startswith(_PKG_ROOT + os.sep):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return None


class FeatureGeneratorStage(PipelineStage):
    """Generates one raw feature column from raw records."""

    input_arity = (0, 0)

    def __init__(self, name: str, output_type: Type[FeatureType],
                 extract_fn: Optional[Callable[[Any], Any]] = None,
                 is_response: bool = False,
                 aggregator: Optional[str] = None,
                 aggregate_window_ms: Optional[int] = None,
                 event_field: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="FeatureGenerator",
                         output_type=output_type, uid=uid)
        self.name = name
        self.extract_fn = extract_fn
        self.is_response = is_response
        #: a registered monoid aggregator's name; None = the type's default
        self.aggregator = aggregator
        self.aggregate_window_ms = aggregate_window_ms
        #: the event-record field this feature reads (an extractor is
        #: opaque to the lint; without one the feature reads ``name``)
        self.event_field = event_field
        self.source_location = _construction_site()
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
