"""Vector column metadata — per-slot provenance of the feature matrix.

Reference: ``OpVectorMetadata`` / ``OpVectorColumnMetadata`` /
``OpVectorColumnHistory`` (features/.../utils/spark/OpVectorMetadata.scala,
OpVectorColumnMetadata.scala, OpVectorColumnHistory.scala).  Every slot of the
assembled feature vector records which raw feature it came from, its grouping
(e.g. the pivot value or map key), the indicator value for one-hot slots, and
whether it's a null-indicator.  SanityChecker, ModelInsights and LOCO all key
off this structure, so it is designed in from the start (SURVEY §7 hard part e).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

__all__ = ["VectorColumnMetadata", "VectorMetadata"]

OTHER_INDICATOR = "OTHER"
NULL_INDICATOR = "NullIndicatorValue"


@dataclasses.dataclass
class VectorColumnMetadata:
    """Provenance of one slot in the feature vector.

    Mirrors OpVectorColumnMetadata: parentFeatureName, parentFeatureType,
    grouping (pivot group / map key), indicatorValue (one-hot value),
    descriptorValue (e.g. 'x' / 'y' for unit-circle), index.
    """

    parent_feature: str
    parent_type: str
    grouping: Optional[str] = None
    indicator_value: Optional[str] = None
    descriptor_value: Optional[str] = None
    index: int = 0

    def column_name(self) -> str:
        parts = [self.parent_feature]
        if self.grouping:
            parts.append(self.grouping)
        if self.descriptor_value:
            parts.append(self.descriptor_value)
        elif self.indicator_value:
            parts.append(self.indicator_value)
        return "_".join(parts) + f"_{self.index}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class VectorMetadata:
    """Metadata for a whole OPVector feature: ordered slot provenance."""

    def __init__(self, name: str, columns: Sequence[VectorColumnMetadata]):
        self.name = name
        self.columns: List[VectorColumnMetadata] = list(columns)
        for i, c in enumerate(self.columns):
            c.index = i

    @property
    def size(self) -> int:
        return len(self.columns)

    def column_names(self) -> List[str]:
        return [c.column_name() for c in self.columns]

    @staticmethod
    def flatten(name: str, parts: Sequence["VectorMetadata"]) -> "VectorMetadata":
        """Concatenate metadata of combined vectors (VectorsCombiner parity)."""
        cols: List[VectorColumnMetadata] = []
        for p in parts:
            for c in p.columns:
                cols.append(dataclasses.replace(c))
        return VectorMetadata(name, cols)

    def select(self, indices: Sequence[int]) -> "VectorMetadata":
        """Metadata after keeping only ``indices`` slots (SanityChecker drop)."""
        return VectorMetadata(
            self.name, [dataclasses.replace(self.columns[i]) for i in indices]
        )

    def to_json(self) -> dict:
        return {"name": self.name, "columns": [c.to_json() for c in self.columns]}

    def __repr__(self):
        return f"VectorMetadata(name={self.name!r}, size={self.size})"
