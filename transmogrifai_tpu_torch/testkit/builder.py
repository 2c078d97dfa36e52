"""TestFeatureBuilder: in-memory typed datasets and their features
(counterpart of ``transmogrifai_tpu.testkit.builder``; reference
``TestFeatureBuilder.scala:50-265``, ``random`` :298).
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple, Type

from ..features.builder import FeatureBuilder
from ..features.feature import Feature
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import FeatureType

__all__ = ["TestFeatureBuilder"]


class TestFeatureBuilder:
    __test__ = False  # not a pytest test class

    @staticmethod
    def build(*named_columns: Tuple[str, Type[FeatureType], Sequence[Any]],
              response: str = "") -> Tuple[ColumnarDataset, List[Feature]]:
        """``build(("age", Real, [1, None, 3]), ...)`` gives the dataset and
        one raw feature a column (the one named ``response`` a
        response)."""
        cols = {}
        feats: List[Feature] = []
        for name, ftype, values in named_columns:
            cols[name] = FeatureColumn.from_values(ftype, list(values))
            builder = getattr(FeatureBuilder, ftype.type_name())(name)
            feats.append(builder.as_response() if name == response
                         else builder.as_predictor())
        return ColumnarDataset(cols), feats

    @staticmethod
    def random(n: int, *named_generators, response: str = "",
               types=None) -> Tuple[ColumnarDataset, List[Feature]]:
        """``random(100, ("x", Real, RandomReal.normal()), ...)``: ``n``
        values of each generator."""
        return TestFeatureBuilder.build(
            *[(name, ftype, gen.take(n))
              for name, ftype, gen in named_generators], response=response)
