"""Algebra transformers behind the feature DSL (counterpart of
``transmogrifai_tpu.ops.dsl_transformers``).

``MathBinaryTransformer`` (``+ - * /`` of two numeric features),
``MathScalarTransformer`` (a feature and a scalar), ``AliasTransformer``
(a rename), ``FilterTransformer``, ``ReplaceTransformer``,
``SubstringTransformer``, ``JaccardSimilarity``, ``NGramSimilarity``,
``ToOccurTransformer``, ``ExistsTransformer`` (with its ``present``
predicate) and ``DropIndicesByTransformer``.  Both math stages take
float64 host arithmetic with the JAX package's mask rule: missing on
either side, or a non-finite result (division by zero included), is
missing.  The others are host work over Python values, except
``DropIndicesByTransformer``, which gathers the kept slots of the device
matrix.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..stages.base import BinaryTransformer, UnaryTransformer
from ..types.columns import FeatureColumn
from ..types.feature_types import Binary, OPVector, Real, RealNN, Text
from .vector_metadata import VectorColumnMetadata

__all__ = ["MathBinaryTransformer", "MathScalarTransformer",
           "AliasTransformer", "FilterTransformer", "SubstringTransformer",
           "JaccardSimilarity", "NGramSimilarity", "ToOccurTransformer",
           "ExistsTransformer", "ReplaceTransformer",
           "DropIndicesByTransformer", "present"]

_BIN_OPS = {
    "plus": lambda a, b: a + b,
    "minus": lambda a, b: a - b,
    "multiply": lambda a, b: a * b,
    "divide": lambda a, b: np.divide(a, np.where(b == 0, np.nan, b)),
}


def _check_op(op: str) -> None:
    if op not in _BIN_OPS:
        raise ValueError(f"unknown op {op!r}")


class MathBinaryTransformer(BinaryTransformer):
    """Elementwise arithmetic of two numeric features; missing in either
    input -> missing out."""

    def __init__(self, op: str, uid: Optional[str] = None):
        super().__init__(operation_name=op, output_type=Real, uid=uid)
        _check_op(op)
        self.op = op

    def transform_columns(self, a: FeatureColumn,
                          b: FeatureColumn) -> FeatureColumn:
        va = np.nan_to_num(np.asarray(a.values, np.float64))
        vb = np.nan_to_num(np.asarray(b.values, np.float64))
        out = _BIN_OPS[self.op](va, vb)
        mask = np.asarray(a.mask) & np.asarray(b.mask) & np.isfinite(out)
        return FeatureColumn(Real, np.where(mask, out, np.nan), mask)


class MathScalarTransformer(UnaryTransformer):
    """feature <op> scalar."""

    def __init__(self, op: str, scalar: float, uid: Optional[str] = None):
        super().__init__(operation_name=f"{op}Scalar", output_type=Real,
                         uid=uid)
        _check_op(op)
        self.op = op
        self.scalar = scalar

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        v = np.nan_to_num(np.asarray(col.values, np.float64))
        out = _BIN_OPS[self.op](v, np.float64(self.scalar))
        mask = np.asarray(col.mask) & np.isfinite(out)
        return FeatureColumn(Real, np.where(mask, out, np.nan), mask)


class AliasTransformer(UnaryTransformer):
    """Rename-only pass-through: the output is the input column under
    ``name``, of the input's type."""

    def __init__(self, name: str, uid: Optional[str] = None):
        super().__init__(operation_name="alias", output_type=Real, uid=uid)
        self.name = name

    def on_set_input(self) -> None:
        self.output_type = self.input_features[0].ftype

    def make_output_name(self) -> str:
        return self.name

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        return col


class FilterTransformer(UnaryTransformer):
    """Keep the values that pass ``predicate``; the rest are missing."""

    def __init__(self, predicate: Callable[[Any], bool],
                 uid: Optional[str] = None):
        super().__init__(operation_name="filter", output_type=Real, uid=uid)
        self.predicate = predicate

    def on_set_input(self) -> None:
        self.output_type = self.input_features[0].ftype

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        kept = [v if v is not None and self.predicate(v) else None
                for v in col.to_list()]
        return FeatureColumn.from_values(self.output_type, kept)


class SubstringTransformer(BinaryTransformer):
    """Binary: the second text occurs in the first, case-insensitively;
    missing where either is missing."""

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="substring", output_type=Binary,
                         uid=uid)

    def transform_columns(self, a: FeatureColumn,
                          b: FeatureColumn) -> FeatureColumn:
        mask = np.array([x is not None and y is not None
                         for x, y in zip(a.values, b.values)], bool)
        out = np.array([m and str(y).lower() in str(x).lower()
                        for x, y, m in zip(a.values, b.values, mask)],
                       np.float64)
        return FeatureColumn(Binary, out, mask)


def _jaccard(s1, s2) -> float:
    a, b = set(s1), set(s2)
    if not a and not b:
        return 1.0
    return len(a & b) / len(a | b)


class JaccardSimilarity(BinaryTransformer):
    """Jaccard similarity of two sets or lists (1 when both are empty)."""

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="jaccardSim", output_type=RealNN,
                         uid=uid)

    def transform_columns(self, a: FeatureColumn,
                          b: FeatureColumn) -> FeatureColumn:
        out = np.array([_jaccard(x or (), y or ())
                        for x, y in zip(a.values, b.values)], np.float64)
        return FeatureColumn(RealNN, out, np.ones(len(out), bool))


class NGramSimilarity(BinaryTransformer):
    """Jaccard similarity of the lower-cased character n-grams of two
    texts (a list is joined by spaces first)."""

    def __init__(self, n: int = 3, uid: Optional[str] = None):
        super().__init__(operation_name="ngramSim", output_type=RealNN,
                         uid=uid)
        self.n = n

    def _grams(self, v) -> set:
        if v is None:
            return set()
        if isinstance(v, (tuple, list, set, frozenset)):
            v = " ".join(map(str, v))
        s = str(v).lower()
        return {s[i:i + self.n] for i in range(max(len(s) - self.n + 1, 0))}

    def transform_columns(self, a: FeatureColumn,
                          b: FeatureColumn) -> FeatureColumn:
        out = np.array([_jaccard(self._grams(x), self._grams(y))
                        for x, y in zip(a.values, b.values)], np.float64)
        return FeatureColumn(RealNN, out, np.ones(len(out), bool))


def _occurs(v) -> bool:
    return bool(v) or v == 0.0


class ToOccurTransformer(UnaryTransformer):
    """RealNN 1 where the value is present and ``matches`` it (by default:
    truthy, or zero), else 0."""

    def __init__(self, matches: Optional[Callable[[Any], bool]] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="toOccur", output_type=RealNN,
                         uid=uid)
        self.matches = matches

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        fn = self.matches or _occurs
        out = np.array([1.0 if (v is not None and fn(v)) else 0.0
                        for v in col.to_list()], np.float64)
        return FeatureColumn(RealNN, out, np.ones(len(out), bool))


def present(v) -> bool:
    """A value is present unless it is None or an empty collection (a
    missing collection is stored empty); an empty string is present."""
    if v is None:
        return False
    if isinstance(v, (list, tuple, set, frozenset, dict)):
        return len(v) > 0
    return True


class ExistsTransformer(UnaryTransformer):
    """Binary: the value is ``present``."""

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="exists", output_type=Binary, uid=uid)

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        out = np.array([present(v) for v in col.to_list()], np.float64)
        return FeatureColumn(Binary, out, np.ones(len(out), bool))


class ReplaceTransformer(UnaryTransformer):
    """Values equal to ``replace`` become ``with_value``."""

    def __init__(self, replace: Any, with_value: Any,
                 uid: Optional[str] = None):
        super().__init__(operation_name="replace", output_type=Text, uid=uid)
        self.replace = replace
        self.with_value = with_value

    def on_set_input(self) -> None:
        self.output_type = self.input_features[0].ftype

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        vals = [self.with_value if v == self.replace else v
                for v in col.to_list()]
        return FeatureColumn.from_values(self.output_type, vals)


class DropIndicesByTransformer(UnaryTransformer):
    """Drop the vector slots whose metadata ``predicate`` accepts."""

    def __init__(self, predicate: Callable[[VectorColumnMetadata], bool],
                 uid: Optional[str] = None):
        super().__init__(operation_name="dropIndicesBy",
                         output_type=OPVector, uid=uid)
        self.predicate = predicate

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        if col.vmeta is None:
            raise ValueError("input vector has no metadata to filter by")
        keep = [j for j, c in enumerate(col.vmeta.columns)
                if not self.predicate(c)]
        X = torch.as_tensor(col.values)
        idx = torch.as_tensor(keep, dtype=torch.long, device=X.device)
        return FeatureColumn(OPVector,
                             X.index_select(1, idx).to(torch.float32),
                             vmeta=col.vmeta.select(keep))
