"""Algebra transformers behind the feature DSL (counterpart of
``transmogrifai_tpu.ops.dsl_transformers``).

Ported: ``MathBinaryTransformer`` (``+ - * /`` of two numeric features),
``MathScalarTransformer`` (a feature and a scalar) and
``AliasTransformer`` (a rename).  Both math stages take float64 host
arithmetic with the JAX package's mask rule: missing on either side, or a
non-finite result (division by zero included), is missing.  The other
DSL transformers (filter, substring, similarities, ...) are not ported
yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..stages.base import BinaryTransformer, UnaryTransformer
from ..types.columns import FeatureColumn
from ..types.feature_types import Real

__all__ = ["MathBinaryTransformer", "MathScalarTransformer",
           "AliasTransformer"]

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
