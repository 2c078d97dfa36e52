"""Feature DSL — the fluent methods of the reference's Rich* feature
classes (counterpart of ``transmogrifai_tpu.dsl``), installed on
``Feature`` when the package is imported.

Ported: feature arithmetic (``+ - * /`` with a feature or a scalar),
``alias`` and ``vectorize`` (a one-feature ``transmogrify``).  The other
fluent methods (``tokenize``, ``word2vec``, ``bucketize``, ...) are not
ported yet.
"""
from __future__ import annotations

from .features.feature import Feature
from .ops.dsl_transformers import (AliasTransformer, MathBinaryTransformer,
                                   MathScalarTransformer)

__all__ = ["install_dsl"]


def _binary_math(op: str):
    def method(self: Feature, other) -> Feature:
        if isinstance(other, Feature):
            return MathBinaryTransformer(op).set_input(
                self, other).get_output()
        return MathScalarTransformer(op, float(other)).set_input(
            self).get_output()

    return method


def _alias(self: Feature, name: str) -> Feature:
    return AliasTransformer(name).set_input(self).get_output()


def _vectorize(self: Feature, **kwargs) -> Feature:
    """Single-feature ``transmogrify``."""
    from .ops.transmogrify import transmogrify

    return transmogrify([self], **kwargs)


def install_dsl() -> None:
    F = Feature
    F.__add__ = _binary_math("plus")
    F.__sub__ = _binary_math("minus")
    F.__mul__ = _binary_math("multiply")
    F.__truediv__ = _binary_math("divide")
    F.alias = _alias
    F.vectorize = _vectorize


install_dsl()
