"""Feature DSL — the fluent methods of the reference's Rich* feature
classes (counterpart of ``transmogrifai_tpu.dsl``), installed on
``Feature`` when the package is imported.

Feature arithmetic (``+ - * /`` with a feature or a scalar), ``alias``,
the ``dsl_transformers`` methods (``filter_values``, ``replace_value``,
``to_occur``, ``exists``, ``contains``, ``jaccard_similarity``,
``ngram_similarity``, ``drop_indices_by``), text (``tokenize``,
``ngrams``, ``remove_stop_words``, ``hashing_tf``, ``index_string``,
``text_len``, ``word2vec``, ``lda``), dates (``to_unit_circle``,
``to_time_period``, ``map_to_time_period``, ``vectorize_date_list``),
numerics (``bucketize``, ``auto_bucketize``, ``fill_missing_with_mean``,
``zscore``, ``calibrate_percentile``), ``sanity_check`` and
``vectorize`` (a one-feature ``transmogrify``).  Every method returns a
new Feature wired through its stage.
"""
from __future__ import annotations

from typing import Any, Callable

from .features.feature import Feature
from .ops.date_geo import (DateListVectorizer, DateToUnitCircleVectorizer,
                           TimePeriodMapTransformer, TimePeriodTransformer)
from .ops.dsl_transformers import (AliasTransformer, DropIndicesByTransformer,
                                   ExistsTransformer, FilterTransformer,
                                   JaccardSimilarity, MathBinaryTransformer,
                                   MathScalarTransformer, NGramSimilarity,
                                   ReplaceTransformer, SubstringTransformer,
                                   ToOccurTransformer)
from .ops.embeddings import OpLDA, OpWord2Vec
from .ops.numeric import (DecisionTreeNumericBucketizer, FillMissingWithMean,
                          NumericBucketizer, OpScalarStandardScaler,
                          PercentileCalibrator)
from .ops.text import (OpHashingTF, OpNGram, OpStopWordsRemover,
                       OpStringIndexer, TextLenTransformer, TextTokenizer)

__all__ = ["install_dsl"]


def _binary_math(op: str):
    def method(self: Feature, other) -> Feature:
        if isinstance(other, Feature):
            return MathBinaryTransformer(op).set_input(
                self, other).get_output()
        return MathScalarTransformer(op, float(other)).set_input(
            self).get_output()

    return method


def _unary(stage_factory: Callable[..., Any]):
    def method(self: Feature, *args, **kwargs) -> Feature:
        return stage_factory(*args, **kwargs).set_input(self).get_output()

    return method


def _binary(stage_factory: Callable[..., Any]):
    def method(self: Feature, other: Feature, *args, **kwargs) -> Feature:
        return stage_factory(*args, **kwargs).set_input(
            self, other).get_output()

    return method


def _alias(self: Feature, name: str) -> Feature:
    return AliasTransformer(name).set_input(self).get_output()


def _replace_value(self: Feature, replace, with_value) -> Feature:
    return ReplaceTransformer(replace, with_value).set_input(
        self).get_output()


def _auto_bucketize(self: Feature, label: Feature, **kwargs) -> Feature:
    """Supervised buckets of this numeric feature against ``label``."""
    return DecisionTreeNumericBucketizer(**kwargs).set_input(
        label, self).get_output()


def _sanity_check(self: Feature, label: Feature, **kwargs) -> Feature:
    """SanityChecker of this feature vector against ``label``."""
    from .preparators.sanity_checker import SanityChecker

    return SanityChecker(**kwargs).set_input(label, self).get_output()


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
    F.filter_values = _unary(FilterTransformer)
    F.replace_value = _replace_value
    F.to_occur = _unary(ToOccurTransformer)
    F.exists = _unary(ExistsTransformer)
    F.contains = _binary(SubstringTransformer)
    F.jaccard_similarity = _binary(JaccardSimilarity)
    F.ngram_similarity = _binary(NGramSimilarity)
    F.drop_indices_by = _unary(DropIndicesByTransformer)
    F.tokenize = _unary(TextTokenizer)
    F.ngrams = _unary(OpNGram)
    F.remove_stop_words = _unary(OpStopWordsRemover)
    F.hashing_tf = _unary(OpHashingTF)
    F.index_string = _unary(OpStringIndexer)
    F.text_len = _unary(TextLenTransformer)
    F.word2vec = _unary(OpWord2Vec)
    F.lda = _unary(OpLDA)
    F.to_unit_circle = _unary(DateToUnitCircleVectorizer)
    F.to_time_period = _unary(TimePeriodTransformer)
    F.map_to_time_period = _unary(TimePeriodMapTransformer)
    F.vectorize_date_list = _unary(DateListVectorizer)
    F.bucketize = _unary(NumericBucketizer)
    F.auto_bucketize = _auto_bucketize
    F.fill_missing_with_mean = _unary(FillMissingWithMean)
    F.zscore = _unary(OpScalarStandardScaler)
    F.calibrate_percentile = _unary(PercentileCalibrator)
    F.sanity_check = _sanity_check
    F.vectorize = _vectorize


install_dsl()
