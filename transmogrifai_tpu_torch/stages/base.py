"""Pipeline stage abstraction (counterpart of ``transmogrifai_tpu.stages.base``).

Stages transform whole columns, not rows.  An estimator's ``fit`` receives
the extracted input columns and returns a model that answers for the
estimator's output feature and uid.  The JAX package's fault-injection
hooks and streaming-fit protocol are not ported yet (ROADMAP Queue A).
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

from ..features.feature import Feature
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import FeatureType
from ..utils.uid import uid_for

__all__ = [
    "SchemaError", "PipelineStage", "Transformer", "Estimator", "Model",
    "SequenceTransformer", "SequenceEstimator", "SequenceModel",
    "BinaryEstimator", "BinaryModel",
]


class SchemaError(TypeError):
    """A stage was wired with an input of the wrong feature type."""


class PipelineStage:
    """Base of all stages.  Every hyperparameter is stored as an attribute
    named like its constructor keyword."""

    #: (min, max) allowed number of inputs; None = unbounded
    input_arity: Tuple[int, Optional[int]] = (1, None)
    #: declared per-position input types; the last entry repeats
    input_types: Optional[Tuple[Type[FeatureType], ...]] = None

    def __init__(self, operation_name: str, output_type: Type[FeatureType],
                 uid: Optional[str] = None):
        self.operation_name = operation_name
        self.output_type = output_type
        self.uid = uid or uid_for(type(self))
        self.input_features: List[Feature] = []
        self._output_feature: Optional[Feature] = None
        #: structured metadata attached during fit (summaries, vector metadata)
        self.metadata: Dict[str, Any] = {}

    def check_input_length(self, features: Sequence[Feature]) -> None:
        lo, hi = self.input_arity
        if len(features) < lo or (hi is not None and len(features) > hi):
            raise ValueError(
                f"{type(self).__name__} expects between {lo} and {hi} "
                f"inputs, got {len(features)}")

    def check_input_schema(self, features: Sequence[Feature]) -> None:
        if not self.input_types:
            return
        for i, f in enumerate(features):
            exp = self.input_types[min(i, len(self.input_types) - 1)]
            if not (isinstance(f.ftype, type) and issubclass(f.ftype, exp)):
                raise SchemaError(
                    f"{type(self).__name__}({self.uid}): input {i} "
                    f"({f.name!r}) must be {exp.__name__}, got "
                    f"{getattr(f.ftype, '__name__', f.ftype)}")

    def set_input(self, *features: Feature) -> "PipelineStage":
        self.check_input_length(features)
        self.check_input_schema(features)
        self.input_features = list(features)
        self._output_feature = Feature(
            name=self.make_output_name(), ftype=self.output_type,
            is_response=self.output_is_response(), origin_stage=self,
            parents=list(features))
        return self

    def output_is_response(self) -> bool:
        return any(f.is_response for f in self.input_features)

    def make_output_name(self) -> str:
        base = "-".join(f.name for f in self.input_features[:4]) or "out"
        return f"{base}_{self.operation_name}_{self.uid}"

    def get_output(self) -> Feature:
        if self._output_feature is None:
            raise RuntimeError(f"{self.uid}: set_input() not called")
        return self._output_feature

    @property
    def input_names(self) -> List[str]:
        return [f.name for f in self.input_features]

    _NON_PARAMS = frozenset({"uid", "operation_name", "output_type"})

    def get_params(self) -> Dict[str, Any]:
        """Hyperparameters: the constructor's keywords, read back from the
        attributes of the same names."""
        sig = inspect.signature(type(self).__init__)
        return {name: getattr(self, name)
                for name, p in sig.parameters.items()
                if name != "self" and name not in self._NON_PARAMS
                and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
                and hasattr(self, name)}

    def copy(self, **overrides) -> "PipelineStage":
        """A fresh, unwired instance with the same hyperparameters (and a
        new uid), ``overrides`` applied — how the model selector makes one
        estimator per grid point."""
        return type(self)(**{**self.get_params(), **overrides})

    def __repr__(self):
        return f"{type(self).__name__}(uid={self.uid!r})"


class Transformer(PipelineStage):
    """A fitted/stateless stage: input columns -> one output column."""

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        raise NotImplementedError

    def transform(self, data: ColumnarDataset) -> ColumnarDataset:
        """Copy-on-write transform: a new dataset with this stage's output
        column added; ``data`` is never mutated."""
        out = self.transform_columns(*[data[n] for n in self.input_names])
        return data.with_columns({self.get_output().name: out})


class Model(Transformer):
    """A fitted estimator; keeps the estimator's uid."""


class Estimator(PipelineStage):
    """A stage that must be fit before it can transform."""

    def fit_columns(self, data: ColumnarDataset,
                    *cols: FeatureColumn) -> Model:
        raise NotImplementedError

    def adopt_model(self, model: Model) -> Model:
        """Wire a freshly built model to answer for this estimator's output
        feature and uid."""
        model.uid = self.uid
        model.operation_name = self.operation_name
        model.input_features = list(self.input_features)
        model._output_feature = self._output_feature
        model.metadata = self.metadata
        return model

    def fit(self, data: ColumnarDataset) -> Model:
        model = self.fit_columns(data, *[data[n] for n in self.input_names])
        return self.adopt_model(model)


class SequenceTransformer(Transformer):
    input_arity = (1, None)


class SequenceModel(Model):
    input_arity = (1, None)


class SequenceEstimator(Estimator):
    input_arity = (1, None)


class BinaryModel(Model):
    input_arity = (2, 2)


class BinaryEstimator(Estimator):
    input_arity = (2, 2)
