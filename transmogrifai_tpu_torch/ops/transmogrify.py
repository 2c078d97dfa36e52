"""``transmogrify()`` — automated feature engineering dispatcher.

Groups input features by semantic type, applies each group's default
vectorizer and combines the resulting OPVectors into one feature vector,
as ``transmogrifai_tpu.ops.transmogrify`` does.  Ported groups: reals
(``RealVectorizer``), integrals (``IntegralVectorizer``) and pivoted
categorical text (``OneHotVectorizer``); every other group raises
``NotImplementedError`` (ROADMAP Queue A).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Type

from ..features.feature import Feature
from ..types import feature_types as ft
from .vectorizers import (IntegralVectorizer, OneHotVectorizer,
                          RealVectorizer, VectorsCombiner)

__all__ = ["transmogrify", "TransmogrifierDefaults"]


class TransmogrifierDefaults:
    TOP_K = 20
    MIN_SUPPORT = 10
    TRACK_NULLS = True


_PIVOT_TEXT = (ft.PickList, ft.ComboBox, ft.Country, ft.State, ft.City,
               ft.PostalCode, ft.Street, ft.ID)


def transmogrify(features: Sequence[Feature],
                 top_k: int = TransmogrifierDefaults.TOP_K,
                 min_support: int = TransmogrifierDefaults.MIN_SUPPORT,
                 track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS,
                 ) -> Feature:
    """Vectorize a heterogeneous feature set into a single OPVector feature."""
    groups: Dict[str, List[Feature]] = {}
    for f in features:
        groups.setdefault(_group_of(f.ftype), []).append(f)
    vectors: List[Feature] = []
    # the JAX package's group order (its groups the port lacks raise below)
    for g in ("real", "integral", "pivot_text"):
        feats = groups.pop(g, [])
        if not feats:
            continue
        if g == "real":
            stage = RealVectorizer(track_nulls=track_nulls)
        elif g == "integral":
            stage = IntegralVectorizer(track_nulls=track_nulls)
        else:
            stage = OneHotVectorizer(top_k=top_k, min_support=min_support,
                                     track_nulls=track_nulls)
        stage.set_input(*feats)
        vectors.append(stage.get_output())
    if groups:
        raise NotImplementedError(
            f"vectorizers for groups {sorted(groups)} are not ported yet "
            f"(ROADMAP Queue A)")
    if len(vectors) == 1:
        return vectors[0]
    combiner = VectorsCombiner()
    combiner.set_input(*vectors)
    return combiner.get_output()


def _group_of(t: Type[ft.FeatureType]) -> str:
    # same precedence as the JAX package's dispatcher for the ported groups
    if issubclass(t, (ft.OPMap, ft.OPVector, ft.OPCollection, ft.Binary,
                      ft.Date)):
        return t.type_name()
    if issubclass(t, ft.Integral):
        return "integral"
    if issubclass(t, ft.Real):
        return "real"
    if issubclass(t, _PIVOT_TEXT):
        return "pivot_text"
    return t.type_name()
