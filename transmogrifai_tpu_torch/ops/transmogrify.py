"""``transmogrify()`` — automated feature engineering dispatcher
(counterpart of ``transmogrifai_tpu.ops.transmogrify``).

Groups input features by semantic type, applies each group's default
vectorizer and combines the resulting OPVectors into one feature vector.
All twelve groups of the JAX package, in its order and with its
precedence: real, integral, binary, date, date_list, pivot_text,
smart_text, multi_pick_list, text_list, geolocation, vector (passed
through) and map.  Defaults: TopK 20, min support 10, 512 hash features,
max cardinality 100, null tracking on.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Type

from ..features.feature import Feature
from ..types import feature_types as ft
from .date_geo import (DateListVectorizer, DateToUnitCircleVectorizer,
                       GeolocationVectorizer)
from .map_vectorizers import transmogrify_map_group
from .vectorizers import (BinaryVectorizer, IntegralVectorizer,
                          MultiPickListVectorizer, OneHotVectorizer,
                          RealVectorizer, SmartTextVectorizer,
                          TextHashingVectorizer, VectorsCombiner)

__all__ = ["transmogrify", "TransmogrifierDefaults"]


class TransmogrifierDefaults:
    TOP_K = 20
    MIN_SUPPORT = 10
    NUM_HASH_FEATURES = 512
    MAX_CARDINALITY = 100
    TRACK_NULLS = True


#: categorical text types that get a direct TopK pivot
_PIVOT_TEXT = (ft.PickList, ft.ComboBox, ft.Country, ft.State, ft.City,
               ft.PostalCode, ft.Street, ft.ID)

_ORDER = ("real", "integral", "binary", "date", "date_list", "pivot_text",
          "smart_text", "multi_pick_list", "text_list", "geolocation",
          "vector", "map")


def transmogrify(features: Sequence[Feature],
                 top_k: int = TransmogrifierDefaults.TOP_K,
                 min_support: int = TransmogrifierDefaults.MIN_SUPPORT,
                 num_hash_features: int =
                 TransmogrifierDefaults.NUM_HASH_FEATURES,
                 max_cardinality: int = TransmogrifierDefaults.MAX_CARDINALITY,
                 track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS,
                 ) -> Feature:
    """Vectorize a heterogeneous feature set into a single OPVector feature."""
    groups: Dict[str, List[Feature]] = {}
    for f in features:
        groups.setdefault(_group_of(f.ftype), []).append(f)
    vectors: List[Feature] = []
    for g in _ORDER:
        feats = groups.pop(g, [])
        if not feats:
            continue
        if g == "vector":
            vectors.extend(feats)
            continue
        if g == "map":
            vectors.extend(transmogrify_map_group(
                feats, top_k=top_k, min_support=min_support,
                num_hash_features=num_hash_features, track_nulls=track_nulls))
            continue
        if g == "real":
            stage = RealVectorizer(track_nulls=track_nulls)
        elif g == "integral":
            stage = IntegralVectorizer(track_nulls=track_nulls)
        elif g == "binary":
            stage = BinaryVectorizer(track_nulls=track_nulls)
        elif g == "date":
            stage = DateToUnitCircleVectorizer(track_nulls=track_nulls)
        elif g == "date_list":
            # the reference's default pivot: SinceLast
            stage = DateListVectorizer(pivot="SinceLast",
                                       track_nulls=track_nulls)
        elif g == "pivot_text":
            stage = OneHotVectorizer(top_k=top_k, min_support=min_support,
                                     track_nulls=track_nulls)
        elif g == "smart_text":
            stage = SmartTextVectorizer(
                max_cardinality=max_cardinality, top_k=top_k,
                min_support=min_support, num_hash_features=num_hash_features,
                track_nulls=track_nulls)
        elif g == "multi_pick_list":
            stage = MultiPickListVectorizer(top_k=top_k,
                                            min_support=min_support,
                                            track_nulls=track_nulls)
        elif g == "text_list":
            stage = TextHashingVectorizer(num_features=num_hash_features,
                                          track_nulls=track_nulls)
        else:
            stage = GeolocationVectorizer(track_nulls=track_nulls)
        stage.set_input(*feats)
        vectors.append(stage.get_output())
    if len(vectors) == 1:
        return vectors[0]
    combiner = VectorsCombiner()
    combiner.set_input(*vectors)
    return combiner.get_output()


def _group_of(t: Type[ft.FeatureType]) -> str:
    if issubclass(t, ft.OPMap):
        return "map"
    if issubclass(t, ft.OPVector):
        return "vector"
    if issubclass(t, ft.Geolocation):
        return "geolocation"
    if issubclass(t, ft.MultiPickList):
        return "multi_pick_list"
    if issubclass(t, ft.TextList):
        return "text_list"
    if issubclass(t, ft.DateList):
        return "date_list"
    if issubclass(t, ft.Binary):
        return "binary"
    if issubclass(t, (ft.Date, ft.DateTime)):
        return "date"
    if issubclass(t, ft.Integral):
        return "integral"
    if issubclass(t, ft.Real):
        return "real"
    if issubclass(t, _PIVOT_TEXT):
        return "pivot_text"
    if issubclass(t, ft.Text):
        return "smart_text"
    raise TypeError(f"cannot transmogrify feature type {t.type_name()}")
