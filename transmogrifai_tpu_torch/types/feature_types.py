"""Semantic feature type system.

Columnar re-design of TransmogrifAI's sealed ``FeatureType`` hierarchy
(reference: features/src/main/scala/com/salesforce/op/features/types/FeatureType.scala:44,
Numerics.scala:40-147, Text.scala:48-301, Lists.scala:40-76, Sets.scala:38,
Maps.scala:40-394, OPVector.scala:41, Geolocation.scala:47).

Design shift vs the reference: in the Scala/Spark original every *row value* is
boxed into a ``FeatureType`` instance wrapping an ``Option`` so that nullability
lives in the type.  On the device the unit of work is a *column batch*, so here the
types are lightweight class tags describing the ML semantics of a whole column,
and nullability is carried by an explicit mask array in the columnar storage
(see ``transmogrifai_tpu_torch.types.columns``).  The class hierarchy, trait mix-ins
(``NonNullable``, ``Categorical``, ``SingleResponse`` ...) and the full set of
~35 concrete types are preserved so that user-facing semantics (which
vectorizer a column gets, which types may be responses, etc.) match the
reference one-to-one.
"""
from __future__ import annotations

from typing import Dict, List, Type

__all__ = [
    "FeatureType",
    "NonNullable",
    "SingleResponse",
    "MultiResponse",
    "Categorical",
    "Location",
    # numerics
    "OPNumeric", "Real", "RealNN", "Binary", "Integral", "Percent", "Currency",
    "Date", "DateTime",
    # text
    "Text", "Email", "Base64", "Phone", "ID", "URL", "TextArea", "PickList",
    "ComboBox", "Country", "State", "PostalCode", "City", "Street",
    # collections
    "OPCollection", "OPList", "TextList", "DateList", "DateTimeList",
    "OPSet", "MultiPickList", "OPVector", "Geolocation",
    # maps
    "OPMap", "TextMap", "EmailMap", "Base64Map", "PhoneMap", "IDMap", "URLMap",
    "TextAreaMap", "PickListMap", "ComboBoxMap", "CountryMap", "StateMap",
    "PostalCodeMap", "CityMap", "StreetMap", "NameStats", "RealMap",
    "IntegralMap", "BinaryMap", "CurrencyMap", "PercentMap", "DateMap",
    "DateTimeMap", "MultiPickListMap", "GeolocationMap", "Prediction",
    # registry helpers
    "type_by_name", "all_feature_types", "is_subtype",
]


class FeatureType:
    """Root of the semantic type hierarchy.

    Subclasses are used as *tags* (never instantiated to hold data); columnar
    data for a feature of type ``T`` lives in a ``FeatureColumn`` whose
    ``ftype`` attribute is ``T``.
    """

    #: storage kind understood by the columnar runtime:
    #: one of "real", "integral", "binary", "date", "text", "text_list",
    #: "date_list", "multi_pick_list", "vector", "geolocation", "map"
    storage: str = "real"

    @classmethod
    def type_name(cls) -> str:
        return cls.__name__

    @classmethod
    def is_nullable(cls) -> bool:
        return not issubclass(cls, NonNullable)

    @classmethod
    def default_value(cls):
        """Python-side empty value for this type (parity with FeatureType.empty)."""
        if cls.storage in ("real", "integral", "binary", "date"):
            return None
        if cls.storage == "text":
            return None
        if cls.storage in ("text_list", "date_list", "geolocation"):
            return []
        if cls.storage == "multi_pick_list":
            return set()
        if cls.storage == "vector":
            return []
        if cls.storage == "map":
            return {}
        return None


# ---------------------------------------------------------------------------
# Trait mix-ins (reference FeatureType.scala:122-158)
# ---------------------------------------------------------------------------

class NonNullable:
    """Marker: values of this type can never be empty."""


class SingleResponse:
    """Marker: type usable as a single response (label)."""


class MultiResponse:
    """Marker: type usable as a multi response."""


class Categorical:
    """Marker: type is categorical (pivot/one-hot by default)."""


class Location:
    """Marker: type carries geographic location semantics."""


# ---------------------------------------------------------------------------
# Numerics (reference features/types/Numerics.scala:40-147)
# ---------------------------------------------------------------------------

class OPNumeric(FeatureType):
    """Base for all numeric types."""
    storage = "real"


class Real(OPNumeric):
    storage = "real"


class RealNN(Real, NonNullable, SingleResponse):
    """Non-nullable real — the required label/response type for regression."""
    storage = "real"


class Binary(OPNumeric, SingleResponse, Categorical):
    storage = "binary"


class Integral(OPNumeric):
    storage = "integral"


class Percent(Real):
    storage = "real"


class Currency(Real):
    storage = "real"


class Date(Integral):
    storage = "date"


class DateTime(Date):
    storage = "date"


# ---------------------------------------------------------------------------
# Text (reference features/types/Text.scala:48-301)
# ---------------------------------------------------------------------------

class Text(FeatureType):
    storage = "text"


class Email(Text):
    pass


class Base64(Text):
    pass


class Phone(Text):
    pass


class ID(Text):
    pass


class URL(Text):
    pass


class TextArea(Text):
    pass


class PickList(Text, SingleResponse, Categorical):
    pass


class ComboBox(Text):
    pass


class Country(Text, Location):
    pass


class State(Text, Location):
    pass


class PostalCode(Text, Location):
    pass


class City(Text, Location):
    pass


class Street(Text, Location):
    pass


# ---------------------------------------------------------------------------
# Collections (reference Lists.scala, Sets.scala, OPVector.scala, Geolocation.scala)
# ---------------------------------------------------------------------------

class OPCollection(FeatureType):
    storage = "text_list"


class OPList(OPCollection):
    storage = "text_list"


class TextList(OPList):
    storage = "text_list"


class DateList(OPList):
    storage = "date_list"


class DateTimeList(DateList):
    storage = "date_list"


class OPSet(OPCollection, MultiResponse):
    storage = "multi_pick_list"


class MultiPickList(OPSet, Categorical):
    storage = "multi_pick_list"


class OPVector(OPCollection):
    """The assembled feature vector — a dense/sparse float row per example.

    Reference wraps Spark ml ``Vector`` (OPVector.scala:41); here columns of
    this type are (n, d) float arrays plus ``VectorMetadata`` provenance.
    """
    storage = "vector"


class Geolocation(OPList, Location):
    """(lat, lon, accuracy) triple (reference Geolocation.scala:47)."""
    storage = "geolocation"


# ---------------------------------------------------------------------------
# Maps (reference features/types/Maps.scala:40-394)
# ---------------------------------------------------------------------------

class OPMap(FeatureType):
    """Key -> value map; one key per raw column group."""
    storage = "map"
    #: semantic type of the map's values
    value_type: Type[FeatureType] = Text


class TextMap(OPMap):
    value_type = Text


class EmailMap(OPMap):
    value_type = Email


class Base64Map(OPMap):
    value_type = Base64


class PhoneMap(OPMap):
    value_type = Phone


class IDMap(OPMap):
    value_type = ID


class URLMap(OPMap):
    value_type = URL


class TextAreaMap(OPMap):
    value_type = TextArea


class PickListMap(OPMap, Categorical):
    value_type = PickList


class ComboBoxMap(OPMap):
    value_type = ComboBox


class CountryMap(OPMap, Location):
    value_type = Country


class StateMap(OPMap, Location):
    value_type = State


class PostalCodeMap(OPMap, Location):
    value_type = PostalCode


class CityMap(OPMap, Location):
    value_type = City


class StreetMap(OPMap, Location):
    value_type = Street


class NameStats(OPMap):
    """Name-detection statistics map (reference Maps.scala:326)."""
    value_type = Text


class RealMap(OPMap):
    value_type = Real


class IntegralMap(OPMap):
    value_type = Integral


class BinaryMap(OPMap, Categorical):
    value_type = Binary


class CurrencyMap(OPMap):
    value_type = Currency


class PercentMap(OPMap):
    value_type = Percent


class DateMap(OPMap):
    value_type = Date


class DateTimeMap(OPMap):
    value_type = DateTime


class MultiPickListMap(OPMap, Categorical):
    value_type = MultiPickList


class GeolocationMap(OPMap, Location):
    value_type = Geolocation


class Prediction(RealMap, NonNullable):
    """Model output map with reserved keys (reference Maps.scala:339-394).

    Keys: ``prediction``, ``probability_{i}``, ``rawPrediction_{i}``.
    """

    KEY_PREDICTION = "prediction"
    KEY_PROBABILITY = "probability_"
    KEY_RAW_PREDICTION = "rawPrediction_"

    @staticmethod
    def keys_for(n_classes: int) -> List[str]:
        keys = [Prediction.KEY_PREDICTION]
        keys += [f"{Prediction.KEY_RAW_PREDICTION}{i}" for i in range(n_classes)]
        keys += [f"{Prediction.KEY_PROBABILITY}{i}" for i in range(n_classes)]
        return keys


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def _collect_types() -> Dict[str, Type[FeatureType]]:
    out: Dict[str, Type[FeatureType]] = {}
    stack: List[Type[FeatureType]] = [FeatureType]
    while stack:
        t = stack.pop()
        out[t.__name__] = t
        stack.extend(t.__subclasses__())
    return out


_REGISTRY: Dict[str, Type[FeatureType]] = _collect_types()


def type_by_name(name: str) -> Type[FeatureType]:
    """Resolve a feature type by its class name (for (de)serialization)."""
    global _REGISTRY
    if name not in _REGISTRY:
        _REGISTRY = _collect_types()
    return _REGISTRY[name]


def all_feature_types() -> List[Type[FeatureType]]:
    return list(_collect_types().values())


def is_subtype(t: Type[FeatureType], of: type) -> bool:
    return isinstance(t, type) and issubclass(t, of)
