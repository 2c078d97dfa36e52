"""Derived-type detector stages (counterpart of
``transmogrifai_tpu.ops.detectors``; its tables and rules copied).

 * ``MimeTypeDetector`` / ``MimeTypeMapDetector`` — a magic-byte table
   over the decoded base64 prefix (at most ``max_bytes_to_parse`` bytes)
 * ``LangDetector`` — script ranges and stop-word profiles -> RealMap of
   {language code -> confidence}
 * ``ParsePhoneNumber``, ``ParsePhoneDefaultCountry``,
   ``IsValidPhoneNumber``, ``IsValidPhoneDefaultCountry``,
   ``IsValidPhoneMapDefaultCountry`` — digit-count validation per dialing
   region (``DEFAULT_COUNTRY_CODES``)
 * ``ValidEmailTransformer``, ``EmailToPickListMapTransformer``,
   ``UrlMapToPickListMapTransformer`` and ``FilterMap``
 * ``HumanNameDetector`` / ``HumanNameDetectorModel`` and
   ``NameEntityRecognizer`` — a first-name dictionary and capitalisation

All of it is host string work, once per raw column; the outputs are
small categorical values that the vectorizers then move to the device.
"""
from __future__ import annotations

import base64
import binascii
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..stages.base import (BinaryTransformer, UnaryEstimator, UnaryModel,
                           UnaryTransformer)
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import (
    Binary, BinaryMap, MultiPickListMap, NameStats, OPMap, Phone,
    PickListMap, RealMap, Text,
)

__all__ = [
    "MimeTypeDetector", "MimeTypeMapDetector",
    "LangDetector",
    "ParsePhoneNumber", "ParsePhoneDefaultCountry",
    "IsValidPhoneNumber", "IsValidPhoneDefaultCountry",
    "IsValidPhoneMapDefaultCountry",
    "ValidEmailTransformer",
    "HumanNameDetector", "HumanNameDetectorModel", "NameEntityRecognizer",
    "EmailToPickListMapTransformer", "UrlMapToPickListMapTransformer",
    "FilterMap",
    "DEFAULT_COUNTRY_CODES",
]


# ---------------------------------------------------------------------------
# MIME type detection (magic bytes)
# ---------------------------------------------------------------------------

#: (prefix bytes, mime) — ordered, first match wins (longest prefixes first)
_MAGIC: List[Tuple[bytes, str]] = [
    (b"%PDF-", "application/pdf"),
    (b"\x89PNG\r\n\x1a\n", "image/png"),
    (b"\xff\xd8\xff", "image/jpeg"),
    (b"GIF87a", "image/gif"),
    (b"GIF89a", "image/gif"),
    (b"BM", "image/bmp"),
    (b"II*\x00", "image/tiff"),
    (b"MM\x00*", "image/tiff"),
    (b"PK\x03\x04", "application/zip"),
    (b"\x1f\x8b", "application/gzip"),
    (b"BZh", "application/x-bzip2"),
    (b"\x7fELF", "application/x-executable"),
    (b"MZ", "application/x-msdownload"),
    (b"OggS", "audio/ogg"),
    (b"ID3", "audio/mpeg"),
    (b"fLaC", "audio/flac"),
    (b"RIFF", "audio/x-wav"),
    (b"\x00\x00\x00\x18ftyp", "video/mp4"),
    (b"\x00\x00\x00\x20ftyp", "video/mp4"),
    (b"{\\rtf", "application/rtf"),
]

_XML_RE = re.compile(rb"^\s*<\?xml")
_HTML_RE = re.compile(rb"^\s*<(!doctype\s+html|html)", re.IGNORECASE)
_JSON_RE = re.compile(rb"^\s*[\[{]")


def _sniff_mime(raw: bytes) -> str:
    for prefix, mime in _MAGIC:
        if raw.startswith(prefix):
            return mime
    if _XML_RE.match(raw):
        return "application/xml"
    if _HTML_RE.match(raw):
        return "text/html"
    if _JSON_RE.match(raw):
        return "application/json"
    try:
        raw.decode("utf-8")
        return "text/plain"
    except UnicodeDecodeError:
        return "application/octet-stream"


_B64_WS_RE = re.compile(r"\s+")
_B64_ALPHABET_RE = re.compile(r"[A-Za-z0-9+/]+={0,2}")


def _detect_mime(v: Optional[str], type_hint: str,
                 max_bytes_to_parse: int) -> Optional[str]:
    if v is None or v == "":
        return None
    if type_hint:
        return type_hint
    # decode just enough base64 chars to cover max_bytes_to_parse bytes;
    # MIME line wrapping must be stripped first or padding misaligns
    n_chars = ((max_bytes_to_parse + 2) // 3) * 4
    chunk = _B64_WS_RE.sub("", v[: n_chars * 2])[:n_chars]
    chunk = chunk[: len(chunk) - len(chunk) % 4]
    if not chunk or not _B64_ALPHABET_RE.fullmatch(chunk):
        return None
    try:
        raw = base64.b64decode(chunk, validate=True)
    except (binascii.Error, ValueError):
        return None
    if not raw:
        return None
    return _sniff_mime(raw[:max_bytes_to_parse])


class MimeTypeDetector(UnaryTransformer):
    """Base64 -> Text mime type (MimeTypeDetector.scala:49-58).

    ``type_hint`` short-circuits detection (typeHint param, :92);
    ``max_bytes_to_parse`` bounds the decoded prefix inspected (default 1024).
    """

    def __init__(self, type_hint: str = "", max_bytes_to_parse: int = 1024,
                 uid: Optional[str] = None):
        super().__init__(operation_name="mimeDetect", output_type=Text, uid=uid)
        self.type_hint = type_hint
        self.max_bytes_to_parse = max_bytes_to_parse

    def detect(self, v: Optional[str]) -> Optional[str]:
        return _detect_mime(v, self.type_hint, self.max_bytes_to_parse)

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        out = np.empty(len(col), dtype=object)
        for i, v in enumerate(col.values):
            out[i] = self.detect(v)
        return FeatureColumn(Text, out)


class MimeTypeMapDetector(UnaryTransformer):
    """Base64Map -> PickListMap of mime types (MimeTypeDetector.scala:61-77)."""

    def __init__(self, type_hint: str = "", max_bytes_to_parse: int = 1024,
                 uid: Optional[str] = None):
        super().__init__(operation_name="mimeMapDetect",
                         output_type=PickListMap, uid=uid)
        self.type_hint = type_hint
        self.max_bytes_to_parse = max_bytes_to_parse

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        out = np.empty(len(col), dtype=object)
        for i, m in enumerate(col.values):
            res = {}
            for k, v in (m or {}).items():
                mime = _detect_mime(v, self.type_hint, self.max_bytes_to_parse)
                if mime is not None:
                    res[k] = mime
            out[i] = res
        return FeatureColumn(PickListMap, out)


# ---------------------------------------------------------------------------
# Language detection (script + stop-word profiles)
# ---------------------------------------------------------------------------

_LANG_PROFILES: Dict[str, frozenset] = {
    "en": frozenset("the and of to in is you that it he was for on are with"
                    " as his they be at one have this from had not but what"
                    .split()),
    "fr": frozenset("le la les de des et un une du en est que qui dans pour"
                    " pas sur ne se ce il elle nous vous au aux son ses mais"
                    .split()),
    "de": frozenset("der die das und ist von zu den dem ein eine nicht mit"
                    " sich auf für als auch es an werden aus er hat dass sie"
                    .split()),
    "es": frozenset("el la los las de y un una del en es que no se por con"
                    " para su al lo como más pero sus le ya o este sí porque"
                    .split()),
    "it": frozenset("il la le di e un una del in è che non si per con su"
                    " come più ma anche dei delle nel alla questo sono della"
                    .split()),
    "pt": frozenset("o a os as de e um uma do da em é que não se por com"
                    " para seu ao como mais mas os foi são dos uma pelo nos"
                    .split()),
    "nl": frozenset("de het een en van in is dat op te zijn met die voor"
                    " niet aan er om ook als maar dan zij bij uit nog naar"
                    .split()),
}

#: word -> the languages whose profile holds it (one lookup a word)
_PROFILE_LANGS: Dict[str, Tuple[str, ...]] = {}
for _lang, _profile in _LANG_PROFILES.items():
    for _w in _profile:
        _PROFILE_LANGS[_w] = _PROFILE_LANGS.get(_w, ()) + (_lang,)

_SCRIPT_RANGES: List[Tuple[int, int, str]] = [
    (0x0400, 0x04FF, "ru"),   # Cyrillic
    (0x0590, 0x05FF, "he"),   # Hebrew
    (0x0600, 0x06FF, "ar"),   # Arabic
    (0x0900, 0x097F, "hi"),   # Devanagari
    (0x3040, 0x30FF, "ja"),   # Hiragana/Katakana
    (0xAC00, 0xD7AF, "ko"),   # Hangul
    (0x4E00, 0x9FFF, "zh"),   # CJK ideographs
    (0x0E00, 0x0E7F, "th"),   # Thai
    (0x0370, 0x03FF, "el"),   # Greek
]

_WORD_RE = re.compile(r"[\w']+", re.UNICODE)


class LangDetector(UnaryTransformer):
    """Text -> RealMap {ISO language -> confidence} (LangDetector.scala:46-60).

    Non-Latin scripts are detected by unicode block; Latin-script languages
    by stop-word profile hit rate, normalised to sum to 1 over languages with
    any hits.
    """

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="langDetect", output_type=RealMap,
                         uid=uid)

    def detect(self, v: Optional[str]) -> Dict[str, float]:
        if not v:
            return {}
        script_hits: Dict[str, int] = {}
        n_alpha = 0
        if v.isascii():
            # the loop below, for ASCII text: letters only, no script
            n_alpha = sum(map(str.isalpha, v))
        else:
            for ch in v:
                o = ord(ch)
                if o < 0x250:
                    if ch.isalpha():
                        n_alpha += 1
                    continue
                for lo, hi, lang in _SCRIPT_RANGES:
                    if lo <= o <= hi:
                        script_hits[lang] = script_hits.get(lang, 0) + 1
                        break
        if script_hits:
            # Japanese text mixes kana + CJK ideographs: kana presence wins
            if "ja" in script_hits and "zh" in script_hits:
                script_hits["ja"] += script_hits.pop("zh")
        n_script = sum(script_hits.values())
        # Latin-script languages scored by stop-word profile hit rate
        latin_scores: Dict[str, float] = {}
        if n_alpha:
            words = (_WORD_RE.findall(v.lower()) if v.isascii() else
                     [w.lower() for w in _WORD_RE.findall(v)])
            counts: Dict[str, int] = {}
            for w in words:
                for lang in _PROFILE_LANGS.get(w, ()):
                    counts[lang] = counts.get(lang, 0) + 1
            for lang in _LANG_PROFILES:         # the profiles' order
                if lang in counts:
                    latin_scores[lang] = counts[lang] / len(words)
        # blend the two families by their share of alphabetic characters so a
        # stray non-Latin char cannot override a mostly-Latin text
        total_chars = n_script + n_alpha
        lt = sum(latin_scores.values())
        out: Dict[str, float] = {}
        if total_chars == 0:
            return {}
        if n_script:
            w_script = n_script / total_chars if lt else 1.0
            for k, c in script_hits.items():
                out[k] = w_script * c / n_script
        if lt:
            w_latin = 1.0 - sum(out.values()) if out else 1.0
            for k, sc in latin_scores.items():
                out[k] = out.get(k, 0.0) + w_latin * sc / lt
        return out

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        out = np.empty(len(col), dtype=object)
        for i, v in enumerate(col.values):
            out[i] = self.detect(v)
        return FeatureColumn(RealMap, out)


# ---------------------------------------------------------------------------
# Phone parsing / validation
# ---------------------------------------------------------------------------

#: country name -> dialing code (PhoneNumberParser.scala:325 DefaultCountryCodes)
DEFAULT_COUNTRY_CODES: Dict[str, str] = {
    "UNITED STATES": "1", "CANADA": "1", "UNITED KINGDOM": "44",
    "FRANCE": "33", "GERMANY": "49", "SPAIN": "34", "ITALY": "39",
    "AUSTRALIA": "61", "JAPAN": "81", "CHINA": "86", "INDIA": "91",
    "BRAZIL": "55", "MEXICO": "52", "NETHERLANDS": "31", "SWEDEN": "46",
    "SWITZERLAND": "41", "IRELAND": "353", "SINGAPORE": "65",
    "NEW ZEALAND": "64", "SOUTH AFRICA": "27", "ISRAEL": "972",
    "KOREA": "82", "RUSSIA": "7", "POLAND": "48", "PORTUGAL": "351",
}

#: region -> required national-number digit counts (libphonenumber-lite)
_REGION_DIGITS: Dict[str, Tuple[int, int]] = {
    "1": (10, 10), "44": (9, 10), "33": (9, 9), "49": (7, 11),
    "34": (9, 9), "39": (8, 11), "61": (9, 9), "81": (9, 10),
    "86": (10, 11), "91": (10, 10), "55": (10, 11), "52": (10, 10),
}

_CLEAN_PHONE_RE = re.compile(r"[^+\d]")


def _clean_number(pn: str) -> str:
    """PhoneNumberParser.cleanNumber (:267): strip all but digits and '+'."""
    return _CLEAN_PHONE_RE.sub("", pn.strip())


def _region_code(region: str) -> str:
    """Accept a dialing code, a country name, or an ISO-ish name."""
    r = region.strip().upper()
    if r.isdigit():
        return r
    return DEFAULT_COUNTRY_CODES.get(r, "1")


def _parse_phone(pn: Optional[str], region: str,
                 strict: bool) -> Optional[str]:
    """Return E.164 string or None (PhoneNumberParser.parse :314)."""
    if not pn:
        return None
    cleaned = _clean_number(pn)
    if not cleaned:
        return None
    if cleaned.startswith("+"):
        digits = cleaned[1:]
        if not (7 <= len(digits) <= 15) or not digits.isdigit():
            return None
        return "+" + digits
    code = _region_code(region)
    digits = cleaned.lstrip("0") if not strict else cleaned
    if not digits.isdigit():
        return None
    lo, hi = _REGION_DIGITS.get(code, (7, 12))
    # tolerate a leading trunk/country prefix when not strict
    if digits.startswith(code) and len(digits) - len(code) >= lo and not strict:
        digits = digits[len(code):]
    if not (lo <= len(digits) <= hi):
        return None
    if code == "1":
        # NANP: area code and exchange cannot start with 0/1
        if digits[0] in "01" or digits[3] in "01":
            return None
    return f"+{code}{digits}"


class ParsePhoneNumber(BinaryTransformer):
    """(Phone, Text region) -> E.164 Phone (PhoneNumberParser.scala:143-167)."""

    def __init__(self, strict_validation: bool = False,
                 uid: Optional[str] = None):
        super().__init__(operation_name="parsePhone", output_type=Phone,
                         uid=uid)
        self.strict_validation = strict_validation

    def transform_columns(self, phone: FeatureColumn,
                          region: FeatureColumn) -> FeatureColumn:
        out = np.empty(len(phone), dtype=object)
        for i, (p, r) in enumerate(zip(phone.values, region.values)):
            out[i] = _parse_phone(p, r or "1", self.strict_validation)
        return FeatureColumn(Phone, out)


class ParsePhoneDefaultCountry(UnaryTransformer):
    """Phone -> E.164 Phone with one default region
    (PhoneNumberParser.scala:170-196)."""

    def __init__(self, default_region: str = "1", strict_validation: bool = False,
                 uid: Optional[str] = None):
        super().__init__(operation_name="parsePhoneDefault", output_type=Phone,
                         uid=uid)
        self.default_region = default_region
        self.strict_validation = strict_validation

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        out = np.empty(len(col), dtype=object)
        for i, p in enumerate(col.values):
            out[i] = _parse_phone(p, self.default_region,
                                  self.strict_validation)
        return FeatureColumn(Phone, out)


class IsValidPhoneNumber(BinaryTransformer):
    """(Phone, Text region) -> Binary (PhoneNumberParser.scala:198-222)."""

    def __init__(self, strict_validation: bool = False,
                 uid: Optional[str] = None):
        super().__init__(operation_name="validPhone", output_type=Binary,
                         uid=uid)
        self.strict_validation = strict_validation

    def transform_columns(self, phone: FeatureColumn,
                          region: FeatureColumn) -> FeatureColumn:
        out = [
            None if p is None
            else _parse_phone(p, r or "1", self.strict_validation) is not None
            for p, r in zip(phone.values, region.values)
        ]
        return FeatureColumn.from_values(Binary, out)


class IsValidPhoneDefaultCountry(UnaryTransformer):
    """Phone -> Binary with one default region
    (PhoneNumberParser.scala:225-239)."""

    def __init__(self, default_region: str = "1", strict_validation: bool = False,
                 uid: Optional[str] = None):
        super().__init__(operation_name="validPhoneDefault", output_type=Binary,
                         uid=uid)
        self.default_region = default_region
        self.strict_validation = strict_validation

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        out = [
            None if p is None
            else _parse_phone(p, self.default_region,
                              self.strict_validation) is not None
            for p in col.values
        ]
        return FeatureColumn.from_values(Binary, out)


class IsValidPhoneMapDefaultCountry(UnaryTransformer):
    """PhoneMap -> BinaryMap (PhoneNumberParser.scala:241-257)."""

    def __init__(self, default_region: str = "1", strict_validation: bool = False,
                 uid: Optional[str] = None):
        super().__init__(operation_name="validPhoneMapDefault",
                         output_type=BinaryMap, uid=uid)
        self.default_region = default_region
        self.strict_validation = strict_validation

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        out = np.empty(len(col), dtype=object)
        for i, m in enumerate(col.values):
            out[i] = {
                k: _parse_phone(v, self.default_region,
                                self.strict_validation) is not None
                for k, v in (m or {}).items() if v is not None
            }
        return FeatureColumn(BinaryMap, out)


# ---------------------------------------------------------------------------
# Email validation / domain extraction
# ---------------------------------------------------------------------------

_EMAIL_RE = re.compile(
    r"^[A-Za-z0-9.!#$%&'*+/=?^_`{|}~-]+@"
    r"[A-Za-z0-9](?:[A-Za-z0-9-]{0,61}[A-Za-z0-9])?"
    r"(?:\.[A-Za-z0-9](?:[A-Za-z0-9-]{0,61}[A-Za-z0-9])?)+$")


class ValidEmailTransformer(UnaryTransformer):
    """Email -> Binary validity (ValidEmailTransformer.scala:41-47)."""

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="validEmail", output_type=Binary,
                         uid=uid)

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        out = [None if v is None else bool(_EMAIL_RE.match(v))
               for v in col.values]
        return FeatureColumn.from_values(Binary, out)


def _email_domain(v: Optional[str]) -> Optional[str]:
    if v is None or "@" not in v:
        return None
    return v.rsplit("@", 1)[1].lower() or None


_URL_HOST_RE = re.compile(
    r"^(?:[a-z][a-z0-9+.-]*:)?//(?:[^/?#@]*@)?([^/?#:@]+)", re.IGNORECASE)


def _url_host(v: Optional[str]) -> Optional[str]:
    if not v:
        return None
    has_scheme = "://" in v or v.startswith("//")
    m = _URL_HOST_RE.match(v if has_scheme else "//" + v)
    return m.group(1).lower() if m else None


class EmailToPickListMapTransformer(UnaryTransformer):
    """EmailMap -> PickListMap of email domains
    (EmailToPickListMapTransformer.scala)."""

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="emailToPickListMap",
                         output_type=PickListMap, uid=uid)

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        out = np.empty(len(col), dtype=object)
        for i, m in enumerate(col.values):
            res = {}
            for k, v in (m or {}).items():
                d = _email_domain(v)
                if d is not None:
                    res[k] = d
            out[i] = res
        return FeatureColumn(PickListMap, out)


class UrlMapToPickListMapTransformer(UnaryTransformer):
    """URLMap -> PickListMap of hostnames
    (UrlMapToPickListMapTransformer.scala)."""

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="urlToPickListMap",
                         output_type=PickListMap, uid=uid)

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        out = np.empty(len(col), dtype=object)
        for i, m in enumerate(col.values):
            res = {}
            for k, v in (m or {}).items():
                h = _url_host(v)
                if h is not None:
                    res[k] = h
            out[i] = res
        return FeatureColumn(PickListMap, out)


class FilterMap(UnaryTransformer):
    """OPMap -> OPMap filtered by key allow/block lists and value block list
    (RichMapFeature filter ops / FilterMap in the reference DSL)."""

    input_arity = (1, 1)

    def __init__(self, allow_keys: Optional[Sequence[str]] = None,
                 block_keys: Sequence[str] = (),
                 block_values: Sequence[str] = (),
                 uid: Optional[str] = None):
        super().__init__(operation_name="filterMap", output_type=OPMap, uid=uid)
        self.allow_keys = list(allow_keys) if allow_keys else None
        self.block_keys = list(block_keys)
        self.block_values = list(block_values)

    def on_set_input(self) -> None:
        # output keeps the concrete input map type; this hook runs before the
        # base class constructs the output feature from self.output_type
        self.output_type = self.input_features[0].ftype

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        allow = set(self.allow_keys) if self.allow_keys else None
        block = set(self.block_keys)
        bvals = set(self.block_values)
        out = np.empty(len(col), dtype=object)
        for i, m in enumerate(col.values):
            out[i] = {
                k: v for k, v in (m or {}).items()
                if (allow is None or k in allow) and k not in block
                and (not isinstance(v, str) or v not in bvals)
            }
        return FeatureColumn(self.output_type, out)


# ---------------------------------------------------------------------------
# Human name detection
# ---------------------------------------------------------------------------

#: small built-in first-name dictionary with gender tags (OpenNLP replacement)
_FIRST_NAMES: Dict[str, str] = {}
for _male in ("james john robert michael william david richard joseph thomas"
              " charles christopher daniel matthew anthony mark donald steven"
              " paul andrew joshua kenneth kevin brian george edward ronald"
              " timothy jason jeffrey ryan jacob gary nicholas eric jonathan"
              " stephen larry justin scott brandon benjamin samuel frank"
              " gregory raymond alexander patrick jack dennis jerry tyler"
              " aaron jose adam henry nathan douglas zachary peter kyle"
              " walter ethan jeremy harold keith christian roger noah alan"
              " juan carlos luis miguel pedro diego pierre jean luca marco"
              " hans klaus yuki hiroshi wei chen raj arjun").split():
    _FIRST_NAMES[_male] = "Male"
for _female in ("mary patricia jennifer linda elizabeth barbara susan jessica"
                " sarah karen nancy lisa margaret betty sandra ashley dorothy"
                " kimberly emily donna michelle carol amanda melissa deborah"
                " stephanie rebecca laura sharon cynthia kathleen amy shirley"
                " angela helen anna brenda pamela nicole ruth katherine"
                " samantha christine emma catherine debra virginia rachel"
                " carolyn janet maria heather diane julie joyce victoria"
                " olivia sophia isabella mia charlotte amelia evelyn abigail"
                " ava grace chloe camila penelope riley aria lily nora zoe"
                " marie sofia ana lucia elena ingrid yuna mei priya").split():
    _FIRST_NAMES[_female] = "Female"

_NAME_TOKEN_RE = re.compile(r"[A-Za-z][A-Za-z'\-]*")


def _name_stats(v: Optional[str]) -> Dict[str, str]:
    """Per-value NameStats map (HumanNameDetectorModel.transformFn :98-114)."""
    if not v:
        return {}
    tokens = _NAME_TOKEN_RE.findall(v)
    if not 1 <= len(tokens) <= 4:
        return {"OriginalValue": v, "IsName": "false"}
    first = tokens[0].lower()
    gender = _FIRST_NAMES.get(first)
    dict_hit = gender is not None
    # capitalised tokens that aren't sentence-like
    looks = all(t[0].isupper() for t in tokens if len(t) > 1)
    is_name = dict_hit or (looks and len(tokens) in (2, 3))
    stats = {"OriginalValue": v, "IsName": str(is_name).lower()}
    if is_name:
        stats["FirstName"] = tokens[0]
        if len(tokens) > 1:
            stats["LastName"] = tokens[-1]
        stats["Gender"] = gender if gender else "GenderNotInferred"
    return stats


class HumanNameDetector(UnaryEstimator):
    """Text -> NameStats estimator (HumanNameDetector.scala:56-84).

    Fit decides whether the column as a whole is a name column: the fraction
    of non-null values recognised as names must reach ``threshold``
    (defaultThreshold in the reference).  The model then emits per-row
    ``NameStats`` maps (empty when the column is not a name column).
    """

    def __init__(self, threshold: float = 0.5, uid: Optional[str] = None):
        super().__init__(operation_name="humanNameDetect",
                         output_type=NameStats, uid=uid)
        self.threshold = threshold

    def fit_columns(self, data: ColumnarDataset, col: FeatureColumn):
        n, hits = 0, 0
        for v in col.values:
            if v is None or v == "":
                continue
            n += 1
            if _name_stats(v).get("IsName") == "true":
                hits += 1
        treat_as_name = n > 0 and hits / n >= self.threshold
        self.metadata["name_fraction"] = hits / n if n else 0.0
        return HumanNameDetectorModel(treat_as_name=treat_as_name)


class HumanNameDetectorModel(UnaryModel):
    def __init__(self, treat_as_name: bool = False, uid: Optional[str] = None):
        super().__init__(operation_name="humanNameDetect",
                         output_type=NameStats, uid=uid)
        self.treat_as_name = treat_as_name

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        out = np.empty(len(col), dtype=object)
        for i, v in enumerate(col.values):
            out[i] = _name_stats(v) if self.treat_as_name else {}
        return FeatureColumn(NameStats, out)


class NameEntityRecognizer(UnaryTransformer):
    """Text -> MultiPickListMap token->entity-tags
    (NameEntityRecognizer.scala:56-90).

    The OpenNLP NER chain becomes a dictionary + capitalisation tagger; each
    recognised token maps to the set of entity tags found for it (the
    reference emits {token -> Set(entity)} the same way).
    """

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="nameEntityRec",
                         output_type=MultiPickListMap, uid=uid)

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        out = np.empty(len(col), dtype=object)
        for i, v in enumerate(col.values):
            tags: Dict[str, set] = {}
            if v:
                tokens = _NAME_TOKEN_RE.findall(v)
                for j, t in enumerate(tokens):
                    low = t.lower()
                    if low in _FIRST_NAMES:
                        tags.setdefault(t, set()).add("Person")
                        # a capitalised follower of a known first name is
                        # treated as the surname of the same Person entity
                        if (j + 1 < len(tokens)
                                and tokens[j + 1][0].isupper()):
                            tags.setdefault(tokens[j + 1], set()).add("Person")
            out[i] = {k: frozenset(s) for k, s in tags.items()}
        return FeatureColumn(MultiPickListMap, out)
